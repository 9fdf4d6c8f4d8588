"""Where the time goes inside the window-attention forwards (#1, #5), on one GPU.

    python3 scripts/torch_port_window_probe.py [--calls 10] [--root DIR]
    python3 scripts/torch_port_window_probe.py --stamps --root DIR [--shape W L]

By default: runs ``fused_attention_ln`` (#1) at the far_rip predict's shape
(800 windows x 16 tokens x 528 channels, 8 heads, the position table, no
bias), at the folded temporal sublayer's (640 x 20, causal; 1024 x 10) and
at the nar_mnist decoder's (640 x 16, the 8-head relative-position bias),
and ``fused_attention`` (#5) at the last, bf16, dropout 0, a few times, then
traces ``--calls`` more of each with torch.profiler and prints, per call,
the device time of every kernel they launch (the bf16 forward is four
passes: LayerNorm rows, q/k/v, the attention, the out projection) and the
host's time to enqueue a call (the median of 5 runs of 20 calls, untraced). Also
prints ptxas's register / spill report of each kernel of the two forward
libraries. ``--root`` imports the package of another checkout (e.g. the
parent, unpacked with git archive).

``--stamps`` reads a checkout whose bf16 forward is one kernel (the WMMA
``fused_window_attention_tc_kernel`` of ``csrc/fused_window_attention.cuh``
before the four-pass design): it copies that checkout's ``csrc/`` with a
clock64() stamp from thread 0 of every block at each phase boundary
(LayerNorm, q/k projections, v projection, attention, out projection),
builds the copy of #1 into build/kernels/probe/, runs it once at ``--shape``
(windows, tokens; default 800 16) and prints the mean and median SM cycles
per phase over the blocks. Each stamp costs a few cycles.

Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PHASES = ("LayerNorm", "q/k proj", "v proj", "attention", "out proj")
# source lines that open phases 2..5 of the one-kernel WMMA forward
MARKS = ("  // 2) q and k", "  bf16* vb = xqk;", "  // 3) attention", "  // 4) output")
C, HEADS = 528, 8


def instrumented_header(src: str) -> str:
    start = src.index("fused_window_attention_tc_kernel(")
    body = src.index("{", src.index("int mask_tokens) {", start)) + 1
    end = src.index("\ntemplate <bool LN>\nint launch_tc(")
    stamp = "  if (threadIdx.x == 0) g_stamp[blockIdx.x * 8 + {}] = clock64();\n".format
    kern = stamp(0) + src[body:end]
    for i, mark in enumerate(MARKS):
        if mark not in kern:
            raise RuntimeError(f"phase mark {mark!r} not found in the kernel")
        kern = kern.replace(mark, stamp(i + 1) + mark, 1)
    last = kern.rstrip().rfind("}")
    kern = kern[:last] + stamp(len(PHASES)) + kern[last:]
    src = src[:body] + kern + src[end:]
    return src.replace("namespace {", "__device__ long long g_stamp[8192 * 8];\n"
                       "namespace {", 1)


def operands(g, dev, windows, tokens, bias=None, two=False):
    bf = torch.bfloat16

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    w = [r(C, C, std=C ** -0.5).to(bf) for _ in range(4)]
    b = [r(C, std=0.02) for _ in range(4)]
    if two:
        return (r(windows, tokens, C).to(bf), r(windows, tokens, C).to(bf), w[0], b[0],
                w[1], b[1], w[2], b[2], w[3], b[3], bias)
    return (r(windows, tokens, C).to(bf), w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3],
            1 + r(C, std=0.1), r(C, std=0.1), None if bias is not None else r(tokens, C),
            bias)


def stamps(args, fw, _build) -> int:
    windows, tokens = args.shape
    out = _build.BUILD_DIR / "probe"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    header = out / "fused_window_attention.cuh"
    header.write_text(instrumented_header(header.read_text()))
    with (out / "fused_window_attention_ln.cu").open("a") as f:
        f.write('\nextern "C" int probe_read(long long* host, int n) {\n'
                "  return cudaMemcpyFromSymbol(host, g_stamp, n * sizeof(long long));\n}\n")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "libprobe.so"),
                    str(out / "fused_window_attention_ln.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out / "libprobe.so"))
    lib.vptr_error_string.argtypes = [ctypes.c_int]
    lib.vptr_error_string.restype = ctypes.c_char_p
    _build._LIBS["fused_window_attention_ln"] = lib   # the wrapper loads this copy

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    causal = torch.full((tokens, tokens), -1e30, device=dev).triu(1)[None]
    ops = operands(g, dev, windows, tokens)[:-1] + (causal if tokens != 16 else None,)
    for _ in range(3):
        fw.fused_attention_ln(*ops, num_heads=HEADS)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fw.fused_attention_ln(*ops, num_heads=HEADS)
    end.record()
    torch.cuda.synchronize()
    blocks = -(-windows // (48 // tokens))    # the whole windows of 48 rows a block
    buf = (ctypes.c_longlong * (blocks * 8))()
    if lib.probe_read(buf, blocks * 8) != 0:
        raise RuntimeError("reading the stamps failed")
    st = np.array(buf, dtype=np.float64).reshape(blocks, 8)[:, :len(PHASES) + 1]
    cycles = np.diff(st, axis=1)
    print(f"{windows}x{tokens}x{C}: kernel {start.elapsed_time(end):.4f} ms (stamped copy), "
          f"{blocks} blocks, {torch.cuda.get_device_name(0)}")
    for i, name in enumerate(PHASES):
        print(f"  {name:10s} mean {cycles[:, i].mean():9.0f} cycles, median "
              f"{np.median(cycles[:, i]):9.0f}, share {cycles[:, i].sum() / cycles.sum():.3f}")
    print(f"  block total mean {cycles.sum(axis=1).mean():.0f} cycles")
    return 0


def passes(args, fw, _build) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    causal = torch.full((20, 20), -1e30, device=dev).triu(1)[None]
    rpe = (torch.randn(HEADS, 16, 16, generator=g) * 0.5).to(dev)
    far = operands(g, dev, 800, 16)
    t20 = operands(g, dev, 640, 20)[:-1] + (causal,)
    t10 = operands(g, dev, 1024, 10)
    nar = operands(g, dev, 640, 16, bias=rpe)
    two = operands(g, dev, 640, 16, bias=rpe, two=True)
    calls = {
        "fused_attention_ln 800x16 (far_rip)": lambda: fw.fused_attention_ln(
            *far, num_heads=HEADS),
        "fused_attention_ln 640x20 causal (temporal)": lambda: fw.fused_attention_ln(
            *t20, num_heads=HEADS),
        "fused_attention_ln 1024x10 (NAR temporal)": lambda: fw.fused_attention_ln(
            *t10, num_heads=HEADS),
        "fused_attention_ln 640x16 8-head bias (NAR)": lambda: fw.fused_attention_ln(
            *nar, num_heads=HEADS),
        "fused_attention 640x16 8-head bias (NAR)": lambda: fw.fused_attention(
            *two, num_heads=HEADS),
    }
    print(torch.cuda.get_device_name(0))
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total / 1e3 / args.calls,
                        e.count // args.calls, e.key) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        host = []
        for _ in range(5):        # 80 launches at most: the queue does not fill
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            host.append((time.perf_counter() - t0) * 5e4)
        torch.cuda.synchronize()
        print(f"{name}: {sum(x[0] for x in rows):.4f} ms of device time per call, "
              f"host {np.median(host):.1f} us a call (median of 5 enqueues of 20)")
        for ms, n, key in rows:
            print(f"  {ms:8.4f} ms x{n} {key[:110]}")
    for lib in ("fused_window_attention_ln", "fused_window_attention"):
        entry = ""
        for line in _build.library_path(lib).with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:70]
            if "registers" in line or "spill" in line:
                print(f"  {lib} {entry}: {line.strip()}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--calls", type=int, default=10)
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--stamps", action="store_true",
                        help="the phases of a one-kernel WMMA forward by clock64 stamps")
    parser.add_argument("--shape", type=int, nargs=2, default=(800, 16),
                        metavar=("WINDOWS", "TOKENS"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_window_probe: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from vptr_tpu_torch.ops import _build
    from vptr_tpu_torch.ops import fused_window_attention as fw

    return (stamps if args.stamps else passes)(args, fw, _build)


if __name__ == "__main__":
    sys.exit(main())
