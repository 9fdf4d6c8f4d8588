"""Phase timing of the window kernel's tensor-core route, on one GPU.

    python3 scripts/torch_port_window_probe.py

Copies csrc/fused_window_attention_ln.cu with a clock64() stamp from thread
0 of every block at each phase boundary of the tensor-core kernel
(LayerNorm, q/k projections, v projection, attention, output projection),
builds the copy into build/kernels/probe/, runs it once at the far_rip
path's shape (800 windows x 16 tokens x 528, bf16, 8 heads) and prints the
mean and median SM cycles per phase over the blocks. The committed kernel
is not changed; each stamp costs a few cycles. Exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PHASES = ("LayerNorm", "q/k proj", "v proj", "attention", "out proj")
# source lines that open phases 2..5 of the tensor-core kernel
MARKS = ("  // 2) q and k", "  bf16* vb = xqk;", "  // 3) attention", "  // 4) output")
WINDOWS, TOKENS, C, HEADS = 800, 16, 528, 8


def instrumented_source(src: str) -> str:
    start = src.index("fused_window_attention_ln_tc_kernel(")
    body = src.index("{", src.index("float eps) {", start)) + 1
    end = src.index("\nint launch_tc(")
    stamp = ("  if (threadIdx.x == 0) g_stamp[blockIdx.x * 8 + {}] = clock64();\n"
             .format)
    kern = stamp(0) + src[body:end]
    for i, mark in enumerate(MARKS):
        if mark not in kern:
            raise RuntimeError(f"phase mark {mark!r} not found in the kernel")
        kern = kern.replace(mark, stamp(i + 1) + mark, 1)
    last = kern.rstrip().rfind("}")
    kern = kern[:last] + stamp(len(PHASES)) + kern[last:]
    src = src[:body] + kern + src[end:]
    src = src.replace("namespace {", "__device__ long long g_stamp[8192 * 8];\n"
                      "namespace {", 1)
    return src + ('\nextern "C" int probe_read(long long* host, int n) {\n'
                  "  return cudaMemcpyFromSymbol(host, g_stamp, n * sizeof(long long));\n}\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_port_window_probe: no GPU", file=sys.stderr)
        return 1
    from vptr_tpu_torch.ops import _build
    from vptr_tpu_torch.ops import fused_window_attention as fw

    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = instrumented_source((_build.CSRC / "fused_window_attention_ln.cu").read_text())
    (out / "probe.cu").write_text(src)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "libprobe.so"),
                    str(out / "probe.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "libprobe.so"))
    lib.vptr_error_string.argtypes = [ctypes.c_int]
    lib.vptr_error_string.restype = ctypes.c_char_p
    _build._LIBS["fused_window_attention_ln"] = lib   # the wrapper loads this copy

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    w = [(torch.randn(C, C, generator=g) * C ** -0.5).to(dev, bf) for _ in range(4)]
    b = [torch.zeros(C, device=dev) for _ in range(4)]
    args = (torch.randn(WINDOWS, TOKENS, C, generator=g).to(dev, bf), w[0], b[0], w[1],
            b[1], w[2], b[2], w[3], b[3], torch.ones(C, device=dev),
            torch.zeros(C, device=dev), torch.randn(TOKENS, C, generator=g).to(dev), None)
    if fw.kernel_route(TOKENS, C, bf) != "tensor cores":
        raise RuntimeError("the probe shape does not take the tensor-core route")
    for _ in range(3):
        fw.fused_attention_ln(*args, num_heads=HEADS)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fw.fused_attention_ln(*args, num_heads=HEADS)
    end.record()
    torch.cuda.synchronize()
    blocks = -(-WINDOWS // (48 // TOKENS))    # three 16-token windows per block
    buf = (ctypes.c_longlong * (blocks * 8))()
    if lib.probe_read(buf, blocks * 8) != 0:
        raise RuntimeError("reading the stamps failed")
    stamps = np.array(buf, dtype=np.float64).reshape(blocks, 8)[:, :len(PHASES) + 1]
    cycles = np.diff(stamps, axis=1)
    print(f"kernel {start.elapsed_time(end):.4f} ms (stamped copy), {blocks} blocks, "
          f"{torch.cuda.get_device_name(0)}")
    for i, name in enumerate(PHASES):
        print(f"  {name:10s} mean {cycles[:, i].mean():9.0f} cycles, median "
              f"{np.median(cycles[:, i]):9.0f}")
    print(f"  block total mean {cycles.sum(axis=1).mean():.0f} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
