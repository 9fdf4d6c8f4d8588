"""Where kernel #9's (fused_dw_chain forward) time goes, on one GPU.

    python3 scripts/torch_port_dw_probe.py [--root DIR] [--samples 200]
    python3 scripts/torch_port_dw_probe.py --variants [NAME ...]

Times #9 at N x 64 x 2112 bf16, dropout 0 (the far_rip predict's shape at
N = 200), on each route the checkout has (the per-sample kernel, a cluster
of 8 blocks a sample; and, where the checkout has it, the persistent
route of 16-block clusters), in turns (A B B A, the mean CUDA-event time
of 50 calls after 5 warm-ups), and prints each route's resident clusters.

Then builds a copy of the checkout's ``csrc/`` under build/dw_probe/ with
SM-clock stamps from thread 0 of every block, and runs each route once:
* the per-sample kernel (``dw_chain_kernel`` with ``chain_to_z2`` of
  ``csrc/dw_chain.cuh``, changed in the copy only): the x load and its sum,
  each of the four cluster exchanges (a __syncthreads, a cluster.sync and
  eight DSMEM reads: the wait for the block's slowest warp is in it), the
  two M2 passes, z1, the conv, the final pass with its store and the
  closing cluster.sync; mean cycles a block;
* the persistent kernel (the copy built with ``-DVPTR_DW_STAMPS``, the
  stamps the kernel carries): the prologue (the slices of the affines and
  taps, the barriers), then each step of a sample added up over the
  block's samples: the wait for the staged x, LN1's statistics, the wait
  for the previous sample's second exchange, that sample's final pass with
  its store, the wait for the first exchange, z1, the conv, LN2's
  statistics; mean cycles a block-sample;
and for both, from the global timer, the blocks' start offsets from the
first block's start, their lifetimes, and the share of the SMs' time
between the first start and the last end that no block held. ``--root``
reads another checkout (e.g. the parent, unpacked with git archive), whose
per-sample kernel is stamped the same way. Each stamp costs a few cycles.

``--variants`` instead times the persistent route as committed against
copies of the package's ``csrc/`` under build/dw_probe/ whose
``fused_dw_chain.cu`` is changed in one place (VARIANTS: one part of the
work left out, wrong values by design, whose difference from the committed
kernel is that part's time; or another design choice), all built first in
parallel, each read in turns with the committed kernel (committed,
variant, variant, committed) in one process.

Prints one JSON line. Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HW, C, SLOTS = 64, 2112, 16
PER_SAMPLE_PHASES = ("x load + sum", "exchange 1", "M2 pass", "exchange 2", "z1",
                     "conv + sum", "exchange 3", "M2 pass (z2)", "exchange 4",
                     "final pass + store", "closing cluster.sync")
PERSISTENT_PHASES = ("prologue", "wait for the staged x", "LN1 statistics",
                     "exchange 2 of the previous sample", "its final pass", "exchange 1",
                     "z1", "conv", "LN2 statistics", "closing cluster.sync")
PER_BLOCK = (0, 9)                # persistent stamps taken once a block, not a sample
_COLUMNS = ("      if (H == 8)\n"
            "        p_conv_column<8>(z1, z2, tp, j, (c - j * np) * 2, cw, W, H);\n"
            "      else\n"
            "        p_conv_column<0>(z1, z2, tp, j, (c - j * np) * 2, cw, W, H);\n")
_Z1 = "          z.v[e] = p_gelu(fmaf(x.v[e], rstd, shift) * sc.v[e] + bi.v[e]);"
_Y = "          y.v[e] = p_gelu(fmaf(z.v[e], rstd, shift) * sc.v[e] + bi.v[e]);"
_FINAL = "  auto final_pass = [&](int n, float mean, float rstd) {\n"
# variant -> [(text of csrc/fused_dw_chain.cu, replacement), ...]
VARIANTS = {
    "without the conv's whole columns": [(_COLUMNS, "")],
    "the conv without its 8-row form": [
        (_COLUMNS, "      p_conv_column<0>(z1, z2, tp, j, (c - j * np) * 2, cw, W, H);\n")],
    "without the final pass": [(_FINAL, _FINAL + "    if (N > 0) return;\n")],
    "without z1's GELU": [(_Z1, _Z1.replace("p_gelu", ""))],
    "without the final GELU": [(_Y, _Y.replace("p_gelu", ""))],
    "gelu_fast": [(_Z1, _Z1.replace("p_gelu", "vptr_gelu::gelu_fast")),
                  (_Y, _Y.replace("p_gelu", "vptr_gelu::gelu_fast"))],
    "exact GELU": [(_Z1, _Z1.replace("p_gelu", "vptr_gelu::gelu")),
                   (_Y, _Y.replace("p_gelu", "vptr_gelu::gelu"))],
    **{f"{w} warps": [("constexpr int kPWarps = 16;", f"constexpr int kPWarps = {w};"),
                      ("constexpr int kPMaxQ = 5;", f"constexpr int kPMaxQ = {q};")]
       for w, q in ((12, 6), (24, 3))},
}
STAMP = ("\n#define PSTAMP(k) if (threadIdx.x == 0) g_dw_pstamp[blockIdx.x * 16 + (k)] = "
         "clock64();\n#define PTIMER(k) if (threadIdx.x == 0) { long long t_; asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); g_dw_pstamp[blockIdx.x * 16 + (k)] "
         "= t_; }\n")


def instrument(csrc: Path) -> None:
    """Stamps into the copy's per-sample kernel (text edits; each mark must
    be found) and the probe's read-back entry point."""
    head = csrc / "dw_chain.cuh"
    src = head.read_text()
    src = src.replace("namespace {", "__device__ long long g_dw_pstamp[4096 * 16];" + STAMP
                      + "namespace {", 1)
    for slot, (before, after) in enumerate(((1, 2), (3, 4), (6, 7), (8, 9))):
        mark = f"  cluster_sum(v, red, {slot}, cluster);\n"
        if mark not in src:
            raise RuntimeError(f"mark {mark!r} not found in dw_chain.cuh")
        src = src.replace(mark, f"  PSTAMP({before})\n{mark}  PSTAMP({after})\n", 1)
    mark = "  __syncthreads();\n  v[0] = 0.f;\n"
    if mark not in src:
        raise RuntimeError("the z1 pass's end not found in dw_chain.cuh")
    head.write_text(src.replace(mark, "  __syncthreads();\n  PSTAMP(5)\n  v[0] = 0.f;\n", 1))
    body = csrc / "fused_dw_chain.cu"
    src = body.read_text()
    for mark, new in (
            ("  __shared__ Red red;\n", "  __shared__ Red red;\n  PSTAMP(0)\n  PTIMER(12)\n"),
            ("  cluster.sync();                      // the other blocks are done reading red\n",
             "  PSTAMP(10)\n  cluster.sync();\n  PSTAMP(11)\n  PTIMER(13)\n")):
        if mark not in src:
            raise RuntimeError(f"mark {mark!r} not found in fused_dw_chain.cu")
        src = src.replace(mark, new, 1)
    src += ('\nextern "C" int probe_read(long long* host, int n, int persistent) {\n'
            "#ifdef VPTR_DW_STAMPS\n"
            "  if (persistent) return cudaMemcpyFromSymbol(host, g_dw_stamp, n * 8);\n"
            "#endif\n"
            "  return cudaMemcpyFromSymbol(host, g_dw_pstamp, n * 8);\n}\n")
    body.write_text(src)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timeline(starts, ends, sms):
    """Start offsets and lifetimes (us) and the idle share of the SMs."""
    span = ends.max() - starts.min()
    life = ends - starts
    return {"start_offset_us_mean": float((starts - starts.min()).mean() / 1e3),
            "start_offset_us_max": float((starts - starts.min()).max() / 1e3),
            "block_life_us_mean": float(life.mean() / 1e3),
            "span_us": float(span / 1e3),
            "sm_idle_share": float(1 - life.sum() / (sms * span))}


def variants(args, tdw, _build, ops) -> int:
    """The persistent route as committed against each variant, in turns."""
    names = args.variants or list(VARIANTS)
    root = _build.BUILD_DIR.parent / "dw_probe"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, name in enumerate(names):
        csrc = root / f"v{i}" / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        body = csrc / "fused_dw_chain.cu"
        src = body.read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not found in fused_dw_chain.cu")
            src = src.replace(old, new)
        body.write_text(src)
        lib = root / f"v{i}" / "lib.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(body)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    committed = tdw._lib()
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.vptr_error_string.argtypes = [ctypes.c_int]
        lib.vptr_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    fn = lambda: tdw._forward_kernel(*ops, None, 8, 0.0, route="persistent")  # noqa: E731
    out = {"card": torch.cuda.get_device_name(0), "samples": args.samples, "variants": {}}
    for name, lib in libs.items():
        reads = []
        for which in (committed, lib, lib, committed):
            _build._LIBS["fused_dw_chain"] = which
            tdw._lib()                # its argument types
            reads.append(cuda_ms(fn))
        _build._LIBS["fused_dw_chain"] = committed
        out["variants"][name] = {"committed_ms": [reads[0], reads[3]],
                                 "variant_ms": [reads[1], reads[2]],
                                 "less_committed_ms": min(reads[1:3]) - min(reads[0], reads[3])}
        print(f"{name:28s} {reads[1]:.4f} / {reads[2]:.4f} ms vs committed {reads[0]:.4f} / "
              f"{reads[3]:.4f}: {out['variants'][name]['less_committed_ms']:+.4f}")
    print(json.dumps(out))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--samples", type=int, default=200)
    parser.add_argument("--variants", nargs="*", choices=list(VARIANTS),
                        help="time these variants of the persistent route (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_dw_probe: no GPU", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from vptr_tpu_torch.ops import _build
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    routes = ("per_sample", "persistent") if hasattr(tdw, "kernel_route") else ("per_sample",)
    dev, bf, n = torch.device("cuda"), torch.bfloat16, args.samples
    g = torch.Generator().manual_seed(0)

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    ops = (r(n, HW, C).to(bf), r(9, C, std=0.3), r(C, std=0.1), 1 + r(HW, C, std=0.1),
           r(HW, C, std=0.1), 1 + r(HW, C, std=0.1), r(HW, C, std=0.1))

    def call(route):
        if len(routes) == 1:
            return lambda: tdw.fused_dw_chain(*ops, 0, 8, 0.0)
        return lambda: tdw._forward_kernel(*ops, None, 8, 0.0, route=route)

    if args.variants is not None:
        return variants(args, tdw, _build, ops)
    out = {"root": str(root), "card": torch.cuda.get_device_name(0), "samples": n,
           "per_sample_clusters": tdw.resident_clusters(HW, C)[0]}
    if "persistent" in routes:
        out["persistent_clusters"] = tdw.persistent_clusters(HW, C, 8)
    order = routes + routes[::-1]
    times = {route: [] for route in routes}
    for route in order:
        times[route].append(cuda_ms(call(route)))
    out["ms"] = times

    probe = _build.BUILD_DIR.parent / "dw_probe"
    shutil.rmtree(probe, ignore_errors=True)
    shutil.copytree(_build.CSRC, probe / "csrc")
    instrument(probe / "csrc")
    lib_path = probe / "libprobe.so"
    flags = list(_build.NVCC_FLAGS) + (["-DVPTR_DW_STAMPS"] if len(routes) == 2 else [])
    subprocess.run([_build.nvcc(), *flags, "-o", str(lib_path),
                    str(probe / "csrc" / "fused_dw_chain.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.vptr_error_string.argtypes = [ctypes.c_int]
    lib.vptr_error_string.restype = ctypes.c_char_p
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    _build._LIBS["fused_dw_chain"] = lib     # the wrapper now runs the stamped copy
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for route in routes:
        fn = call(route)
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if route == "per_sample":
            blocks = n * 8
        else:
            blocks = min(n, out["persistent_clusters"]) * 16
        buf = (ctypes.c_longlong * (blocks * SLOTS))()
        if lib.probe_read(buf, blocks * SLOTS, int(route == "persistent")) != 0:
            raise RuntimeError("reading the stamps failed")
        st = np.array(buf, dtype=np.float64).reshape(blocks, SLOTS)
        if route == "per_sample":
            cycles = np.diff(st[:, :12], axis=1)
            names, per = PER_SAMPLE_PHASES, 1.0
            starts, ends = st[:, 12], st[:, 13]
        else:
            cycles = st[:, :len(PERSISTENT_PHASES)]
            names = PERSISTENT_PHASES
            per = n / (blocks // 16)      # samples a block
            starts, ends = st[:, 14], st[:, 15]
        total = cycles.sum()
        rep = {"stamped_ms": start.elapsed_time(end), "blocks": blocks,
               "block_cycles_mean": float(cycles.sum(axis=1).mean()),
               "phases": {name: {"cycles_mean": float(cycles[:, i].mean() / (
                   1.0 if i in PER_BLOCK else per)),
                   "share": float(cycles[:, i].sum() / total)}
                   for i, name in enumerate(names)},
               **timeline(starts, ends, sms)}
        out[f"{route}_stamps"] = rep
        print(f"{route}: stamped kernel {rep['stamped_ms']:.4f} ms, {blocks} blocks, "
              f"block {rep['block_cycles_mean']:.0f} cycles, life {rep['block_life_us_mean']:.2f}"
              f" us, start offset mean {rep['start_offset_us_mean']:.2f} us, SM idle share "
              f"{rep['sm_idle_share']:.3f}")
        for name, p in rep["phases"].items():
            print(f"  {name:24s} {p['cycles_mean']:10.0f} cycles"
                  f"{'' if route == 'per_sample' else ' a sample'}, share {p['share']:.3f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
