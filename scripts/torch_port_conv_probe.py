"""Where kernels #11 and #12's (conv_ln_gelu forward and backward, bf16)
time goes, on one GPU.

    python3 scripts/torch_port_conv_probe.py [--repeats 3] [--only NAME ...]

Times conv_ln_gelu in bf16 at both stages of the far_mnist conv FFN (fc1
528 -> 2112 and fc2 2112 -> 528; the forward over 200 samples of 64
positions, the backward over 190) as committed, and copies of the package
under build/conv_probe/ whose csrc/conv_ln_gelu.cu, conv_ln_gelu_bwd.cu or
conv_ln_wg.cuh is changed in a few places (VARIANTS): another design
choice (samples a block, feeder warp, ring stages, the dx tile, how
many loads the backward's sweeps issue together: right values), or one
part of the work left out (the affine loads, the cluster sums, the output
store, the backward's per-sample stores, its last sweep:
wrong values by design), whose difference from the committed kernel is
that part's time; the backward's passes alone ("pass 1 alone", "dx
alone", "dW alone", "sums alone") read each pass's own time. The
committed kernels are not changed. Each copy is built and timed in its
own process (mean CUDA-event time of 30 calls after 3 warm-ups,
--repeats times; the copies' libraries are all built first, in
parallel). Prints one JSON line with every reading, the card's name and
each variant's best time less the committed kernel's. Exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FWD, BWD, WG = "csrc/conv_ln_gelu.cu", "csrc/conv_ln_gelu_bwd.cu", "csrc/conv_ln_wg.cuh"
PASS1 = "  if (int err = pass1_wg(a, s)) return err;      // 1. du and the partials"
DX = "  if (int err = dx_wg(a, s)) return err;         // 2. dx = du W^T"
DW = "  return dw_wg(a, s);                            //    dW = x^T du"
SUMS = "  return sums<T>(a, s);"
# variant -> [(source, text it replaces (every occurrence), replacement), ...]
VARIANTS = {
    "one sample a block": [(
        FWD, "constexpr int wg_samples(int cw) { return cw <= 2 ? 2 : 1; }",
        "constexpr int wg_samples(int cw) { return 1; }")],
    "no feeder warp": [(
        FWD, "  wg_sample_loop<CW, S, wg_feeder(CW, S)>(",
        "  wg_sample_loop<CW, S, false>("), (
        FWD, "__global__ void __launch_bounds__(wg_threads(CW, S), 1)\nconv_ln_gelu_wg_kernel(",
        "__global__ void __launch_bounds__(wg_threads(CW, S, false), 1)\n"
        "conv_ln_gelu_wg_kernel("), (
        FWD, "constexpr int S = wg_samples(CW), kThreads = wg_threads(CW, S);",
        "constexpr int S = wg_samples(CW), kThreads = wg_threads(CW, S, false);")],
    "at most three stages": [(
        WG, "constexpr int kWgMaxStages = 6;", "constexpr int kWgMaxStages = 3;")],
    "without the statistics' cluster sums": [(
        WG, "  wg_put(t, p.s, v);\n  wg_cluster_sum(t, red, count, G, rank);",
        "  wg_put(t, p.s, v);")],
    "without the affine loads": [
        (FWD, "const float2 sc = *reinterpret_cast<const float2*>(scale + o + e);",
         "const float2 sc = make_float2(1.f, 1.f);"),
        (FWD, "const float2 bs = *reinterpret_cast<const float2*>(bias2 + o + e);",
         "const float2 bs = make_float2(0.f, 0.f);"),
        (BWD, "__ldg(reinterpret_cast<const float2*>(scale + e))", "make_float2(1.f, 1.f)"),
        (BWD, "__ldg(reinterpret_cast<const float2*>(scale + o + at(j0 + jj, h)))",
         "make_float2(1.f, 1.f)"),
        (BWD, "__ldg(reinterpret_cast<const float2*>(bias2 + e))", "make_float2(0.f, 0.f)")],
    "without the store": [(
        FWD, "*reinterpret_cast<__nv_bfloat162*>(on + e) = __floats2bfloat162_rn(y0, y1);",
        "if (y0 == 12345.f && y1 == 54321.f) on[e] = bf16();")],
    "bwd: two samples a block at fc1": [(
        BWD, "constexpr int bwd_samples(int cw) { return cw <= 1 ? 2 : 1; }",
        "constexpr int bwd_samples(int cw) { return cw <= 2 ? 2 : 1; }")],
    "bwd: no feeder warp": [(
        BWD, "constexpr bool bwd_feeder(int cw) { return cw == 1; }",
        "constexpr bool bwd_feeder(int cw) { return false; }")],
    "bwd: a feeder warp at fc1 too": [(
        BWD, "constexpr bool bwd_feeder(int cw) { return cw == 1; }",
        "constexpr bool bwd_feeder(int cw) { return cw <= 2; }")],
    "bwd: dx on one column group a block": [
        (BWD, "wg_groups(a.Cin) == 1 ? launch_dx_wg<1>(a, s) : launch_dx_wg<2>(a, s);",
         "launch_dx_wg<1>(a, s);")],
    "bwd: dx on three column groups a block": [
        (BWD, "wg_groups(a.Cin) == 1 ? launch_dx_wg<1>(a, s) : launch_dx_wg<2>(a, s);",
         "wg_groups(a.Cin) == 1 ? launch_dx_wg<1>(a, s) : launch_dx_wg<3>(a, s);")],
    "bwd: loads of 1 octet at a time": [(
        BWD, "constexpr int kEpiJ = 2;", "constexpr int kEpiJ = 1;")],
    "bwd: loads of 4 octets at a time": [(
        BWD, "constexpr int kEpiJ = 2;", "constexpr int kEpiJ = 4;")],
    "bwd: without the per-sample stores": [
        (BWD, "*reinterpret_cast<float2*>(pdt + po",
         "if (da0 == 12345.f) *reinterpret_cast<float2*>(pdt + po"),
        (BWD, "__stcs(reinterpret_cast<float2*>(pds",
         "if (d0 == 12345.f) __stcs(reinterpret_cast<float2*>(pds"),
        (BWD, "__stcs(reinterpret_cast<float2*>(pdb",
         "if (d0 == 12345.f) __stcs(reinterpret_cast<float2*>(pdb")],
    "bwd: without the du stores": [
        (BWD, "__stcs(reinterpret_cast<__nv_bfloat162*>(du + e), dh);",
         "if (d0 == 12345.f) __stcs(reinterpret_cast<__nv_bfloat162*>(du + e), dh);"),
        (BWD, "__stcs(reinterpret_cast<__nv_bfloat162*>(du + half + e),",
         "if (d0 == 12345.f) __stcs(reinterpret_cast<__nv_bfloat162*>(du + half + e),")],
    "bwd: without sweep 3": [
        (BWD, "      float2 sc[kEpiJ][2], da[kEpiJ][2];",
         "      if (m1 != 12345.f) return;\n      float2 sc[kEpiJ][2], da[kEpiJ][2];")],
    "bwd: pass 1 alone": [(BWD, DX, ""), (BWD, DW, "  return 0;"), (BWD, SUMS, "  return 0;")],
    "bwd: dx alone": [(BWD, PASS1, ""), (BWD, DW, "  return 0;"), (BWD, SUMS, "  return 0;")],
    "bwd: dW alone": [(BWD, PASS1, ""), (BWD, DX, ""), (BWD, SUMS, "  return 0;")],
    "bwd: sums alone": [(BWD, PASS1, ""), (BWD, DX, ""), (BWD, DW, "  return 0;")],
}


BUILD = ("import sys; sys.path.insert(0, '.'); from vptr_tpu_torch.ops import _build; "
         "_build.build(['conv_ln_gelu', 'conv_ln_gelu_bwd'])")


def time_conv(root: str, repeats: int) -> dict:
    import torch

    sys.path.insert(0, root)
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl

    if Path(tcl.__file__).resolve().parents[2] != Path(root).resolve():
        raise RuntimeError(f"imported {tcl.__file__}, not from {root}")
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    def mean_ms(fn):
        for _ in range(3):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(30):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 30

    out = {}
    for stage, (cin, cout) in (("fc1", (528, 2112)), ("fc2", (2112, 528))):
        def ops(n):
            return (r(n, 64, cin).to(bf), r(cin, cout, std=cin ** -0.5).to(bf),
                    r(cout, std=0.1), 1 + r(64, cout, std=0.1), r(64, cout, std=0.1))

        fwd, bwd, gout = ops(200), ops(190), r(190, 64, cout).to(bf)
        out[stage], out[f"bwd_{stage}"] = [], []
        for _ in range(repeats):
            out[stage].append(mean_ms(lambda: tcl.conv_ln_gelu(*fwd)))
            out[f"bwd_{stage}"].append(mean_ms(lambda: tcl.conv_ln_gelu_backward(*bwd, gout)))
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--only", nargs="*", help="variants to time (default: all)")
    parser.add_argument("--time", help=argparse.SUPPRESS)   # one root, in a child
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_port_conv_probe: no GPU", file=sys.stderr)
        return 1
    if args.time:
        print(json.dumps(time_conv(args.time, args.repeats)))
        return 0
    roots = {"committed": str(REPO)}
    for name, edits in VARIANTS.items():
        if args.only and name not in args.only:
            continue
        root = REPO / "build" / "conv_probe" / "".join(ch if ch.isalnum() else "_" for ch in name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "vptr_tpu_torch", root / "vptr_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for source, old, new in edits:
            src = root / "vptr_tpu_torch" / source
            text = src.read_text()
            if old not in text:
                raise RuntimeError(f"{name}: the text to replace is not in {source}")
            src.write_text(text.replace(old, new))
        roots[name] = str(root)
    # every copy's two libraries built at once (one nvcc each), then timed
    # one after another
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=root) for root in roots.values()]
    for b in builds:
        b.wait(timeout=900)
    result = {}
    for name, root in roots.items():
        run = subprocess.run([sys.executable, __file__, "--time", root, "--repeats",
                              str(args.repeats)], capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:         # a variant that does not build or run
            print(run.stdout + run.stderr, file=sys.stderr)
            if name == "committed":
                return 1
            continue
        result[name] = json.loads(run.stdout.strip().splitlines()[-1])
    base = {stage: min(ms) for stage, ms in result["committed"].items()}
    delta = {name: {stage: round(min(ms) - base[stage], 4) for stage, ms in r.items()}
             for name, r in result.items() if name != "committed"}
    print(json.dumps({"ms": result, "minus_committed_ms": delta,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
