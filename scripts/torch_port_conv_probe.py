"""Where kernel #11's (conv_ln_gelu, bf16) time goes, on one GPU.

    python3 scripts/torch_port_conv_probe.py [--repeats 3] [--only NAME ...]

Times conv_ln_gelu in bf16 at both stages of the far_mnist conv FFN (200
samples of 64 positions, fc1 528 -> 2112 and fc2 2112 -> 528) as
committed, and copies of the package under build/conv_probe/ whose
csrc/conv_ln_gelu.cu is changed in one place (VARIANTS): another design
choice (one sample a block, no feeder warp, fewer ring stages: right
values), or one part of the work
left out (the affine loads, the cluster sums, the output store: wrong
values by design), whose difference from the committed kernel is that
part's time. The committed kernel is not changed. Each copy is built and
timed in its own process (mean CUDA-event time of 30 calls after 3
warm-ups, --repeats times). Prints one JSON line with every reading, the
card's name and each variant's best time less the committed kernel's.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = "csrc/conv_ln_gelu.cu"
# variant -> [(text of csrc/conv_ln_gelu.cu it replaces, replacement), ...]
VARIANTS = {
    "one sample a block": [(
        "constexpr int wg_samples(int cw) { return cw <= 2 ? 2 : 1; }",
        "constexpr int wg_samples(int cw) { return 1; }")],
    "no feeder warp": [(
        "__host__ __device__ constexpr bool wg_feeder(int cw, int s) { return cw * s <= 2; }",
        "__host__ __device__ constexpr bool wg_feeder(int cw, int s) { return false; }")],
    "at most three stages": [(
        "constexpr int kWgMaxStages = 6;", "constexpr int kWgMaxStages = 3;")],
    "without the affine loads": [
        ("const float2 sc = *reinterpret_cast<const float2*>(scale + o + e);",
         "const float2 sc = make_float2(1.f, 1.f);"),
        ("const float2 bs = *reinterpret_cast<const float2*>(bias2 + o + e);",
         "const float2 bs = make_float2(0.f, 0.f);")],
    "without the cluster sums": [
        ("float2 t = wg_cluster_sum(make_float2(s ? 0.f : v, s ? v : 0.f), red, count, G, rank);",
         "float2 t = make_float2(v, v);"),
        ("t = wg_cluster_sum(make_float2(s ? 0.f : v, s ? v : 0.f), red, count, G, rank);",
         "t = make_float2(v, v);")],
    "without the store": [
        ("*reinterpret_cast<__nv_bfloat162*>(on + e) = __floats2bfloat162_rn(y0, y1);",
         "if (y0 == 12345.f && y1 == 54321.f) on[e] = bf16();")],
}


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

    out = {}
    for stage, (cin, cout) in (("fc1", (528, 2112)), ("fc2", (2112, 528))):
        ops = (r(200, 64, cin).to(bf), r(cin, cout, std=cin ** -0.5).to(bf),
               r(cout, std=0.1), 1 + r(64, cout, std=0.1), r(64, cout, std=0.1))
        out[stage] = []
        for _ in range(repeats):
            for _ in range(3):
                tcl.conv_ln_gelu(*ops)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(30):
                tcl.conv_ln_gelu(*ops)
            end.record()
            torch.cuda.synchronize()
            out[stage].append(start.elapsed_time(end) / 30)
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
        root = REPO / "build" / "conv_probe" / name.replace(" ", "_").replace(",", "")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "vptr_tpu_torch", root / "vptr_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = root / "vptr_tpu_torch" / SOURCE
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in {SOURCE} once")
            text = text.replace(old, new)
        src.write_text(text)
        roots[name] = str(root)
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
