"""Where kernel #7's (fused_ffn) time goes, on one GPU.

    python3 scripts/torch_port_ffn_probe.py [--repeats 3]

Times fused_ffn at the far_rip path's shape (12,800 rows x 528 channels,
hidden 2112, bf16, dropout 0) as committed, and three copies of the
package under build/ffn_probe/ whose csrc/fused_ffn.cu drops one part of
the work: the fc1 product, the fc2 product, or the GELU (the hidden is
then fc1 + b1). The difference between the committed kernel and a copy is
that part's time. The copies compute wrong values by design; the
committed kernel is not changed. Each copy is built and timed in its own
process (mean CUDA-event time of 30 calls after 3 warm-ups, --repeats
times). Prints one JSON line. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = "csrc/fused_ffn.cu"
# variant -> (text of csrc/fused_ffn.cu it replaces, replacement)
VARIANTS = {
    "without fc1": ("      warp_gemm<1>(xn, ldx, bt, all, H, C / 16, ring, lane, c);\n", ""),
    "without fc2": ("    warp_gemm<kColTiles>(hc, ldh, bt, owned, C, hw / 16, ring, lane, y);\n",
                    ""),
    "without GELU": ("float v = vptr_gelu::gelu(stage[e] + b1[col]);",
                     "float v = stage[e] + b1[col];"),
}


def time_fused_ffn(root: str, repeats: int) -> list:
    import torch

    sys.path.insert(0, root)
    from vptr_tpu_torch.ops import fused_ffn as tff

    if Path(tff.__file__).resolve().parents[2] != Path(root).resolve():
        raise RuntimeError(f"imported {tff.__file__}, not from {root}")
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    c, hid = 528, 2112
    ops = (r(12800, c).to(bf), r(c, hid, std=c ** -0.5).to(bf), r(hid, std=0.1),
           r(hid, c, std=hid ** -0.5).to(bf), r(c, std=0.1), 1 + r(c, std=0.1),
           r(c, std=0.1))
    out = []
    for _ in range(repeats):
        for _ in range(3):
            tff.fused_ffn(*ops)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(30):
            tff.fused_ffn(*ops)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / 30)
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--time", help=argparse.SUPPRESS)   # one root, in a child
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_port_ffn_probe: no GPU", file=sys.stderr)
        return 1
    if args.time:
        print(json.dumps(time_fused_ffn(args.time, args.repeats)))
        return 0
    roots = {"fused_ffn": str(REPO)}
    for name, (old, new) in VARIANTS.items():
        root = REPO / "build" / "ffn_probe" / name.replace(" ", "_")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "vptr_tpu_torch", root / "vptr_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = root / "vptr_tpu_torch" / SOURCE
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not in {SOURCE} once")
        src.write_text(text.replace(old, new))
        roots[name] = str(root)
    result = {}
    for name, root in roots.items():
        run = subprocess.run([sys.executable, __file__, "--time", root, "--repeats",
                              str(args.repeats)], capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        result[name] = json.loads(run.stdout.strip().splitlines()[-1])
    base = min(result["fused_ffn"])
    summary = {name: round(base - min(ms), 4) for name, ms in result.items()
               if name != "fused_ffn"}
    print(json.dumps({"ms": result, "part_ms": summary,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
