"""The tensor-parallel phases of chip_smoke.py alone, on the card.

    python3 scripts/torch_port_tp_probe.py [--phases 41 42 43 44 51 52 53 54 55 56 57]

Builds the kernels, then runs the named phases (default: all eleven): 41,
kernels #1-#6 on a head subset against their plain versions; 42 and 43,
the far_mnist and nar_mnist (with sequence_parallel) train steps at
mesh.model = 2 against the one-rank step; 44, ``torchrun ... cli train
--set mesh.model=2`` (with sequence_parallel, on the fused-FFN and the
conv-FFN route side by side) each resumed in one process; 51, kernels
#7-#10 on a hidden-channel subset (#9/#10 split over two ranks' channels)
against their plain versions and the whole call; 52, far_mnist's fused-FFN
route step at mesh.model = 2 against the one-rank step; 53, kernels
#11/#12 as the conv
FFN's column-parallel fc1 and row-parallel fc2 (ranks run in step in one
process, M 2 and 4) against their plain versions and the whole tiled
call; 54, far_mnist's conv-FFN route step at mesh.model = 2 against the
one-rank step; 55, kernels #7-#10 on a quarter of the hidden (#9/#10
split over four ranks' 528 channels, each ending in a partial tile); 56,
far_mnist's fused-FFN route step at mesh.model = 4 against the one-rank
step; 57, the examples on the card (on 2-step ae_mnist and far_mnist
checkpoints that it trains first, and nar_mnist's seeded init). Exits non-zero when a check
failed.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke
    from vptr_tpu_torch.ops import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", nargs="*", type=int,
                    default=[41, 42, 43, 44, 51, 52, 53, 54, 55, 56, 57])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_tp_probe: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.build()
    print(f"built in {time.perf_counter() - t0:.1f} s; {chip_smoke.card_line()}", flush=True)
    dev = torch.device("cuda")
    if 41 in args.phases:
        print(chip_smoke.json.dumps(chip_smoke.tp_kernel_phases(dev)))
    if 51 in args.phases:
        print(chip_smoke.json.dumps(chip_smoke.tp_ffn_kernel_phase(dev)))
    if 53 in args.phases:
        print(chip_smoke.json.dumps(chip_smoke.tp_conv_kernel_phase(dev)))
    if 55 in args.phases:
        print(chip_smoke.json.dumps(chip_smoke.tp_quarter_kernel_phase(dev)))
    steps = [p for p in (42, 43, 44, 52, 54, 56) if p in args.phases]
    if steps:
        print(chip_smoke.json.dumps(chip_smoke.tp_phases(dev, chip_smoke.card_line(), steps)))
    if 57 in args.phases:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="vptr_probe_examples_") as root:
            print(chip_smoke.json.dumps(chip_smoke.example_phase(dev, Path(root))))
    if chip_smoke.failures:
        print(f"{len(chip_smoke.failures)} check(s) failed: {chip_smoke.failures}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
