"""The data-parallel phases of chip_smoke.py (32-35) alone, on every card of
the machine: the kernels built from csrc/, then NCCL's all-reduce of the
far_bair_dp transformer's gradients at W = the cards, far_bair_dp's
one-rank train step at full width, the two-rank step (two cards over NCCL,
or two processes on one card over gloo) and, with more than two cards, the
step at W = the cards at the preset's global batch 64, and ``torchrun
--nproc_per_node=<cards> -m vptr_tpu_torch.cli train / eval``.

    python3 scripts/torch_port_dp_probe.py

Prints the card's name and power limit, each phase's checks and readings,
and the readings as one JSON line; exits non-zero if a check failed or
there is no GPU.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_port_dp_probe: no GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from vptr_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    summary, extra, launches = chip_smoke.dp_phases(torch.device("cuda"), card)
    print(f"\n  {summary}\n  #1-#4 launches in one far_bair_dp step: {launches}\n"
          f"  phases 32-35 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps(extra))
    if chip_smoke.failures:
        print(f"{len(chip_smoke.failures)} check(s) failed: {chip_smoke.failures}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
