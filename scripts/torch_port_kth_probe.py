"""The nar_kth_128 phases of chip_smoke.py alone, on the card.

    python3 scripts/torch_port_kth_probe.py [--phases 45 47 48 49 50]

Builds the kernels, then runs the named phases (default: all): 45-46,
kernels #9-#12 at nar_kth_128's 16 x 16 latent against their plain
versions on their tiled routes, and their times beside the plain versions,
the library and the bound; 47-49, nar_kth_128 at full width on the
default, fused-FFN and conv-FFN routes (the nar predict 10 -> 10 and
10 -> 40, the train step, each against kernels="plain", with their launch
counts); 50, ``cli train`` / a resumed run / ``cli eval`` / ``cli
predict`` at that preset. Prints the readings as JSON lines; exits
non-zero when a check failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.ops import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", nargs="*", type=int, default=[45, 47, 48, 49, 50])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_kth_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    print(f"built in {time.perf_counter() - t0:.1f} s; {chip_smoke.card_line()}", flush=True)
    dev = torch.device("cuda")
    if 45 in args.phases:
        print(json.dumps(chip_smoke.kth_kernel_phases(dev)), flush=True)
    routes = [(n, label, flags) for n, (label, flags) in zip((47, 48, 49), chip_smoke.KTH_ROUTES)
              if n in args.phases]
    if routes:
        train, test = chip_smoke.kth_batches(get_preset(chip_smoke.KTH), dev)
        for n, label, flags in routes:
            out = chip_smoke.kth_route_phase(dev, n, label, flags, train, test)
            print(json.dumps({label: out}), flush=True)
        del train, test
    if 50 in args.phases:
        print(json.dumps(chip_smoke.kth_cli_phase(dev, 50)), flush=True)
    print(f"the probe's wall time: {time.perf_counter() - t0:.1f} s")
    if chip_smoke.failures:
        print(f"{len(chip_smoke.failures)} check(s) failed: {chip_smoke.failures}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
