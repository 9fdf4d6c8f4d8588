"""The port's multi-rank dry run: one train step of each stage on a (data 2,
model 2) mesh with tensor and sequence parallelism.

    python -m vptr_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]

Counterpart of ``__graft_entry__.py:49-124`` (``dryrun_multichip``), which
runs the same steps on a mesh of virtual CPU devices. Here ``--ranks``
processes are spawned on this machine, each told its rank as ``torchrun``
tells it: gloo on the CPU; on the card NCCL where the machine has a card a
rank, else gloo with every rank on the one card. Each rank runs the
ae_mnist, far_mnist and nar_mnist (2 + 2 layers) train steps at the JAX
dry run's tiny overrides (d_model 24 over 4 heads, 4 x 4 latents of 32 x
32 frames, 2 + 2 frames, 2 rows a data rank, ``sequence_parallel`` on)
through the :class:`~vptr_tpu_torch.train.trainer.Trainer`, from the
config's seed, on its data rank's rows of one seeded batch; rank 0 prints
one line a stage, ``dryrun_multichip <preset> ok: {metrics} mesh:
{"data": 2, "model": 2}``. Every metric must be the same on every rank
and every loss finite, or the run exits non-zero (the first NAR step's
gradient norm overflows at this init, in one process too: the NCE head's
L2-normalised projections of near-zero features).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

PRESETS = (("ae_mnist", {}), ("far_mnist", {}), ("nar_mnist", {"num_decoder_layers": 2}))
MODEL = 2                   # the mesh's model axis


def overrides(data: int, model: int) -> dict:
    """``__graft_entry__.py``'s dry-run overrides on a (data, model) mesh."""
    return {
        "dtype": "float32",
        "mesh": {"data": data, "model": model},
        "ae": {"feat_dim": 24, "n_res_blocks": 1},
        "transformer": {"d_model": 24, "n_heads": 4, "num_encoder_layers": 2,
                        "enc_h": 4, "enc_w": 4,
                        "num_past_frames": 2, "num_future_frames": 2,
                        "sequence_parallel": True},
        "data": {"batch_size": 2 * data, "img_size": 32,
                 "num_past_frames": 2, "num_future_frames": 2},
    }


def run_rank(device: str, backend: str) -> int:
    """One rank's steps (the process group from the environment)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.parallel import destroy_distributed, host_id, init_distributed, num_hosts
    from vptr_tpu_torch.train.trainer import Trainer

    if not init_distributed(device, backend=backend or None):
        print("dryrun: no process group in the environment", file=sys.stderr)
        return 1
    ok = True
    try:
        data = num_hosts() // MODEL
        batch = 2 * data
        past = np.random.default_rng(0).random((batch, 2, 32, 32, 1)).astype(np.float32)
        future = np.random.default_rng(1).random((batch, 2, 32, 32, 1)).astype(np.float32)
        for preset, extra in PRESETS:
            cfg = get_preset(preset).override(overrides(data, MODEL)).override(
                {"transformer": extra})
            trainer = Trainer(cfg, device=device, write_outputs=False)
            rows = slice(trainer.mesh.data_rank * 2, trainer.mesh.data_rank * 2 + 2)
            state = trainer.init_state()
            state, m = trainer.train_step(state, *trainer.put_batch(past[rows], future[rows]))
            metrics = {k: float(v) for k, v in m.items()}
            mine = torch.tensor(list(metrics.values()), dtype=torch.float64)
            if dist.get_backend() == "nccl":
                mine = mine.cuda()
            low, high = mine.clone(), mine.clone()
            dist.all_reduce(low, op=dist.ReduceOp.MIN)
            dist.all_reduce(high, op=dist.ReduceOp.MAX)
            same = bool(torch.equal(low, high))
            # the losses (the first NAR step's gradient norm may overflow: its
            # L2-normalised NCE projections of near-zero features)
            finite = all(math.isfinite(v) for k, v in metrics.items() if k != "grad_norm")
            ok = ok and same and finite
            if host_id() == 0:
                print(f"dryrun_multichip {preset} ok: {json.dumps(metrics)} mesh: "
                      f"{json.dumps({'data': trainer.mesh.data, 'model': trainer.mesh.model})}"
                      + ("" if same and finite else
                         f" FAILED (finite {finite}, equal on every rank {same})"),
                      flush=True)
    finally:
        destroy_distributed()
    return 0 if ok else 1


def launch(ranks: int, device: str, timeout: float) -> int:
    """Spawn the ranks and wait for them; returns the worst exit code."""
    cards = 0
    if device != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("dryrun: no CUDA device (use --device cpu)", file=sys.stderr)
            return 1
        cards = torch.cuda.device_count()
    one_card = device != "cpu" and cards < ranks
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(ranks),
           "PYTHONPATH": os.pathsep.join([root] + ([os.environ["PYTHONPATH"]]
                                                   if os.environ.get("PYTHONPATH") else []))}
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "vptr_tpu_torch.parallel.dryrun", "--worker",
           "--device", device, "--backend", "gloo" if one_card else ""]
    procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r),
                                        "LOCAL_RANK": "0" if one_card else str(r)})
             for r in range(ranks)]
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(codes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vptr_tpu_torch.parallel.dryrun")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return run_rank(args.device, args.backend)
    if args.ranks % MODEL:
        ap.error(f"--ranks {args.ranks} does not split over the model axis of {MODEL}")
    return launch(args.ranks, args.device, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
