"""Command-line interface of the port.

Counterpart of ``vptr_tpu/cli.py``, with the same commands, flags, ``--set``
parsing and output, and one more flag, ``--device`` (default ``cuda``: the
card; ``cpu`` runs the kernels' plain versions on the CPU):

    python -m vptr_tpu_torch.cli presets
    python -m vptr_tpu_torch.cli train --preset far_mnist --set epochs=10 \\
        --set data.batch_size=16 --set ckpt_dir=/tmp/far
    python -m vptr_tpu_torch.cli eval --preset far_mnist --ckpt-dir /tmp/far \\
        --mode far_rip --num-pred 10
    python -m vptr_tpu_torch.cli predict --preset far_mnist --ckpt-dir /tmp/far \\
        --out /tmp/far/predictions
    python -m vptr_tpu_torch.cli info --preset nar_mnist

Checkpoints are the port's own (``vptr_tpu_torch.train.checkpoint``), not
the JAX package's orbax ones.

``train`` and ``eval`` run data parallel under ``torchrun`` (the
reference's ``_mp`` drivers), one process a card, NCCL between them (gloo
with ``--device cpu``):

    torchrun --standalone --nproc_per_node=8 -m vptr_tpu_torch.cli train \
        --preset far_bair_dp

``eval`` then evaluates each rank's shard of the test set and every rank
holds the curves over all of them (rank 0 prints them). ``predict`` runs in
one process.

With ``--set mesh.model=M`` the W ranks form a (W / M, M) mesh: the
transformer's heads and hidden channels are split over the M ranks of each
data group (tensor parallelism), and ``--set
transformer.sequence_parallel=true`` also splits its temporal columns:

    torchrun --standalone --nproc_per_node=2 -m vptr_tpu_torch.cli train \
        --preset far_mnist --set mesh.model=2 --set transformer.sequence_parallel=true

Its checkpoints are whole (the one-process layout): the run resumes with
another ``mesh.model``, in one process too.
"""

from __future__ import annotations

import argparse
import json
import os


def _parse_value(raw: str):
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    if raw.lower() in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    return raw


def _apply_sets(cfg, sets):
    for item in sets or []:
        key, _, raw = item.partition("=")
        if not _:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        d = {}
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            node[p] = {}
            node = node[p]
        node[parts[-1]] = _parse_value(raw)
        cfg = cfg.override(d)
    return cfg


def _load_cfg(args):
    from vptr_tpu_torch.config import get_preset

    cfg = get_preset(args.preset)
    if getattr(args, "ckpt_dir", None):
        cfg = cfg.override({"ckpt_dir": args.ckpt_dir})
    return _apply_sets(cfg, args.set)


def _restored(args):
    """(trainer, its state restored from the latest checkpoint under
    ``<ckpt_dir>/ckpt`` when there is one)."""
    from vptr_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_load_cfg(args), device=args.device)
    state = trainer.init_state()
    if trainer.ckpt.latest_step() is not None:
        state = trainer.ckpt.restore(state)
    return trainer, state


def cmd_presets(_):
    from vptr_tpu_torch.config import get_preset, list_presets

    for name in list_presets():
        cfg = get_preset(name)
        print(f"{name:16s} stage={cfg.stage:4s} dataset={cfg.data.dataset:10s}"
              f" batch={cfg.data.batch_size}")


def cmd_info(args):
    print(_load_cfg(args).to_json())


def cmd_train(args):
    from vptr_tpu_torch.parallel import init_distributed
    from vptr_tpu_torch.train.trainer import Trainer

    init_distributed(args.device)
    Trainer(_load_cfg(args), device=args.device).train()


def cmd_eval(args):
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.eval.harness import evaluate
    from vptr_tpu_torch.eval.lpips import lpips_available, make_lpips_fn
    from vptr_tpu_torch.parallel import host_id, init_distributed

    init_distributed(args.device)
    trainer, state = _restored(args)
    cfg = trainer.cfg
    # each data rank's shard (the model ranks of a data group hold the same rows)
    loader = build_loader(cfg.data, split="test", seed=cfg.seed,
                          host_id=trainer.mesh.data_rank, num_hosts=trainer.mesh.data)
    # LPIPS reports automatically when pretrained weights are present
    # (reference: Test_VPTR.ipynb cell 9); --no-lpips opts out
    lpips_fn = (make_lpips_fn(device=trainer.device)
                if (lpips_available() and not args.no_lpips) else None)
    curves = evaluate(trainer, state, loader, mode=args.mode,
                      num_pred=args.num_pred, lpips_fn=lpips_fn,
                      max_batches=args.max_batches)
    out = {m: [round(float(v), 4) for v in c] for m, c in curves.items()}
    out["mean"] = {m: round(float(sum(c) / len(c)), 4)
                   for m, c in curves.items()}
    if host_id() == 0:
        print(json.dumps(out, indent=2))


def cmd_predict(args):
    """Generate future-frame predictions from a checkpoint and write
    side-by-side GIFs + video clips (the reference's Test_VPTR.ipynb
    cells 5-11 as a command). Both are written with PIL; where PIL does
    not import, the predictions run and the command says that nothing was
    written."""
    import importlib.util
    from contextlib import closing
    from pathlib import Path

    import numpy as np

    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.data.preprocessing import visualize_clip
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.parallel import num_hosts
    from vptr_tpu_torch.train.summary import visualize_batch_clips

    world = max(int(os.environ.get("WORLD_SIZE") or 1), num_hosts())
    if world > 1:
        raise RuntimeError(f"predict runs in one process; it was launched as one "
                           f"of {world} (WORLD_SIZE): run it without torchrun")
    trainer, state = _restored(args)
    cfg = trainer.cfg
    num_pred = args.num_pred or cfg.data.test_future_frames
    predict = make_predict_fn(cfg, state.enc, state.dec, state.transformer,
                              args.mode, num_pred, trainer.device)
    loader = build_loader(cfg.data, split="test", seed=cfg.seed)
    have_pil = importlib.util.find_spec("PIL") is not None

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with closing(iter(loader)) as batches:
        for bi, (past, future) in enumerate(batches):
            if bi >= args.batches:
                break
            pred = predict(*trainer.put_batch(past, future)).float().cpu().numpy()
            if not have_pil:
                print(f"batch {bi}: predicted {pred.shape}; PIL does not import, "
                      f"so no GIF or clip was written")
                continue
            visualize_batch_clips(past, future[:, :num_pred],
                                  pred[:, :num_pred], str(out / f"batch{bi}"),
                                  renorm=trainer.renorm, desc=args.mode)
            for n in range(min(2, pred.shape[0])):
                clip = np.clip(trainer.renorm(pred[n, :num_pred]), 0.0, 1.0)
                path = visualize_clip(clip, str(out / f"b{bi}_s{n}_pred.mp4"))
                print("wrote", path)
    print("predictions in", out)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="vptr_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("presets").set_defaults(fn=cmd_presets)

    def common(p, device=True):
        p.add_argument("--preset", required=True)
        p.add_argument("--set", action="append", metavar="key.path=value")
        p.add_argument("--ckpt-dir", default=None)
        if device:
            p.add_argument("--device", default="cuda",
                           help="torch device to run on (default: the card)")

    p_info = sub.add_parser("info")
    common(p_info, device=False)
    p_info.set_defaults(fn=cmd_info)

    p_train = sub.add_parser("train")
    common(p_train)
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("eval")
    common(p_eval)
    p_eval.add_argument("--mode", default="far",
                        choices=["far", "far_rip", "far_ril", "nar"])
    p_eval.add_argument("--num-pred", type=int, default=None)
    p_eval.add_argument("--max-batches", type=int, default=None)
    p_eval.add_argument("--no-lpips", action="store_true",
                        help="skip LPIPS even when weights are available")
    p_eval.set_defaults(fn=cmd_eval)

    p_pred = sub.add_parser("predict")
    common(p_pred)
    p_pred.add_argument("--mode", default="far_rip",
                        choices=["far", "far_rip", "far_ril", "nar"])
    p_pred.add_argument("--num-pred", type=int, default=None)
    p_pred.add_argument("--batches", type=int, default=1)
    p_pred.add_argument("--out", default="predictions")
    p_pred.set_defaults(fn=cmd_predict)

    args = parser.parse_args(argv)
    from vptr_tpu_torch.parallel import destroy_distributed

    try:
        args.fn(args)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
