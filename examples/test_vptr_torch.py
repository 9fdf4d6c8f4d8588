"""Full-pipeline inference on the PyTorch/CUDA port (vptr_tpu_torch) — the
counterpart of test_vptr.py beside it, and of the reference's
Test_VPTR.ipynb: load a checkpoint that ``python -m vptr_tpu_torch.cli
train`` wrote, run any of the four rollout strategies, report the
per-timestep PSNR/SSIM(/LPIPS) curves and save prediction GIFs.

    python examples/test_vptr_torch.py --preset far_mnist --ckpt-dir /tmp/far \\
        --mode far_rip --num-pred 10 --gif-dir ./pred_gifs

Runs on the card unless ``--device cpu`` is given. Modes (reference:
Test_VPTR.ipynb cells 5-11):
  far       teacher-forced one-shot
  far_rip   autoregressive, decode->re-encode each frame (canonical)
  far_ril   autoregressive, latent feedback ("worse result" per upstream)
  nar       NAR block chaining (e.g. BAIR 2->28 as 10+10+8)

The checkpoint is the port's ``<ckpt-dir>/ckpt/<step>/state.pt`` (the
latest step). ``--set key.path=value`` overrides the preset as the CLI's
does, e.g. ``--set transformer.fused_ffn=true --set
transformer.fused_dw=true`` for the fused-FFN route. ``--lpips`` adds the
LPIPS curve where the pretrained weights are on disk
(``vptr_tpu_torch/eval/lpips.py::default_weights``); without them it says
so and runs without LPIPS.
"""

from __future__ import annotations

# runnable from anywhere: put the repo root on sys.path when the package
# is not installed
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import importlib.util
from contextlib import closing

import numpy as np


def main(argv=None):
    """Run the example; returns the curves it prints, {metric: (num_pred,)
    array}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", required=True)
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--mode", default="far_rip",
                        choices=["far", "far_rip", "far_ril", "nar"])
    parser.add_argument("--num-pred", type=int, default=None)
    parser.add_argument("--max-batches", type=int, default=8)
    parser.add_argument("--lpips", action="store_true")
    parser.add_argument("--gif-dir", default=None)
    parser.add_argument("--set", action="append")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)

    from vptr_tpu_torch.cli import _apply_sets
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.eval.harness import evaluate, make_predict_fn
    from vptr_tpu_torch.eval.lpips import default_weights, lpips_available, make_lpips_fn
    from vptr_tpu_torch.train.checkpoint import CheckpointManager
    from vptr_tpu_torch.train.summary import visualize_batch_clips
    from vptr_tpu_torch.train.trainer import Trainer

    cfg = _apply_sets(get_preset(args.preset).override(
        {"ckpt_dir": args.ckpt_dir}), args.set)
    trainer = Trainer(cfg, device=args.device, write_outputs=False)
    ckpt = CheckpointManager(f"{args.ckpt_dir}/ckpt")
    state = ckpt.restore(trainer.init_state())

    num_pred = args.num_pred or cfg.data.test_future_frames
    loader = build_loader(cfg.data, split="test", seed=cfg.seed)
    lpips_fn = None
    if args.lpips:
        if lpips_available():
            lpips_fn = make_lpips_fn(device=trainer.device)
        else:
            print(f"no LPIPS weights at {default_weights()}: the curves are "
                  f"without LPIPS (nothing is downloaded)")
    curves = evaluate(trainer, state, loader, mode=args.mode,
                      num_pred=num_pred, lpips_fn=lpips_fn,
                      max_batches=args.max_batches)
    for m, c in curves.items():
        print(f"{m:6s} per-timestep:",
              " ".join(f"{v:.4f}" for v in c),
              f"| mean {np.mean(c):.4f}")

    if args.gif_dir:
        predict = make_predict_fn(cfg, state.enc, state.dec, state.transformer,
                                  args.mode, num_pred, trainer.device)
        with closing(iter(loader)) as batches:
            past, future = next(batches)
        pred = predict(*trainer.put_batch(past, future)).float().cpu().numpy()
        if importlib.util.find_spec("PIL") is None:
            print(f"predicted {pred.shape}; PIL does not import, so no GIF was written")
        else:
            visualize_batch_clips(past, future[:, :num_pred], pred[:, :num_pred],
                                  args.gif_dir, renorm=trainer.renorm,
                                  desc=f"pred_{args.mode}")
            print("wrote GIFs to", args.gif_dir)
    return curves


if __name__ == "__main__":
    main()
