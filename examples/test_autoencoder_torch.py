"""Stage-1 AE inspection on the PyTorch/CUDA port (vptr_tpu_torch) — the
counterpart of test_autoencoder.py beside it, and of the reference's
Test_AutoEncoder.ipynb: load a checkpoint that ``python -m
vptr_tpu_torch.cli train --preset ae_mnist`` wrote, reconstruct clips of
one test batch in eval mode, print PSNR/SSIM and save a comparison strip.

    python examples/test_autoencoder_torch.py --preset ae_mnist \\
        --ckpt-dir /tmp/ae [--num-frames 20] [--out recon.png]

Runs on the card unless ``--device cpu`` is given. The autoencoder is
convolutions and norms (cuDNN / ATen); it launches none of the port's
kernels. The strip (row 0 the ground truth, row 1 the reconstructions of
the first clip's first 8 frames) is written with PIL; where PIL does not
import, the example says so and writes nothing.
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
    """Run the example; returns what it prints, {"psnr": float, "ssim":
    float}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="ae_mnist")
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--num-frames", type=int, default=20)
    parser.add_argument("--out", default="ae_recon.png")
    parser.add_argument("--set", action="append")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)

    import torch

    from vptr_tpu_torch.cli import _apply_sets
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.eval.metrics import psnr, ssim
    from vptr_tpu_torch.train.checkpoint import CheckpointManager
    from vptr_tpu_torch.train.trainer import Trainer

    cfg = _apply_sets(get_preset(args.preset).override(
        {"ckpt_dir": args.ckpt_dir}), args.set)
    trainer = Trainer(cfg, device=args.device, write_outputs=False)
    ckpt = CheckpointManager(f"{args.ckpt_dir}/ckpt")
    state = ckpt.restore(trainer.init_state())

    loader = build_loader(cfg.data, split="test", seed=cfg.seed)
    with closing(iter(loader)) as batches:
        past, future = next(batches)
    past_d, future_d = trainer.put_batch(past, future)
    x = np.concatenate([past, future], axis=1)[:, :args.num_frames]

    with torch.inference_mode():
        xd = torch.cat([past_d, future_d], dim=1)[:, :args.num_frames]
        rec = state.dec.eval()(state.enc.eval()(xd))
    rec = rec.float().cpu().numpy()

    renorm = trainer.renorm
    x_img = np.clip(renorm(x), 0, 1).astype(np.float32)
    r_img = np.clip(renorm(rec), 0, 1).astype(np.float32)
    t = x_img.shape[1]
    frames = lambda a: torch.from_numpy(a.reshape((-1,) + a.shape[2:]))
    out = {"psnr": float(psnr(frames(r_img), frames(x_img))),
           "ssim": float(ssim(frames(r_img), frames(x_img)))}
    print("reconstruction PSNR:", out["psnr"])
    print("reconstruction SSIM:", out["ssim"])

    # strip image: row 0 = ground truth frames, row 1 = reconstructions
    if importlib.util.find_spec("PIL") is None:
        print(f"PIL does not import, so {args.out} was not written")
        return out
    from PIL import Image

    k = min(8, t)
    gt_row = np.concatenate([x_img[0, i] for i in range(k)], axis=1)
    rc_row = np.concatenate([r_img[0, i] for i in range(k)], axis=1)
    strip = np.concatenate([gt_row, rc_row], axis=0)
    if strip.shape[-1] == 1:
        strip = np.repeat(strip, 3, axis=-1)
    Image.fromarray((strip * 255).astype(np.uint8)).save(args.out)
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
