"""Observability: TensorBoard scalars, epoch GIF dumps, structured logging.

The port's copy of ``vptr_tpu/train/summary.py``: the same files
(``train_log.log``, ``tb/scalars.jsonl``, ``<desc>_<i>.gif``); tensorboardX
is used only where it imports, PIL only when GIFs are written.

Parity targets (reference: utils/train_summary.py):
* ``write_summary`` — per-loss train/val scalar curves (:118-128);
* ``visualize_batch_clips`` — side-by-side (past | gt-future | pred) animated
  GIFs, renormalized and clamped (:162-198);
* python logging to ``train_log.log`` in the ckpt dir (train_FAR.py:148-152).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict

import numpy as np


def setup_logging(ckpt_dir: str, name: str = "vptr_tpu_torch") -> logging.Logger:
    """The named logger, writing to ``<ckpt_dir>/train_log.log`` and to
    stderr. A later call with another ``ckpt_dir`` (a second run in one
    process) moves the file handler there."""
    Path(ckpt_dir).mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    path = os.path.abspath(Path(ckpt_dir) / "train_log.log")
    files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
    for h in files:
        if h.baseFilename != path:
            logger.removeHandler(h)
            h.close()
    if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter("%(asctime)s - %(message)s",
                                          datefmt="%a, %d %b %Y %H:%M:%S"))
        logger.addHandler(fh)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(sh)
    return logger


class SummaryWriter:
    """Thin tensorboardX wrapper; degrades to JSONL when TB is unavailable."""

    def __init__(self, log_dir: str):
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self._jsonl = Path(log_dir) / "scalars.jsonl"
        try:
            from tensorboardX import SummaryWriter as TBWriter

            self._tb = TBWriter(log_dir)
        except ImportError:
            self._tb = None

    def write_scalars(self, step: int, scalars: Dict[str, float],
                      prefix: str = ""):
        import json

        payload = {f"{prefix}{k}": float(v) for k, v in scalars.items()}
        with self._jsonl.open("a") as f:
            f.write(json.dumps({"step": step, **payload}) + "\n")
        if self._tb is not None:
            for k, v in payload.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()


def _to_uint8(clip: np.ndarray, renorm=None) -> np.ndarray:
    """(T, H, W, C) float -> uint8, renormalized + clamped to [0, 1]
    (reference: utils/train_summary.py:173-180)."""
    clip = np.asarray(clip, np.float32)
    if renorm is not None:
        clip = np.asarray(renorm(clip), np.float32)
    clip = np.clip(clip, 0.0, 1.0)
    return (clip * 255).astype(np.uint8)


def visualize_batch_clips(past: np.ndarray, future_gt: np.ndarray,
                          future_pred: np.ndarray, save_dir: str,
                          renorm=None, desc: str = "clip",
                          max_samples: int = 4):
    """Save animated GIFs: for each sample, frames play through
    past -> gt-future and past -> pred-future side by side
    (reference: utils/train_summary.py:162-198). Inputs (N, T, H, W, C)."""
    from PIL import Image

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    n = min(past.shape[0], max_samples)
    for i in range(n):
        gt_seq = np.concatenate([_to_uint8(past[i], renorm),
                                 _to_uint8(future_gt[i], renorm)], axis=0)
        pr_seq = np.concatenate([_to_uint8(past[i], renorm),
                                 _to_uint8(future_pred[i], renorm)], axis=0)
        frames = []
        for t in range(gt_seq.shape[0]):
            row = np.concatenate([gt_seq[t], pr_seq[t]], axis=1)  # side/side
            if row.shape[-1] == 1:
                row = np.repeat(row, 3, axis=-1)
            frames.append(Image.fromarray(row))
        frames[0].save(save_dir / f"{desc}_{i}.gif", save_all=True,
                       append_images=frames[1:], duration=100, loop=0)
