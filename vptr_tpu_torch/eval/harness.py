"""Prediction entry point: (past, future) -> predicted future frames.

Counterpart of ``vptr_tpu/eval/harness.py:35-70`` (``make_predict_fn``, the
function ``python -m vptr_tpu.cli predict`` calls):

* ``far``     — teacher-forced one shot over past + future[:-1];
* ``far_rip`` — autoregressive, pixel-space recurrence (canonical);
* ``far_ril`` — autoregressive, latent recurrence;
* ``nar``     — NAR blocks of Tf frames chained to ``num_pred``.

The modules are passed in (built by ``build_autoencoder`` /
``build_transformer``, or loaded with ``vptr_tpu_torch.utils.weights``).
The metric loop, the CLI and checkpoints come with later slices.
"""

from __future__ import annotations

import torch

from vptr_tpu_torch.eval.rollout import (
    far_rollout_latent,
    far_rollout_pixel,
    nar_rollout,
)
from vptr_tpu_torch.utils.device import resolve_device

ROLLOUT_MODES = ("far", "far_rip", "far_ril", "nar")


def make_predict_fn(cfg, enc, dec, transformer, mode: str, num_pred: int,
                    device="cuda"):
    """Return ``predict(past, future=None)``: frames (N, T, H, W, C) as numpy
    arrays or tensors in, predictions (N, num_pred, H, W, C) on ``device``
    in the compute dtype out. ``future`` is needed by ``far`` only."""
    device = resolve_device(device)
    if mode not in ROLLOUT_MODES:
        raise ValueError(f"unknown rollout mode {mode!r}; choose from "
                         f"{ROLLOUT_MODES}")
    tcfg = cfg.transformer
    context = tcfg.num_past_frames + tcfg.num_future_frames
    for name, m in (("enc", enc), ("dec", dec), ("transformer", transformer)):
        p = next(m.parameters())
        if p.device != device:
            raise ValueError(f"{name} is on {p.device}, predict runs on {device}")

    def as_input(frames):
        return torch.as_tensor(frames).to(device=device, dtype=enc.dtype)

    @torch.inference_mode()
    def predict(past, future=None):
        for m in (enc, dec, transformer):   # a train step may run in between
            if m.training:
                m.eval()
        past = as_input(past)
        if mode == "far":
            if future is None:
                raise ValueError("mode 'far' needs the future frames")
            future = as_input(future)
            x = torch.cat([past, future[:, :-1]], dim=1)
            return dec(transformer(enc(x)))[:, -future.shape[1]:]
        if mode == "nar":
            return nar_rollout(enc, dec, transformer, past, num_pred,
                               tcfg.num_future_frames)
        rollout = far_rollout_pixel if mode == "far_rip" else far_rollout_latent
        return rollout(enc, dec, transformer, past, num_pred, context)

    return predict
