"""Inference rollouts: FAR on a fixed ring buffer of Tp + Tf latent slots,
and NAR block chaining.

Counterpart of ``vptr_tpu/eval/rollout.py:37-116``. The FAR context is a
fixed buffer of ``context`` frames, so every transformer call (and so every
kernel launch) sees the same shapes:

* while the buffer is not full, each new latent is written at the next free
  slot (the growing-context phase);
* once full, the buffer shifts left by one frame per step (the sliding
  window).

FAR causality makes this exact: outputs at valid positions never read the
unused tail slots. A Python loop takes the place of ``lax.scan``.
:func:`nar_rollout` chains NAR blocks of Tf predicted latents.
"""

from __future__ import annotations

from typing import Callable

import torch


def _write_frame(buf: torch.Tensor, feat: torch.Tensor, count: int,
                 capacity: int):
    """Append one frame-latent (N, 1, h, w, c) in place; returns the count."""
    if count >= capacity:
        buf[:, :-1] = buf[:, 1:].clone()
        buf[:, capacity - 1:] = feat
    else:
        buf[:, count:count + 1] = feat
    return min(count + 1, capacity)


def _far_rollout(enc_fn, dec_fn, tr_fn, past_frames, num_pred: int,
                 context: int, reencode: bool) -> torch.Tensor:
    feats = enc_fn(past_frames)
    n, tp = feats.shape[:2]
    if tp > context:
        raise ValueError(f"{tp} past frames exceed the {context}-slot context")
    buf = feats.new_zeros((n, context) + feats.shape[2:])
    buf[:, :tp] = feats
    count = tp
    frames = []
    for _ in range(num_pred):
        pred = tr_fn(buf)                        # (N, context, h, w, c)
        last = pred[:, count - 1:count]          # predicts the next frame
        frame = dec_fn(last)                     # (N, 1, H, W, C_img)
        count = _write_frame(buf, enc_fn(frame) if reencode else last,
                             count, context)
        frames.append(frame[:, 0])
    return torch.stack(frames, dim=1)            # (N, num_pred, H, W, C)


def far_rollout_pixel(enc_fn: Callable, dec_fn: Callable, tr_fn: Callable,
                      past_frames: torch.Tensor, num_pred: int,
                      context: int) -> torch.Tensor:
    """FAR-RIP: decode each prediction to pixels and re-encode it."""
    return _far_rollout(enc_fn, dec_fn, tr_fn, past_frames, num_pred,
                        context, reencode=True)


def far_rollout_latent(enc_fn: Callable, dec_fn: Callable, tr_fn: Callable,
                       past_frames: torch.Tensor, num_pred: int,
                       context: int) -> torch.Tensor:
    """FAR-RIL: feed the predicted latents straight back."""
    return _far_rollout(enc_fn, dec_fn, tr_fn, past_frames, num_pred,
                        context, reencode=False)


def nar_rollout(enc_fn: Callable, dec_fn: Callable, tr_fn: Callable,
                past_frames: torch.Tensor, num_pred: int,
                num_future: int) -> torch.Tensor:
    """Chain NAR blocks (``rollout.py:90-116``): each call predicts
    ``num_future`` latents from a context of the last Tp latents of (past +
    predictions); the first ``num_pred`` predicted latents are decoded in
    one call. Returns (N, num_pred, H, W, C)."""
    context = enc_fn(past_frames)
    tp = context.shape[1]
    preds = []
    for _ in range(-(-num_pred // num_future)):
        pred = tr_fn(context)                    # (N, Tf, h, w, c)
        preds.append(pred)
        context = torch.cat([context, pred], dim=1)[:, -tp:]
    return dec_fn(torch.cat(preds, dim=1)[:, :num_pred])
