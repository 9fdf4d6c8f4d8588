"""Test-set evaluation: the prediction entry point and per-timestep metric
curves over a loader.

Counterpart of ``vptr_tpu/eval/harness.py``. :func:`make_predict_fn`
(``:35-70``, what ``python -m vptr_tpu_torch.cli predict`` calls) maps
(past, future) to predicted future frames in one of the rollout modes
(reference: Test_VPTR.ipynb cells 5-11):

* ``far``     — teacher-forced one shot over past + future[:-1];
* ``far_rip`` — autoregressive, pixel-space recurrence (canonical);
* ``far_ril`` — autoregressive, latent recurrence;
* ``nar``     — NAR blocks of Tf frames chained to ``num_pred``.

The modules are passed in (built by ``build_autoencoder`` /
``build_transformer``, restored from a checkpoint, or loaded with
``vptr_tpu_torch.utils.weights``). :func:`evaluate` (``:73-118``, what
``cli eval`` calls; reference ``pred_ave_metrics``, utils/metrics.py:108-137)
rolls a trainer's state out over a loader and averages each metric per
future timestep.
"""

from __future__ import annotations

from itertools import islice
from typing import Dict, Optional

import numpy as np
import torch

from vptr_tpu_torch.eval.metrics import METRIC_FNS

from vptr_tpu_torch.eval.rollout import (
    far_rollout_latent,
    far_rollout_pixel,
    nar_rollout,
)
from vptr_tpu_torch.parallel.mesh import all_reduce_sum
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


def evaluate(trainer, state, loader, *, mode: str = "far",
             num_pred: Optional[int] = None,
             metrics=("psnr", "ssim", "mse"),
             lpips_fn=None, max_batches: Optional[int] = None
             ) -> Dict[str, np.ndarray]:
    """Per-future-timestep metric curves averaged over a loader.

    Returns {metric: (num_pred,) array}. Pixel metrics are computed on
    renormalized frames clipped to [0, 1]; LPIPS on the raw normalized
    frames (gray -> RGB inside), both as the reference notebook does. The
    curves stay on the trainer's device until the loop ends: one read to
    the host for the whole loader, summed in f64 there as the JAX package
    sums them.

    Under W > 1 ranks each rank passes its shard of the loader (batches of
    any size) and the row-weighted sums and the row counts are all-reduced
    in f64 at the end, so every rank returns the curves over all the ranks'
    rows (the JAX package's multi-host evaluate takes them over its global
    arrays)."""
    num_pred = num_pred or trainer.cfg.data.test_future_frames
    predict = make_predict_fn(trainer.cfg, state.enc, state.dec, state.transformer,
                              mode, num_pred, trainer.device)
    names = list(metrics) + (["lpips"] if lpips_fn is not None else [])
    curves, sizes = [], []
    batches = iter(loader)
    try:
        with torch.inference_mode():
            for past, future in islice(batches, max_batches):
                past_d, future_d = trainer.put_batch(past, future, ragged_ok=True)
                pred = predict(past_d, future_d)[:, :num_pred]
                target = future_d[:, :num_pred]
                pr = torch.clamp(trainer.renorm(pred.float()), 0.0, 1.0)
                tr_ = torch.clamp(trainer.renorm(target.float()), 0.0, 1.0)
                rows = [torch.stack([METRIC_FNS[m](pr[:, t], tr_[:, t])
                                     for t in range(num_pred)]) for m in metrics]
                if lpips_fn is not None:
                    rows.append(torch.stack([lpips_fn(pred[:, t], target[:, t]).mean()
                                             for t in range(num_pred)]))
                curves.append(torch.stack(rows))
                sizes.append(past.shape[0])
    finally:
        if hasattr(batches, "close"):       # a loader's iterator: stop its pool
            batches.close()
    sums = np.zeros((len(names), num_pred))
    if curves:
        per_batch = torch.stack(curves).cpu().numpy().astype(np.float64)
        for c, n in zip(per_batch, sizes):
            sums += c * n
    # every rank's sums and rows (a rank without a batch takes part too)
    total = all_reduce_sum(torch.tensor(np.append(sums.ravel(), sum(sizes)),
                                        dtype=torch.float64, device=trainer.device))
    total = total.cpu().numpy()
    count = total[-1]
    if count == 0:
        return {m: np.zeros(num_pred) for m in names}
    return dict(zip(names, total[:-1].reshape(sums.shape) / count))
