"""Training criterion of the AE, FAR and NAR steps: MSE / L1 / GDL, the
temporal weight, the GAN objective, BiPatchNCE and the Noam schedule, in
PyTorch.

Counterpart of ``vptr_tpu/losses.py:17-142`` (itself the reference's
``model/criterion.py``). Frames are (N, T, H, W, C) like the JAX package's;
every loss is computed in f32 and returns a 0-d f32 tensor. ``gan_loss``
(``losses.py:88-104``) is the GAN steps' objective on discriminator
logits; ``build_optimizer`` lives in ``vptr_tpu_torch.train.optim``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def temporal_weight(t: int, device=None) -> torch.Tensor:
    """Exp-increasing per-timestep weight exp(log(T)/(T-1) * t), (T,) f32;
    w[0] = 1, w[-1] = T (computed in f64 and rounded once, as the JAX
    package does)."""
    if t == 1:
        return torch.ones(1, dtype=torch.float32, device=device)
    w = np.exp(np.log(t) / (t - 1) * np.arange(t, dtype=np.float64))
    return torch.tensor(w, dtype=torch.float32, device=device)


def _l2_normalize(x: torch.Tensor, dim, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) semantics: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def l2_normalize_channels(x: torch.Tensor) -> torch.Tensor:
    """L2-normalise (..., C) features over the channels in f32, the NAR NCE
    pre-processing (reference train_NAR.py:36)."""
    return _l2_normalize(x.float(), -1)


def bi_patch_nce(gt_f: torch.Tensor, pred_f: torch.Tensor,
                 temperature: float = 0.07) -> torch.Tensor:
    """Bidirectional patchwise InfoNCE over the spatial latent patches
    (criterion.py:206-259): gt_f, pred_f (N, T, h, w, C) projected
    features; positives are same-position patches, and the gradient is
    stopped through the negatives (the reference's ``.detach()`` on the
    off-diagonal product)."""
    n, t, h, w, c = gt_f.shape
    gt = gt_f.reshape(n * t, h * w, c).float()
    pr = pred_f.reshape(n * t, h * w, c).float()
    eye = torch.eye(h * w, dtype=torch.float32, device=gt.device)

    def direction(a, b):
        diag = torch.einsum("bpc,bpc->bp", a, b)
        full = torch.einsum("bpc,bqc->bpq", a, b.detach())
        logits = (full * (1.0 - eye) + diag[..., None] * eye) / temperature
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.einsum("bpq,pq->bp", logp, eye))

    return 0.5 * (direction(gt, pr) + direction(pr, gt))


def _weighted_mean(err: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of ``err`` (B, T, ...) with optional per-timestep weights."""
    if weights is not None:
        shape = (1, -1) + (1,) * (err.ndim - 2)
        err = err * weights.reshape(shape).to(err.dtype)
    return err.mean()


def _pair(gt, pred, norm_axis):
    gt, pred = gt.float(), pred.float()
    if norm_axis is not None:
        gt, pred = _l2_normalize(gt, norm_axis), _l2_normalize(pred, norm_axis)
    return gt, pred


def mse_loss(gt, pred, weights=None, norm_axis=None) -> torch.Tensor:
    """Mean squared error (criterion.py:105-132)."""
    gt, pred = _pair(gt, pred, norm_axis)
    return _weighted_mean(torch.square(pred - gt), weights)


def l1_loss(gt, pred, weights=None, norm_axis=None) -> torch.Tensor:
    """Mean absolute error (criterion.py:76-103)."""
    gt, pred = _pair(gt, pred, norm_axis)
    return _weighted_mean(torch.abs(pred - gt), weights)


def gdl_loss(gt, pred, alpha: float = 1.0, weights=None) -> torch.Tensor:
    """Gradient-difference loss on (N, T, H, W, C) frames
    (criterion.py:134-204): |d_H gt - d_H pred|^alpha averaged, plus the
    same for d_W."""
    gt, pred = gt.float(), pred.float()
    gt_dh = torch.abs(gt[..., 1:, :, :] - gt[..., :-1, :, :])
    pr_dh = torch.abs(pred[..., 1:, :, :] - pred[..., :-1, :, :])
    gt_dw = torch.abs(gt[..., :, 1:, :] - gt[..., :, :-1, :])
    pr_dw = torch.abs(pred[..., :, 1:, :] - pred[..., :, :-1, :])
    g1 = torch.abs(gt_dh - pr_dh)
    g2 = torch.abs(gt_dw - pr_dw)
    if alpha != 1.0:
        g1, g2 = torch.pow(g1, alpha), torch.pow(g2, alpha)
    return _weighted_mean(g1, weights) + _weighted_mean(g2, weights)


def gan_loss(logits: torch.Tensor, target_is_real: bool,
             mode: str = "vanilla") -> torch.Tensor:
    """GAN objective on discriminator patch logits (criterion.py:15-74),
    the logits cast to f32 first: vanilla, binary cross-entropy with
    logits against all-1 (real) or all-0 (fake) labels; lsgan, the mean
    squared distance to those labels; wgangp, -mean(logits) for real and
    mean(logits) for fake."""
    logits = logits.float()
    if mode == "vanilla":
        label = torch.ones_like if target_is_real else torch.zeros_like
        return F.binary_cross_entropy_with_logits(logits, label(logits))
    if mode == "lsgan":
        return torch.mean(torch.square(logits - (1.0 if target_is_real else 0.0)))
    if mode == "wgangp":
        return -torch.mean(logits) if target_is_real else torch.mean(logits)
    raise ValueError(f"unknown gan mode {mode!r}")


def noam_schedule(d_model: int, factor: float = 2.0, warmup_steps: int = 4000):
    """Noam warmup: factor * d^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (criterion.py:262-296), as a function of the optimizer's step count
    returning an f32 0-d tensor."""
    def schedule(count: int) -> torch.Tensor:
        step = torch.tensor(float(max(int(count), 1)), dtype=torch.float32)
        return (factor * d_model ** -0.5
                * torch.minimum(step ** -0.5, step * warmup_steps ** -1.5))
    return schedule
