"""Image quality metrics: PSNR / MSE / SSIM (+ per-timestep curves), as f32
tensor functions that run where their inputs are.

Counterpart of ``vptr_tpu/eval/metrics.py`` (reference: utils/metrics.py):
PSNR = mean over batch of -10*log10(per-image MSE + 1e-8); SSIM uses an
11x11 sigma-1.5 Gaussian window with same-padding depthwise convolution.
Channels-last (N, H, W, C). The SSIM convolutions run with TF32 off: on
the card cuDNN may otherwise round their f32 operands to TF32 (10 mantissa
bits), where the JAX package computes them in full f32.
"""

from __future__ import annotations

from contextlib import contextmanager
from math import exp

import numpy as np
import torch
import torch.nn.functional as F


def psnr(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Batch-average PSNR (reference: utils/metrics.py:12-28)."""
    x = x.float() / data_range
    y = y.float() / data_range
    mse = torch.mean(torch.square(x - y), dim=(1, 2, 3))
    return torch.mean(-10.0 * torch.log10(mse + 1e-8))


def mse_score(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batch-average per-image summed squared error
    (reference: utils/metrics.py:30-40)."""
    se = torch.sum(torch.square(x.float() - y.float()), dim=(1, 2, 3))
    return torch.mean(se)


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    g = np.array([exp(-(i - size // 2) ** 2 / (2.0 * sigma ** 2))
                  for i in range(size)])
    g = g / g.sum()
    return np.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """Structural similarity (reference: utils/metrics.py:43-106).

    Depthwise same-padded Gaussian filtering; C1=0.01^2, C2=0.03^2.
    """
    img1 = img1.float().permute(0, 3, 1, 2)
    img2 = img2.float().permute(0, 3, 1, 2)
    c = img1.shape[1]
    w2d = torch.from_numpy(_gaussian_window(window_size, sigma)).float()
    kernel = w2d.to(img1.device).expand(c, 1, window_size, window_size)
    pad = window_size // 2

    def conv(x):
        return F.conv2d(x, kernel, padding=pad, groups=c)

    with _full_f32():
        mu1 = conv(img1)
        mu2 = conv(img2)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = conv(img1 * img1) - mu1_sq
        sigma2_sq = conv(img2 * img2) - mu2_sq
        sigma12 = conv(img1 * img2) - mu1_mu2

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))


@contextmanager
def _full_f32():
    """cuDNN convolutions without TF32 inside (the flag is restored on
    exit)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


METRIC_FNS = {"psnr": psnr, "ssim": ssim, "mse": mse_score}


def per_timestep_metrics(pred: torch.Tensor, target: torch.Tensor,
                         metric: str = "psnr", renorm=None) -> torch.Tensor:
    """Per-future-timestep metric curve over (N, T, H, W, C) clips —
    the reference's ``pred_ave_metrics`` inner loop
    (reference: utils/metrics.py:108-137). Returns shape (T,)."""
    fn = METRIC_FNS[metric]
    if renorm is not None:
        pred = renorm(pred)
        target = renorm(target)
    return torch.stack([fn(pred[:, t], target[:, t]) for t in range(pred.shape[1])])
