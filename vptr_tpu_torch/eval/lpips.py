"""LPIPS perceptual metric (AlexNet backbone).

Counterpart of ``vptr_tpu/eval/lpips.py`` (the reference computes LPIPS
only in its eval notebook via the pip ``lpips`` package, Test_VPTR.ipynb
cell 9, gray->3-channel repeat):

* AlexNet conv trunk (5 feature taps), inputs scaled to [-1, 1] then
  channel-normalized with the ImageNet shift/scale the metric defines;
* unit-normalize each tap over channels, squared difference;
* 1x1 non-negative linear head per tap, spatial mean, sum over taps.

Weights load from the same local ``.npz`` as the JAX package's
(``alex/conv{i}/kernel`` HWIO, ``alex/conv{i}/bias``, ``lin{i}``; written
by ``scripts/export_lpips.py``). Without a weights file
:func:`make_lpips_fn` returns None.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# channel normalization from the LPIPS definition
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_ALEX_CFG = (
    # (features, kernel, stride, padding)
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_MAXPOOL_AFTER = {0, 1}   # pool after taps 0 and 1 (AlexNet features layout)


class AlexNetFeatures(nn.Module):
    """AlexNet conv trunk returning the 5 LPIPS feature taps, NCHW."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for i, (feat, k, s, p) in enumerate(_ALEX_CFG):
            self.add_module(f"conv{i}", nn.Conv2d(in_ch, feat, k, s, p))
            in_ch = feat

    def forward(self, x):
        taps = []
        for i in range(len(_ALEX_CFG)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            taps.append(x)
            if i in _MAXPOOL_AFTER:
                x = F.max_pool2d(x, 3, stride=2)
        return taps


class LPIPS(nn.Module):
    """Full LPIPS head. Input frames in [0, 1], NHWC, 1 or 3 channels;
    returns (N,)."""

    def __init__(self):
        super().__init__()
        self.alex = AlexNetFeatures()
        for i, (feat, _, _, _) in enumerate(_ALEX_CFG):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(feat)))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))

    def _prep(self, img):
        img = img.float().permute(0, 3, 1, 2)
        if img.shape[1] == 1:           # gray -> RGB repeat (notebook parity)
            img = img.repeat(1, 3, 1, 1)
        img = img * 2.0 - 1.0           # [0,1] -> [-1,1]
        return (img - self.shift) / self.scale

    def forward(self, img1, img2):
        def unit_norm(f):
            return f * torch.rsqrt(torch.sum(torch.square(f), dim=1, keepdim=True)
                                   + 1e-10)

        total = 0.0
        for i, (f1, f2) in enumerate(zip(self.alex(self._prep(img1)),
                                         self.alex(self._prep(img2)))):
            diff = torch.square(unit_norm(f1) - unit_norm(f2))
            w = torch.abs(getattr(self, f"lin{i}")).view(1, -1, 1, 1)
            score = torch.sum(diff * w, dim=1)            # (N, h, w)
            total = total + torch.mean(score, dim=(1, 2))  # spatial mean
        return total


def default_weights() -> str:
    """``VPTR_LPIPS_WEIGHTS``, else ``lpips_alex.npz`` beside this module."""
    return os.environ.get("VPTR_LPIPS_WEIGHTS",
                          str(Path(__file__).parent / "lpips_alex.npz"))


def load_weights(path: Optional[str] = None):
    """An :class:`LPIPS` (on the CPU, eval mode) with the weights of an
    .npz of flat names: ``alex/conv{i}/kernel`` (HWIO),
    ``alex/conv{i}/bias``, ``lin{i}``; None when the file is absent."""
    path = path or default_weights()
    if not Path(path).exists():
        return None
    flat = np.load(path)
    model = LPIPS()
    with torch.no_grad():
        for i in range(len(_ALEX_CFG)):
            conv = getattr(model.alex, f"conv{i}")
            conv.weight.copy_(torch.from_numpy(
                np.ascontiguousarray(flat[f"alex/conv{i}/kernel"].transpose(3, 2, 0, 1))))
            conv.bias.copy_(torch.from_numpy(flat[f"alex/conv{i}/bias"]))
            getattr(model, f"lin{i}").copy_(torch.from_numpy(flat[f"lin{i}"]))
    return model.eval().requires_grad_(False)


def lpips_available(path: Optional[str] = None) -> bool:
    return Path(path or default_weights()).exists()


def make_lpips_fn(weights_path: Optional[str] = None, device="cuda"):
    """Returns an (img1, img2) -> (N,) LPIPS function on ``device`` (full
    f32: TF32 off in its convolutions), or None when no pretrained weights
    exist."""
    from vptr_tpu_torch.eval.metrics import _full_f32
    from vptr_tpu_torch.utils.device import resolve_device

    model = load_weights(weights_path)
    if model is None:
        return None
    model = model.to(resolve_device(device))

    @torch.no_grad()
    def fn(img1, img2):
        with _full_f32():
            return model(img1, img2)

    return fn
