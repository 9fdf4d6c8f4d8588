"""PatchGAN discriminator of the GAN steps, in PyTorch.

Counterpart of ``vptr_tpu/models/discriminator.py:20-71`` (the reference's
``model/VPTR_modules.py:49-95``): ``conv0`` (4x4, stride 2, bias) ->
LeakyReLU(0.2), then ``conv{n}`` (4x4, stride 2) -> ``norm{n}`` ->
LeakyReLU for n = 1 .. n_layers - 1, ``conv{n_layers}`` (4x4, stride 1) ->
``norm{n_layers}`` -> LeakyReLU, and ``head`` (4x4, stride 1, bias) to one
logit a patch; every conv pads 1, channels ``ndf * min(2^n, 8)``. The
middle convs have a bias only with the "instance" norm. Norms: "batch",
"group", "instance", as the autoencoder's
(:func:`vptr_tpu_torch.models.autoencoder.make_norm`; train-mode BatchNorm
with flax's arithmetic and running statistics). Module names mirror the
JAX parameter tree.

Frames are channels-last, (N, H, W, C) -> (N, h', w', 1), as the JAX
module takes them; NCHW inside. Parameters are f32, ``dtype`` is the
compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vptr_tpu_torch.models.autoencoder import _conv, init_autoencoder_, make_norm


def _norm(norm: str, channels: int, dtype: torch.dtype) -> nn.Module:
    """The AE's norm of that kind (named ``norm{n}`` here, no flax wrapper);
    the JAX discriminator has no "none"."""
    module = make_norm(norm, channels, dtype)[1]
    if module is None:
        raise ValueError(f"unknown norm {norm!r}")
    return module


class PatchDiscriminator(nn.Module):
    """(N, H, W, C_img) frames -> (N, h', w', 1) patch logits."""

    def __init__(self, img_channels: int = 1, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        bias = norm == "instance"
        self.dtype = dtype
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(img_channels, ndf, 4, 2, 1)
        ch = ndf
        for n in range(1, n_layers + 1):
            nxt = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv{n}", nn.Conv2d(ch, nxt, 4, stride, 1, bias=bias))
            self.add_module(f"norm{n}", _norm(norm, nxt, dtype))
            ch = nxt
        self.head = nn.Conv2d(ch, 1, 4, 1, 1)

    def forward(self, x):
        y = F.leaky_relu(_conv(self.conv0, x.permute(0, 3, 1, 2).to(self.dtype),
                               self.dtype), 0.2)
        for n in range(1, self.n_layers + 1):
            y = _conv(getattr(self, f"conv{n}"), y, self.dtype)
            y = F.leaky_relu(getattr(self, f"norm{n}")(y), 0.2)
        return _conv(self.head, y, self.dtype).permute(0, 2, 3, 1)


def build_discriminator(cfg, dtype: torch.dtype = torch.float32, device="cuda",
                        generator: Optional[torch.Generator] = None):
    """PatchDiscriminator from a DiscriminatorConfig, initialised on the CPU
    from ``generator`` (default seed 0) as the autoencoder is
    (:func:`init_autoencoder_`), moved to ``device``, in eval mode."""
    from vptr_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    disc = PatchDiscriminator(cfg.img_channels, cfg.ndf, cfg.n_layers, cfg.norm,
                              dtype)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    init_autoencoder_(disc, gen, cfg.init_type)
    return disc.to(device).eval()
