"""Stage-1 ResNet conv autoencoder (eval-mode forward) in PyTorch.

Counterpart of ``vptr_tpu/models/autoencoder.py:129-305``:

* Encoder: reflect-pad 7x7 conv -> (n_downsampling) stride-2 3x3 convs
  (the last widens to ``feat_dim``) -> residual blocks -> ReLU.
* Decoder: ConvTranspose k3 s2 p1 op1 stages -> reflect-pad 7x7 conv ->
  tanh | sigmoid.
* The stem and head reflect pads are unconditional; ``padding_type``
  switches only the residual blocks.
* BatchNorm runs on its running statistics (eps 1e-5).

Public tensors keep the JAX layout (N, T, H, W, C); frames are folded into
the batch and permuted to NCHW only around the convolutions. Module names
mirror the JAX parameter tree (``encoder.stem``, ``encoder.res0.conv1``,
``decoder.up0_na``, ...) so ``vptr_tpu_torch.utils.weights`` maps one onto
the other. Parameters are f32; ``dtype`` is the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_PAD_MODES = {"reflect": "reflect", "replicate": "replicate", "zero": "constant"}


def _pad2d(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    if mode not in _PAD_MODES:
        raise ValueError(f"unknown padding mode {mode!r}")
    return F.pad(x, (pad, pad, pad, pad), mode=_PAD_MODES[mode])


def _conv(conv: nn.Conv2d | nn.ConvTranspose2d, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Run a conv in ``dtype`` (weights cast per call, params stay f32)."""
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, conv.stride, conv.padding,
                                  conv.output_padding)
    return F.conv2d(x, w, b, conv.stride, conv.padding)


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm: f32 arithmetic, result in x's dtype."""
    y = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                     bn.bias, False, 0.0, bn.eps)
    return y.to(x.dtype)


def _check_norm(norm: str) -> None:
    if norm != "batch":
        raise NotImplementedError(
            f"autoencoder norm={norm!r}: the port has BatchNorm only (the "
            "shipped presets); group/instance norm come with the AE slice")


class ResnetBlock(nn.Module):
    """pad -> 3x3 conv -> BN -> ReLU -> pad -> 3x3 conv -> BN, + skip."""

    def __init__(self, dim: int, padding_type: str = "reflect",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.padding_type = padding_type
        self.dtype = dtype
        self.conv1 = nn.Conv2d(dim, dim, 3, bias=False)
        self.na1 = nn.BatchNorm2d(dim, eps=1e-5)
        self.conv2 = nn.Conv2d(dim, dim, 3, bias=False)
        self.na2 = nn.BatchNorm2d(dim, eps=1e-5)

    def forward(self, x):  # NCHW
        y = _conv(self.conv1, _pad2d(x, 1, self.padding_type), self.dtype)
        y = F.relu(_bn(self.na1, y))
        y = _conv(self.conv2, _pad2d(y, 1, self.padding_type), self.dtype)
        return x + _bn(self.na2, y)


class ResnetEncoder(nn.Module):
    """(N, C_img, H, W) -> (N, feat_dim, H/2^d, W/2^d), NCHW inside."""

    def __init__(self, img_channels: int = 1, ngf: int = 64,
                 feat_dim: int = 528, n_downsampling: int = 3,
                 n_res_blocks: int = 9, padding_type: str = "reflect",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_downsampling = n_downsampling
        self.stem = nn.Conv2d(img_channels, ngf, 7, bias=False)
        self.stem_na = nn.BatchNorm2d(ngf, eps=1e-5)
        ch = ngf
        for i in range(n_downsampling - 1):
            nxt = ngf * 2 ** (i + 1)
            self.add_module(f"down{i}", nn.Conv2d(ch, nxt, 3, 2, 1, bias=False))
            self.add_module(f"down{i}_na", nn.BatchNorm2d(nxt, eps=1e-5))
            ch = nxt
        self.down_last = nn.Conv2d(ch, feat_dim, 3, 2, 1, bias=False)
        self.down_last_na = nn.BatchNorm2d(feat_dim, eps=1e-5)
        self.n_res_blocks = n_res_blocks
        for i in range(n_res_blocks):
            self.add_module(f"res{i}", ResnetBlock(feat_dim, padding_type, dtype))

    def forward(self, x):
        y = _conv(self.stem, _pad2d(x, 3, "reflect"), self.dtype)
        y = F.relu(_bn(self.stem_na, y))
        for i in range(self.n_downsampling - 1):
            y = _conv(getattr(self, f"down{i}"), y, self.dtype)
            y = F.relu(_bn(getattr(self, f"down{i}_na"), y))
        y = F.relu(_bn(self.down_last_na, _conv(self.down_last, y, self.dtype)))
        for i in range(self.n_res_blocks):
            y = getattr(self, f"res{i}")(y)
        return F.relu(y)


class ResnetDecoder(nn.Module):
    """(N, feat_dim, h, w) -> (N, C_img, H, W), NCHW inside."""

    def __init__(self, img_channels: int = 1, ngf: int = 64,
                 feat_dim: int = 528, n_downsampling: int = 3,
                 out_layer: str = "tanh", dtype: torch.dtype = torch.float32):
        super().__init__()
        if out_layer not in ("tanh", "sigmoid"):
            raise ValueError(f"unsupported out_layer {out_layer!r}")
        self.dtype = dtype
        self.out_layer = out_layer
        self.n_downsampling = n_downsampling
        ch = feat_dim
        for i in range(n_downsampling):
            nxt = int(ngf * 2 ** (n_downsampling - i) / 2)
            self.add_module(f"up{i}", nn.ConvTranspose2d(
                ch, nxt, 3, 2, 1, output_padding=1, bias=False))
            self.add_module(f"up{i}_na", nn.BatchNorm2d(nxt, eps=1e-5))
            ch = nxt
        self.head = nn.Conv2d(ch, img_channels, 7, bias=True)

    def forward(self, x):
        y = x
        for i in range(self.n_downsampling):
            y = _conv(getattr(self, f"up{i}"), y, self.dtype)
            y = F.relu(_bn(getattr(self, f"up{i}_na"), y))
        y = _conv(self.head, _pad2d(y, 3, "reflect"), self.dtype)
        return torch.tanh(y) if self.out_layer == "tanh" else torch.sigmoid(y)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) -> (N*T, C, H, W)."""
    n, t, h, w, c = x.shape
    return x.reshape(n * t, h, w, c).permute(0, 3, 1, 2)


def _unfold(y: torch.Tensor, n: int, t: int) -> torch.Tensor:
    """(N*T, C, H, W) -> (N, T, H, W, C), contiguous."""
    return y.permute(0, 2, 3, 1).reshape((n, t) + y.shape[2:] + y.shape[1:2])


class VPTREnc(nn.Module):
    """Clip encoder: (N, T, H, W, C_img) -> (N, T, h, w, feat_dim)."""

    def __init__(self, img_channels: int = 1, feat_dim: int = 528,
                 ngf: int = 64, n_downsampling: int = 3,
                 n_res_blocks: int = 9, padding_type: str = "reflect",
                 norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_norm(norm)
        self.dtype = dtype
        self.encoder = ResnetEncoder(img_channels, ngf, feat_dim,
                                     n_downsampling, n_res_blocks,
                                     padding_type, dtype)

    def forward(self, x):
        n, t = x.shape[:2]
        return _unfold(self.encoder(_fold(x.to(self.dtype))), n, t)


class VPTRDec(nn.Module):
    """Clip decoder: (N, T, h, w, feat_dim) -> (N, T, H, W, C_img)."""

    def __init__(self, img_channels: int = 1, ngf: int = 64,
                 feat_dim: int = 528, n_downsampling: int = 3,
                 out_layer: str = "tanh", norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_norm(norm)
        self.dtype = dtype
        self.decoder = ResnetDecoder(img_channels, ngf, feat_dim,
                                     n_downsampling, out_layer, dtype)

    def forward(self, feat):
        n, t = feat.shape[:2]
        return _unfold(self.decoder(_fold(feat.to(self.dtype))), n, t)


def init_autoencoder_(module: nn.Module, generator: torch.Generator,
                      init_type: str = "normal", gain: float = 0.02) -> None:
    """The JAX package's init (``make_conv_init``): conv weights N(0, 0.02)
    (or xavier/kaiming/orthogonal), zero biases, BN scale 1 / shift 0,
    running statistics 0 / 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            if init_type == "normal":
                nn.init.normal_(m.weight, 0.0, gain, generator=generator)
            elif init_type == "xavier":
                nn.init.xavier_normal_(m.weight, gain, generator=generator)
            elif init_type == "kaiming":
                nn.init.kaiming_normal_(m.weight, 0, "fan_in",
                                        generator=generator)
            elif init_type == "orthogonal":
                nn.init.orthogonal_(m.weight, gain, generator=generator)
            else:
                raise ValueError(f"unknown init type {init_type!r}")
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def build_autoencoder(cfg, dtype: torch.dtype = torch.float32,
                      device="cuda", generator: Optional[torch.Generator] = None):
    """(VPTREnc, VPTRDec) from an AutoencoderConfig, initialised on the CPU
    from ``generator`` (default seed 0), moved to ``device``, in eval mode."""
    from vptr_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if cfg.use_dropout:
        raise NotImplementedError("AE use_dropout is a training option; it "
                                  "comes with the AE slice")
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    enc = VPTREnc(cfg.img_channels, cfg.feat_dim, cfg.ngf, cfg.n_downsampling,
                  cfg.n_res_blocks, cfg.padding_type, cfg.norm, dtype)
    dec = VPTRDec(cfg.img_channels, cfg.ngf, cfg.feat_dim, cfg.n_downsampling,
                  cfg.out_layer, cfg.norm, dtype)
    for m in (enc, dec):
        init_autoencoder_(m, gen, cfg.init_type)
    return enc.to(device).eval(), dec.to(device).eval()
