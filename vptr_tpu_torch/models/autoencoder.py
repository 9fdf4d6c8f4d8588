"""Stage-1 ResNet conv autoencoder in PyTorch, train and eval mode.

Counterpart of ``vptr_tpu/models/autoencoder.py:103-305``:

* Encoder: reflect-pad 7x7 conv -> (n_downsampling) stride-2 3x3 convs
  (the last widens to ``feat_dim``) -> residual blocks -> ReLU.
* Decoder: ConvTranspose k3 s2 p1 op1 stages -> reflect-pad 7x7 conv ->
  tanh | sigmoid.
* The stem and head reflect pads are unconditional; ``padding_type``
  switches only the residual blocks.
* Every conv is followed by a :class:`_NormAct` (norm, then ReLU but in
  the second half of a residual block): ``norm`` "batch" (the presets),
  "group" (groups of max(1, C // 32) channels: 32 groups at 64/128/256
  channels, 33 at 528), "instance" (a group a channel, with its affine) or
  "none". The convs have a bias exactly when the norm is "instance".
* Train mode (``module.train()``): BatchNorm normalises with the batch
  statistics and sets running = 0.9 running + 0.1 batch (the biased
  variance; flax's arithmetic, :class:`vptr_tpu_torch.models.layers.
  BatchNorm`); with ``use_dropout`` each residual block drops half of its
  first half's output, the mask drawn from the ``generator`` passed to the
  forward. Eval mode: BatchNorm on its running statistics (eps 1e-5) in one
  f32 ``batch_norm`` call, no dropout.

Public tensors keep the JAX layout (N, T, H, W, C); frames are folded into
the batch and permuted to NCHW only around the convolutions. Module names
mirror the JAX parameter tree (``encoder.stem``, ``encoder.res0.conv1``,
``decoder.up0_na.BatchNorm_0``, ...) so ``vptr_tpu_torch.utils.weights``
maps one onto the other. Parameters are f32; ``dtype`` is the compute
dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vptr_tpu_torch.models.layers import BatchNorm, Dropout, GroupNorm

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


class _BatchNorm(BatchNorm):
    """The flax-semantics :class:`BatchNorm` in train mode; in eval mode one
    f32 ``batch_norm`` call on the running statistics (the frozen AE of the
    stage-2 steps and of the predicts)."""

    def forward(self, x):
        if self.training:
            return super().forward(x)
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.to(self.dtype)


def make_norm(norm: str, channels: int, dtype: torch.dtype):
    """(flax module name, norm module) of the JAX package's norm choices
    (``autoencoder.py:112-123``, ``discriminator.py:35-47``); (None, None)
    for "none"."""
    if norm == "batch":
        return "BatchNorm_0", _BatchNorm(channels, dtype=dtype)
    if norm == "group":
        return "GroupNorm_0", GroupNorm(channels // max(1, channels // 32),
                                        channels, dtype=dtype)
    if norm == "instance":
        return "GroupNorm_0", GroupNorm(channels, channels, dtype=dtype)
    if norm == "none":
        return None, None
    raise ValueError(f"unknown norm {norm!r}")


class _NormAct(nn.Module):
    """norm -> ReLU (``autoencoder.py:103-126``). The norm is a child named
    as flax names it inside the JAX ``_NormAct`` (``BatchNorm_0`` or
    ``GroupNorm_0``; none for "none"), so the parameter paths match."""

    def __init__(self, channels: int, norm: str, dtype: torch.dtype,
                 act: bool = True):
        super().__init__()
        self.act = act
        name, module = make_norm(norm, channels, dtype)
        if module is not None:
            self.add_module(name, module)

    def forward(self, x):
        for norm in self.children():          # at most one
            x = norm(x)
        return F.relu(x) if self.act else x


class ResnetBlock(nn.Module):
    """pad -> 3x3 conv -> norm -> ReLU [-> dropout 0.5] -> pad -> 3x3 conv
    -> norm, + skip."""

    def __init__(self, dim: int, padding_type: str = "reflect",
                 norm: str = "batch", use_dropout: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bias = norm == "instance"
        self.padding_type = padding_type
        self.dtype = dtype
        self.conv1 = nn.Conv2d(dim, dim, 3, bias=bias)
        self.na1 = _NormAct(dim, norm, dtype)
        self.drop = Dropout(0.5 if use_dropout else 0.0)
        self.conv2 = nn.Conv2d(dim, dim, 3, bias=bias)
        self.na2 = _NormAct(dim, norm, dtype, act=False)

    def forward(self, x, generator: Optional[torch.Generator] = None):  # NCHW
        y = self.na1(_conv(self.conv1, _pad2d(x, 1, self.padding_type), self.dtype))
        y = self.drop(y, generator)
        y = _conv(self.conv2, _pad2d(y, 1, self.padding_type), self.dtype)
        return x + self.na2(y)


class ResnetEncoder(nn.Module):
    """(N, C_img, H, W) -> (N, feat_dim, H/2^d, W/2^d), NCHW inside."""

    def __init__(self, img_channels: int = 1, ngf: int = 64,
                 feat_dim: int = 528, n_downsampling: int = 3,
                 n_res_blocks: int = 9, padding_type: str = "reflect",
                 norm: str = "batch", use_dropout: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bias = norm == "instance"
        self.dtype = dtype
        self.n_downsampling = n_downsampling
        self.stem = nn.Conv2d(img_channels, ngf, 7, bias=bias)
        self.stem_na = _NormAct(ngf, norm, dtype)
        ch = ngf
        for i in range(n_downsampling - 1):
            nxt = ngf * 2 ** (i + 1)
            self.add_module(f"down{i}", nn.Conv2d(ch, nxt, 3, 2, 1, bias=bias))
            self.add_module(f"down{i}_na", _NormAct(nxt, norm, dtype))
            ch = nxt
        self.down_last = nn.Conv2d(ch, feat_dim, 3, 2, 1, bias=bias)
        self.down_last_na = _NormAct(feat_dim, norm, dtype)
        self.n_res_blocks = n_res_blocks
        for i in range(n_res_blocks):
            self.add_module(f"res{i}", ResnetBlock(feat_dim, padding_type, norm,
                                                   use_dropout, dtype))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = self.stem_na(_conv(self.stem, _pad2d(x, 3, "reflect"), self.dtype))
        for i in range(self.n_downsampling - 1):
            y = getattr(self, f"down{i}_na")(
                _conv(getattr(self, f"down{i}"), y, self.dtype))
        y = self.down_last_na(_conv(self.down_last, y, self.dtype))
        for i in range(self.n_res_blocks):
            y = getattr(self, f"res{i}")(y, generator)
        return F.relu(y)


class ResnetDecoder(nn.Module):
    """(N, feat_dim, h, w) -> (N, C_img, H, W), NCHW inside."""

    def __init__(self, img_channels: int = 1, ngf: int = 64,
                 feat_dim: int = 528, n_downsampling: int = 3,
                 out_layer: str = "tanh", norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
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
                ch, nxt, 3, 2, 1, output_padding=1, bias=norm == "instance"))
            self.add_module(f"up{i}_na", _NormAct(nxt, norm, dtype))
            ch = nxt
        self.head = nn.Conv2d(ch, img_channels, 7, bias=True)

    def forward(self, x):
        y = x
        for i in range(self.n_downsampling):
            y = getattr(self, f"up{i}_na")(_conv(getattr(self, f"up{i}"), y, self.dtype))
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
                 norm: str = "batch", use_dropout: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResnetEncoder(img_channels, ngf, feat_dim,
                                     n_downsampling, n_res_blocks,
                                     padding_type, norm, use_dropout, dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator``: the dropout masks' source in train mode with
        ``use_dropout`` (required there)."""
        n, t = x.shape[:2]
        return _unfold(self.encoder(_fold(x.to(self.dtype)), generator), n, t)


class VPTRDec(nn.Module):
    """Clip decoder: (N, T, h, w, feat_dim) -> (N, T, H, W, C_img)."""

    def __init__(self, img_channels: int = 1, ngf: int = 64,
                 feat_dim: int = 528, n_downsampling: int = 3,
                 out_layer: str = "tanh", norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.decoder = ResnetDecoder(img_channels, ngf, feat_dim,
                                     n_downsampling, out_layer, norm, dtype)

    def forward(self, feat):
        n, t = feat.shape[:2]
        return _unfold(self.decoder(_fold(feat.to(self.dtype))), n, t)


def init_autoencoder_(module: nn.Module, generator: torch.Generator,
                      init_type: str = "normal", gain: float = 0.02) -> None:
    """The JAX package's init (``make_conv_init``) of a conv net (the
    autoencoder, the discriminator): conv weights N(0, 0.02) (or
    xavier/kaiming/orthogonal), zero biases, norm scale 1 / shift 0,
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
        elif isinstance(m, (BatchNorm, GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def build_autoencoder(cfg, dtype: torch.dtype = torch.float32,
                      device="cuda", generator: Optional[torch.Generator] = None):
    """(VPTREnc, VPTRDec) from an AutoencoderConfig, initialised on the CPU
    from ``generator`` (default seed 0), moved to ``device``, in eval mode."""
    from vptr_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    enc = VPTREnc(cfg.img_channels, cfg.feat_dim, cfg.ngf, cfg.n_downsampling,
                  cfg.n_res_blocks, cfg.padding_type, cfg.norm,
                  cfg.use_dropout, dtype)
    dec = VPTRDec(cfg.img_channels, cfg.ngf, cfg.feat_dim, cfg.n_downsampling,
                  cfg.out_layer, cfg.norm, dtype)
    for m in (enc, dec):
        init_autoencoder_(m, gen, cfg.init_type)
    return enc.to(device).eval(), dec.to(device).eval()
