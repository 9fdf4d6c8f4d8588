"""PyTorch re-derivations of the reference VPTR modules, and reference-format
checkpoint files built from them -- NOT a test module (no ``test_``
prefix; pytest does not collect it).

The modules are ``tests/test_torch_parity.py``'s (``TorchVPTREnc`` ...
``TorchNAR``, lines 77-420) and ``tests/test_train_parity.py``'s
``TorchVPTRDisc`` (line 318), taken as they are: the reference's
architecture built from its documented behaviour, with the reference's
``state_dict`` key names. This file imports torch and numpy only (no JAX,
nothing of either package), so the port's CPU tests and ``chip_smoke.py``
on the card both use it. The positions are arguments: callers pass the
port's (``vptr_tpu_torch.models.position``) or the JAX package's tables.

:func:`write_reference_tar` writes an ``epoch_N.tar`` in the reference's
``save_ckpt`` envelope (utils/train_summary.py:130-149): ``epoch``, a
``loss_dict`` whose class cannot be imported when the file is read, a real
``optimizer_state_dict``, the ``code`` byte snapshot, and, where asked,
DataParallel's ``module.`` key prefix.
"""

from __future__ import annotations

import sys
import types

import torch
import torch.nn as nn
import torch.nn.functional as F


def randomize_bn(module: nn.Module, generator: torch.Generator = None) -> None:
    """Random (not default) BatchNorm affine + running stats, so the import
    of every buffer is exercised in eval mode."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5, generator=generator)
                m.bias.uniform_(-0.3, 0.3, generator=generator)
                m.running_mean.uniform_(-0.2, 0.2, generator=generator)
                m.running_var.uniform_(0.5, 1.5, generator=generator)


def state_numpy(module: nn.Module) -> dict:
    """The module's state_dict as numpy copies (not views of its storage)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# conv autoencoder (ResNetAutoEncoder.py:8-101)
# ---------------------------------------------------------------------------

class TorchResnetBlock(nn.Module):
    def __init__(self, dim, padding_type="reflect"):
        super().__init__()
        pad = ([nn.ReflectionPad2d(1)] if padding_type == "reflect" else [])
        p = 0 if padding_type == "reflect" else 1
        self.conv_block = nn.Sequential(
            *pad, nn.Conv2d(dim, dim, 3, padding=p, bias=False),
            nn.BatchNorm2d(dim), nn.ReLU(True),
            *pad, nn.Conv2d(dim, dim, 3, padding=p, bias=False),
            nn.BatchNorm2d(dim))

    def forward(self, x):
        return x + self.conv_block(x)


class TorchVPTREnc(nn.Module):
    def __init__(self, img_ch=1, ngf=64, feat_dim=528, nd=3, n_res=9,
                 padding_type="reflect"):
        super().__init__()
        layers = [nn.ReflectionPad2d(3),
                  nn.Conv2d(img_ch, ngf, 7, bias=False),
                  nn.BatchNorm2d(ngf), nn.ReLU(True)]
        for i in range(nd - 1):
            mult = 2 ** i
            layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                                 padding=1, bias=False),
                       nn.BatchNorm2d(ngf * mult * 2), nn.ReLU(True)]
        layers += [nn.Conv2d(ngf * 2 ** (nd - 1), feat_dim, 3, stride=2,
                             padding=1, bias=False),
                   nn.BatchNorm2d(feat_dim), nn.ReLU(True)]
        layers += [TorchResnetBlock(feat_dim, padding_type) for _ in range(n_res)]
        layers += [nn.ReLU()]
        self.encoder = nn.Module()
        self.encoder.model = nn.Sequential(*layers)

    def forward(self, x):  # (N*T, C, H, W)
        return self.encoder.model(x)


class TorchVPTRDec(nn.Module):
    def __init__(self, img_ch=1, ngf=64, feat_dim=528, nd=3,
                 out_layer="Sigmoid"):
        super().__init__()
        layers = []
        ch_in = feat_dim
        for i in range(nd):
            mult = 2 ** (nd - i)
            ch_out = int(ngf * mult / 2)
            layers += [nn.ConvTranspose2d(ch_in, ch_out, 3, stride=2,
                                          padding=1, output_padding=1,
                                          bias=False),
                       nn.BatchNorm2d(ch_out), nn.ReLU(True)]
            ch_in = ch_out
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, img_ch, 7),
                   nn.Sigmoid() if out_layer == "Sigmoid" else nn.Tanh()]
        self.decoder = nn.Module()
        self.decoder.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.decoder.model(x)


def encode_clips(tenc: nn.Module, frames: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) frames -> (N, T, h, w, feat) latents."""
    n, t = frames.shape[:2]
    y = tenc(frames.flatten(0, 1).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).reshape(n, t, *y.shape[2:], y.shape[1])


def decode_clips(tdec: nn.Module, feats: torch.Tensor) -> torch.Tensor:
    """(N, T, h, w, feat) latents -> (N, T, H, W, C) frames."""
    n, t = feats.shape[:2]
    y = tdec(feats.flatten(0, 1).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).reshape(n, t, *y.shape[2:], y.shape[1])


# ---------------------------------------------------------------------------
# VidHRFormer (VidHRFormer_modules.py:30-211)
# ---------------------------------------------------------------------------

def _win_permute(x, win):
    """einops 'n (qh ph) (qw pw) c -> (ph pw) (n qh qw) c'."""
    n, h, w, c = x.shape
    qh, qw = h // win, w // win
    x = x.view(n, qh, win, qw, win, c)
    x = x.permute(2, 4, 0, 1, 3, 5).reshape(win * win, n * qh * qw, c)
    return x


def _win_reverse(x, win, n, h, w):
    c = x.shape[-1]
    qh, qw = h // win, w // win
    x = x.view(win, win, n, qh, qw, c)
    x = x.permute(2, 3, 0, 4, 1, 5).reshape(n, h, w, c)
    return x


class TorchSLMHSA(nn.Module):
    """SpatialLocalMultiheadAttention re-derivation
    (VidHRFormer_modules.py:287-357 + MultiHeadAttentionRPE.py)."""

    def __init__(self, dim, heads, win, rpe):
        super().__init__()
        self.dim, self.heads, self.win, self.rpe = dim, heads, win, rpe
        if rpe:
            attn = nn.Module()
            attn.q_proj = nn.Linear(dim, dim)
            attn.k_proj = nn.Linear(dim, dim)
            attn.v_proj = nn.Linear(dim, dim)
            attn.out_proj = nn.Linear(dim, dim)
            attn.relative_position_bias_table = nn.Parameter(
                torch.randn((2 * win - 1) ** 2, heads) * 0.02)
            self.attn = attn
            # Swin-style relative index (MultiHeadAttentionRPE.py:373-387)
            coords = torch.stack(torch.meshgrid(
                torch.arange(win), torch.arange(win), indexing="ij"))
            flat = coords.flatten(1)
            rel = flat[:, :, None] - flat[:, None, :]
            rel = rel.permute(1, 2, 0).contiguous()
            rel[..., 0] += win - 1
            rel[..., 1] += win - 1
            rel[..., 0] *= 2 * win - 1
            self.register_buffer("rel_index", rel.sum(-1))
        else:
            self.attn = nn.MultiheadAttention(dim, heads, dropout=0.0)

    def forward(self, x, lw_pos, value=None):
        n, t, h, w, c = x.shape
        xp = _win_permute(x.reshape(n * t, h, w, c), self.win)
        vp = xp if value is None else _win_permute(
            value.reshape(n * t, h, w, c), self.win)
        if self.rpe:
            L, B, _ = xp.shape
            hd = c // self.heads
            q = self.attn.q_proj(xp) * hd ** -0.5
            k = self.attn.k_proj(xp)
            v = self.attn.v_proj(vp)
            to_heads = lambda z: z.reshape(L, B * self.heads, hd).transpose(0, 1)
            q, k, v = to_heads(q), to_heads(k), to_heads(v)
            logits = torch.bmm(q, k.transpose(1, 2))   # (B*H, L, L)
            bias = self.attn.relative_position_bias_table[
                self.rel_index.view(-1)].view(L, L, self.heads)
            bias = bias.permute(2, 0, 1)               # (H, L, L)
            logits = logits.view(B, self.heads, L, L) + bias[None]
            wgt = F.softmax(logits.view(B * self.heads, L, L), dim=-1)
            out = torch.bmm(wgt, v).transpose(0, 1).reshape(L, B, c)
            out = self.attn.out_proj(out)
        else:
            q = k = xp + lw_pos.flatten(0, 1)[:, None, :]
            out = self.attn(q, k, value=vp)[0]
        out = _win_reverse(out, self.win, n * t, h, w)
        return out.reshape(n, t, h, w, c)


class TorchMlpDWBN(nn.Module):
    """MlpDWBN re-derivation (VidHRFormer_modules.py:376-442)."""

    def __init__(self, enc_h, enc_w, dim, hidden, layer_norm):
        super().__init__()
        norm = (lambda ch: nn.LayerNorm((ch, enc_h, enc_w))) if layer_norm \
            else nn.BatchNorm2d
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.norm1 = norm(hidden)
        self.dw3x3 = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.norm2 = norm(hidden)
        self.fc2 = nn.Conv2d(hidden, dim, 1)
        self.norm3 = norm(dim)

    def forward(self, x):
        n, t, h, w, c = x.shape
        y = x.reshape(n * t, h, w, c).permute(0, 3, 1, 2)
        y = F.gelu(self.norm1(self.fc1(y)))
        y = F.gelu(self.norm2(self.dw3x3(y)))
        y = F.gelu(self.norm3(self.fc2(y)))
        return y.permute(0, 2, 3, 1).reshape(n, t, h, w, -1)


class TorchEncBlock(nn.Module):
    """VidHRFormerBlockEnc re-derivation (VidHRFormer_modules.py:30-93)."""

    def __init__(self, enc_h, enc_w, dim, heads, win, ff, far, rpe):
        super().__init__()
        self.far = far
        self.SLMHSA = TorchSLMHSA(dim, heads, win, rpe)
        self.SpatialFFN = TorchMlpDWBN(enc_h, enc_w, dim, 4 * dim,
                                       layer_norm=far)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.temporal_MHSA = nn.MultiheadAttention(dim, heads, dropout=0.0)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm4 = nn.LayerNorm(dim)

    def forward(self, x, lw_pos, temporal_pos):
        n, t, h, w, c = x.shape
        x = x + self.SLMHSA(self.norm1(x), lw_pos)
        x = x + self.SpatialFFN(self.norm2(x))
        x = x.permute(1, 0, 2, 3, 4).reshape(t, n * h * w, c)
        x1 = self.norm3(x)
        q = x1 + temporal_pos[:, None, :]
        mask = (torch.triu(torch.ones(t, t, device=x.device), diagonal=1) == 1) \
            if self.far else None
        x = x + self.temporal_MHSA(q, q, x1, attn_mask=mask)[0]
        x1 = self.norm4(x)
        x = x + self.linear2(F.gelu(self.linear1(x1)))
        return x.reshape(t, n, h, w, c).permute(1, 0, 2, 3, 4)


class TorchFAR(nn.Module):
    """VPTRFormerFAR re-derivation (VPTR_modules.py:154-197)."""

    def __init__(self, layers, dim, heads, win, enc_h, enc_w):
        super().__init__()
        enc = nn.Module()
        enc.layers = nn.ModuleList([
            TorchEncBlock(enc_h, enc_w, dim, heads, win, 4 * dim,
                          far=True, rpe=False) for _ in range(layers)])
        enc.norm = nn.LayerNorm(dim)
        self.transformer = nn.Module()
        self.transformer.encoder = enc

    def forward(self, x, lw_pos, temporal_pos):
        for layer in self.transformer.encoder.layers:
            x = layer(x, lw_pos, temporal_pos)
        return F.relu(self.transformer.encoder.norm(x))


class TorchDecBlock(nn.Module):
    """VidHRFormerBlockDecNAR re-derivation (VidHRFormer_modules.py:125-211),
    full-temporal enc-dec attention variant."""

    def __init__(self, enc_h, enc_w, dim, heads, win, ff, rpe):
        super().__init__()
        self.SLMHSA = TorchSLMHSA(dim, heads, win, rpe)
        self.SpatialFFN = TorchMlpDWBN(enc_h, enc_w, dim, 4 * dim, True)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.temporal_MHSA = nn.MultiheadAttention(dim, heads, dropout=0.0)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm4 = nn.LayerNorm(dim)
        self.EncDecAttn = nn.MultiheadAttention(dim, heads, dropout=0.0)
        self.SpatialFFN1 = TorchMlpDWBN(enc_h, enc_w, dim, 4 * dim, True)
        self.norm5 = nn.LayerNorm(dim)
        self.norm6 = nn.LayerNorm(dim)

    def forward(self, tgt, query_pos, memory, lw_pos, fut_pos, past_pos):
        n, t2, h, w, c = tgt.shape
        t1 = memory.shape[1]
        tgt2 = self.norm1(tgt)
        tgt2 = tgt + self.SLMHSA(tgt2 + query_pos, lw_pos, value=tgt2)
        tgt2 = tgt2 + self.SpatialFFN(self.norm2(tgt2))
        tgt2 = tgt2.permute(1, 0, 2, 3, 4).reshape(t2, n * h * w, c)
        tgt = self.norm3(tgt2)
        q = tgt + fut_pos[:, None, :]
        tgt2 = tgt2 + self.temporal_MHSA(q, q, tgt)[0]
        tgt = self.norm4(tgt2)
        tgt2 = tgt2 + self.linear2(F.gelu(self.linear1(tgt)))
        tgt = self.norm5(tgt2)
        mem = memory.permute(1, 0, 2, 3, 4).reshape(t1, n * h * w, c)
        qp = query_pos.permute(1, 0, 2, 3, 4).reshape(t2, n * h * w, c)
        tgt2 = tgt2 + self.EncDecAttn(
            query=tgt + qp + fut_pos[:, None, :],
            key=mem + past_pos[:, None, :], value=mem)[0]
        tgt2 = tgt2.reshape(t2, n, h, w, c).permute(1, 0, 2, 3, 4)
        return tgt2 + self.SpatialFFN1(self.norm6(tgt2))


class TorchNAR(nn.Module):
    """VPTRFormerNAR re-derivation (VPTR_modules.py:98-152)."""

    def __init__(self, n_enc, n_dec, dim, heads, win, enc_h, enc_w, tf):
        super().__init__()
        enc = nn.Module()
        enc.layers = nn.ModuleList([
            TorchEncBlock(enc_h, enc_w, dim, heads, win, 4 * dim,
                          far=False, rpe=True) for _ in range(n_enc)])
        enc.norm = nn.LayerNorm(dim)
        dec = nn.Module()
        dec.layers = nn.ModuleList([
            TorchDecBlock(enc_h, enc_w, dim, heads, win, 4 * dim, rpe=True)
            for _ in range(n_dec)])
        dec.norm = nn.LayerNorm(dim)
        self.transformer = nn.Module()
        self.transformer.encoder = enc
        self.transformer.decoder = dec
        self.frame_queries = nn.Parameter(
            torch.randn(tf, enc_h, enc_w, dim) * 0.02)
        self.NCE_projector = nn.Sequential(
            nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim))

    def forward(self, src, lw_pos, temporal_pos):
        n, tp = src.shape[:2]
        tf = self.frame_queries.shape[0]
        x = src
        for layer in self.transformer.encoder.layers:
            x = layer(x, lw_pos, temporal_pos[:tp])
        memory = self.transformer.encoder.norm(x)
        query_pos = self.frame_queries[None].repeat(n, 1, 1, 1, 1)
        tgt = torch.zeros_like(query_pos)
        for layer in self.transformer.decoder.layers:
            tgt = layer(tgt, query_pos, memory, lw_pos,
                        temporal_pos[tp:tp + tf], temporal_pos[:tp])
        return F.relu(self.transformer.decoder.norm(tgt))


# ---------------------------------------------------------------------------
# PatchGAN (VPTR_modules.py:49-95)
# ---------------------------------------------------------------------------

class TorchVPTRDisc(nn.Module):
    """PatchGAN re-derivation (reference: model/VPTR_modules.py:49-95,
    batch-norm case: growth convs bias-free)."""

    def __init__(self, in_ch=1, ndf=16, n_layers=3):
        super().__init__()
        seq = [nn.Conv2d(in_ch, ndf, 4, 2, 1), nn.LeakyReLU(0.2, True)]
        nf = 1
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(2 ** n, 8)
            seq += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, 2, 1, bias=False),
                    nn.BatchNorm2d(ndf * nf), nn.LeakyReLU(0.2, True)]
        nf_prev, nf = nf, min(2 ** n_layers, 8)
        seq += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, 1, 1, bias=False),
                nn.BatchNorm2d(ndf * nf), nn.LeakyReLU(0.2, True),
                nn.Conv2d(ndf * nf, 1, 4, 1, 1)]
        self.model = nn.Sequential(*seq)

    def forward(self, x):
        return self.model(x)


# ---------------------------------------------------------------------------
# the save_ckpt envelope (utils/train_summary.py:130-149)
# ---------------------------------------------------------------------------

def write_reference_tar(path, modules: dict, epoch: int = 3,
                        data_parallel: bool = True) -> None:
    """Save ``{module name: nn.Module}`` as the reference's ``epoch_N.tar``.
    The ``loss_dict`` holds an instance of a ``Loss_tuple`` class whose
    module exists only while the file is written (as the reference's own
    ``utils.train_summary`` does not exist where the file is read); the
    optimizer state is a real Adam state; with ``data_parallel`` every
    key carries DataParallel's ``module.`` prefix."""
    ghost = types.ModuleType("utils_train_summary_ghost")

    class LossTuple:
        def __init__(self):
            self.train = [0.5, 0.4]
            self.val = [0.6]

    LossTuple.__module__ = ghost.__name__
    LossTuple.__qualname__ = "Loss_tuple"
    ghost.Loss_tuple = LossTuple
    lin = nn.Linear(4, 4)
    opt = torch.optim.Adam(lin.parameters())
    lin(torch.zeros(1, 4)).sum().backward()
    opt.step()
    prefix = "module." if data_parallel else ""
    sys.modules[ghost.__name__] = ghost
    try:
        torch.save({
            "epoch": epoch,
            "loss_dict": {"T_total": LossTuple(), "epochs": epoch},
            "Module_state_dict": {
                name: {prefix + k: v.detach().cpu() for k, v in m.state_dict().items()}
                for name, m in modules.items()},
            "optimizer_state_dict": {"optimizer_T": opt.state_dict()},
            "code": {"train_FAR.py": b"#!/usr/bin/env python\nprint('x')\n"},
        }, str(path))
    finally:
        del sys.modules[ghost.__name__]
