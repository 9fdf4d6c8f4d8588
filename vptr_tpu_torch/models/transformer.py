"""VidHRFormer FAR latent transformer (eval and train mode) in PyTorch.

Counterpart of ``vptr_tpu/models/transformer.py``: :class:`EncoderBlock`
with the FAR sublayer order (``:47-156``) and :class:`VPTRFormerFAR`
(``:407-488``). One block = window attention -> LayerNormHWC conv FFN ->
causal temporal attention -> linear FFN, each pre-norm with a residual.
With ``fused_attention`` and ``fused_full`` (the preset defaults) the window
sublayer's LayerNorm folds into the ``fused_attention_ln`` kernel and the
temporal attention runs on the ``attention_core`` kernel. In train mode
the attention dropout runs inside both kernels, DropPath acts on the window
and conv-FFN branches and Dropout on the temporal and linear-FFN branches,
all drawn from the ``generator`` passed to ``forward``. The NAR variant and
the default-off kernel routes come with later slices and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vptr_tpu_torch.models.layers import (
    DropPath,
    Dropout,
    LayerNorm,
    Mlp,
    MlpDWBN,
    TemporalAttention,
    WindowAttention,
    bernoulli_keep,
    use_kernels,
)
from vptr_tpu_torch.models.position import (
    position_embedding_1d,
    position_embedding_2d,
)

# config routes that need kernels or modules of a later slice
_LATER = {
    "rpe": "relative position bias (NAR slice)",
    "fused_full_temporal": "the fused sublayer kernel without LN "
                           "(fused_attention, NAR slice)",
    "fused_ffn": "the fused_ffn kernel (default-off kernels slice)",
    "fused_dw": "the fused_dw_chain kernel (default-off kernels slice)",
    "fused_conv_ffn": "the conv_ln_gelu kernel (default-off kernels slice)",
    "sequence_parallel": "sequence parallelism (multi-GPU slice)",
    "scan_layers": "the stacked (scanned) parameter tree (trainer slice)",
    "remat": "activation checkpointing of the blocks (trainer slice)",
}


def _refuse_later(**flags) -> None:
    for name, on in flags.items():
        if on:
            raise NotImplementedError(
                f"transformer.{name}=True needs {_LATER[name]}; not ported yet")


class EncoderBlock(nn.Module):
    """VidHRFormerBlockEnc in its FAR form (causal temporal attention,
    LayerNormHWC conv FFN)."""

    def __init__(self, dim: int, num_heads: int, enc_h: int, enc_w: int,
                 window: int = 4, drop_path: float = 0.0,
                 ffn_hidden_ratio: int = 4, dim_feedforward: int = 2112,
                 far: bool = True, rpe: bool = False,
                 fused_attention: bool = False, fused_full: bool = False,
                 fused_full_temporal: bool = False,
                 fused_residual: bool = False, fused_ffn: bool = False,
                 fused_dw: bool = False, fused_conv_ffn: bool = False,
                 sequence_parallel: bool = False,
                 conv_ffn_norm: Optional[str] = None,
                 dropout: float = 0.0, attn_dropout: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not far:
            raise NotImplementedError("the non-causal encoder block (NAR "
                                      "encoder) comes with the NAR slice")
        _refuse_later(rpe=rpe, fused_full_temporal=fused_full_temporal,
                      fused_ffn=fused_ffn, fused_dw=fused_dw,
                      fused_conv_ffn=fused_conv_ffn,
                      sequence_parallel=sequence_parallel)
        self.fold = fused_attention and fused_full
        self.fused_residual = fused_residual
        attn_drop = dropout if attn_dropout is None else attn_dropout
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.slmhsa = WindowAttention(dim, num_heads, window, fused_attention,
                                      fused_full, dtype, attn_drop)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.spatial_ffn = MlpDWBN(dim, ffn_hidden_ratio * dim, enc_h, enc_w,
                                   conv_ffn_norm or "layer", dtype, dropout)
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.temporal = TemporalAttention(dim, num_heads, causal=True,
                                          fused=fused_attention, dtype=dtype,
                                          dropout=attn_drop)
        self.norm4 = LayerNorm(dim, dtype=dtype)
        self.ffn = Mlp(dim, dim_feedforward, dtype, dropout)
        self.drop_path = DropPath(drop_path)
        self.drop = Dropout(dropout)

    def forward(self, x, pos2d, pos_t, generator=None):
        """``generator``: where the training draws come from (unused in
        eval mode)."""
        dp = lambda y: self.drop_path(y, generator)
        drop = lambda y: self.drop(y, generator)
        ln1 = (self.norm1.weight, self.norm1.bias)
        if self.fold and self.fused_residual:
            # residual + DropPath fold into the kernel: a per-clip draw
            # repeated over the frames (transformer.py:99-112)
            scale = None
            rate = self.drop_path.rate
            if self.training and rate > 0.0:
                keep = bernoulli_keep(x.shape[0], 1.0 - rate, generator,
                                      x.device)
                scale = (keep.float() / torch.tensor(1.0 - rate)).repeat_interleave(
                    x.shape[1])
            x = self.slmhsa(x, pos2d, ln=ln1, residual=True, branch_scale=scale,
                            generator=generator)
        elif self.fold:
            x = x + dp(self.slmhsa(x, pos2d, ln=ln1, generator=generator))
        else:
            x = x + dp(self.slmhsa(self.norm1(x), pos2d, generator=generator))
        x = x + dp(self.spatial_ffn(self.norm2(x), generator))
        x = x + drop(self.temporal(self.norm3(x), pos_t, generator))
        return x + drop(self.ffn(self.norm4(x), generator))


class VPTRFormerFAR(nn.Module):
    """Fully-autoregressive latent transformer: (N, T, h, w, d_model) ->
    same shape, T <= Tp + Tf; output frame t predicts input frame t + 1."""

    def __init__(self, num_past_frames: int = 10, num_future_frames: int = 10,
                 enc_h: int = 8, enc_w: int = 8, d_model: int = 528,
                 num_heads: int = 8, num_encoder_layers: int = 12,
                 window: int = 4, dropout: float = 0.1,
                 drop_path: float = 0.1, attn_dropout: Optional[float] = None,
                 ffn_hidden_ratio: int = 4, rpe: bool = False,
                 fused_attention: bool = False, fused_full: bool = False,
                 fused_full_temporal: bool = False,
                 fused_residual: bool = False, fused_ffn: bool = False,
                 fused_dw: bool = False, fused_conv_ffn: bool = False,
                 sequence_parallel: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.t_max = num_past_frames + num_future_frames
        self.dtype = dtype
        for i in range(num_encoder_layers):
            self.add_module(f"block{i}", EncoderBlock(
                d_model, num_heads, enc_h, enc_w, window, drop_path,
                ffn_hidden_ratio, ffn_hidden_ratio * d_model, far=True,
                rpe=rpe, fused_attention=fused_attention,
                fused_full=fused_full, fused_full_temporal=fused_full_temporal,
                fused_residual=fused_residual, fused_ffn=fused_ffn,
                fused_dw=fused_dw, fused_conv_ffn=fused_conv_ffn,
                sequence_parallel=sequence_parallel, dropout=dropout,
                attn_dropout=attn_dropout, dtype=dtype))
        self.num_encoder_layers = num_encoder_layers
        self.final_norm = LayerNorm(d_model, dtype=dtype)
        self.register_buffer(
            "pos2d", position_embedding_2d(window, window, d_model).reshape(
                window * window, d_model), persistent=False)
        self.register_buffer("pos_t", position_embedding_1d(self.t_max, d_model),
                             persistent=False)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        """``generator``: the source of every training draw (attention
        dropout seeds, DropPath and Dropout masks); needed in train mode
        with a dropout rate above 0."""
        t = feats.shape[1]
        if t > self.t_max:
            raise ValueError(f"sequence length {t} exceeds {self.t_max}")
        x = feats.to(self.dtype)
        pos_t = self.pos_t[:t]
        for i in range(self.num_encoder_layers):
            x = getattr(self, f"block{i}")(x, self.pos2d, pos_t, generator)
        return torch.relu(self.final_norm(x))


def init_transformer_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init: xavier-uniform Dense and conv weights, zero
    biases, LayerNorm scale 1 / shift 0."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()


def build_transformer(cfg, dtype: torch.dtype = torch.float32, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      kernels: str = "cuda") -> VPTRFormerFAR:
    """The FAR transformer of a TransformerConfig, initialised on the CPU
    from ``generator`` (default seed 0), moved to ``device``, in eval mode.
    ``kernels="plain"`` routes it through the kernels' plain versions."""
    from vptr_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if cfg.variant != "far":
        raise NotImplementedError(f"transformer variant {cfg.variant!r} comes "
                                  "with the NAR slice; this slice is FAR")
    _refuse_later(scan_layers=cfg.scan_layers, remat=cfg.remat)
    if cfg.d_model % cfg.n_heads:
        raise ValueError(f"d_model {cfg.d_model} is not divisible by "
                         f"{cfg.n_heads} heads")
    model = VPTRFormerFAR(
        num_past_frames=cfg.num_past_frames,
        num_future_frames=cfg.num_future_frames, enc_h=cfg.enc_h,
        enc_w=cfg.enc_w, d_model=cfg.d_model, num_heads=cfg.n_heads,
        num_encoder_layers=cfg.num_encoder_layers, window=cfg.window_size,
        dropout=cfg.dropout, drop_path=cfg.drop_path,
        attn_dropout=cfg.attention_dropout,
        ffn_hidden_ratio=cfg.spatial_ffn_hidden_ratio,
        rpe=cfg.rpe, fused_attention=cfg.fused_attention,
        fused_full=cfg.fused_full, fused_full_temporal=cfg.fused_full_temporal,
        fused_residual=cfg.fused_residual, fused_ffn=cfg.fused_ffn,
        fused_dw=cfg.fused_dw, fused_conv_ffn=cfg.fused_conv_ffn,
        sequence_parallel=cfg.sequence_parallel, dtype=dtype)
    init_transformer_(model, generator if generator is not None
                      else torch.Generator().manual_seed(0))
    return use_kernels(model.to(device).eval(), kernels)
