"""VidHRFormer latent transformers, FAR and NAR (eval and train mode), in
PyTorch.

Counterpart of ``vptr_tpu/models/transformer.py``:

* :class:`EncoderBlock` (``:47-156``): window attention -> conv FFN ->
  temporal attention -> linear FFN, each pre-norm with a residual. FAR:
  causal temporal attention, LayerNormHWC conv FFN; NAR encoder
  (``far=False``): non-causal, BatchNorm conv FFN.
* :class:`VPTRFormerFAR` (``:407-488``).
* :class:`DecoderBlockNAR` (``:159-277``): window self-attention of the
  queries (q/k carry ``query_pos``, v does not), conv FFN, temporal
  self-attention over the Tf query frames, linear FFN, encoder-decoder
  attention over time (or, with ``tslma``, :class:`TSLMA`), second conv
  FFN.
* :class:`TSLMA` (``:280-308``): encoder-decoder attention within each
  spatial window across time, Tf x win^2 query tokens over Tp x win^2
  memory tokens, the 3D position table on both.
* :class:`VPTRFormerNAR` (``:491-649``): encoder over the past latents,
  decoder over learned ``frame_queries``, and the NCE projector.

With ``fused_attention`` and ``fused_full`` (the preset defaults) the
encoder's window sublayer folds its LayerNorm into the
``fused_attention_ln`` kernel, the decoder's window self-attention runs on
the two-stream ``fused_attention`` kernel, and every temporal and
encoder-decoder attention on the ``attention_core`` kernel; ``rpe`` puts
the relative-position bias into the window kernels. ``fused_ffn`` sends
every linear FFN sublayer (with its leading norm4) to the ``fused_ffn``
kernel and ``fused_dw`` every LayerNorm conv FFN's middle chain to
``fused_dw_chain``; ``fused_conv_ffn`` sends each LayerNorm conv FFN's fc1
and fc2 stages to ``conv_ln_gelu`` (``fused_dw`` takes precedence, as in
the JAX package; the NAR encoder's BatchNorm conv FFN ignores both).
``fused_full_temporal`` (with ``fused_attention`` and ``fused_full``)
folds the temporal self-attention sublayer's LayerNorm into
``fused_attention_ln`` at T tokens (``transformer.py:134-145, 224-238``);
the enc-dec attention (full temporal or TSLMA) stays on
``attention_core``, TSLMA's at its long-sequence route. In train mode the
attention dropout runs inside the kernels, DropPath acts on the window,
conv-FFN (and enc-dec) branches and Dropout on the temporal and
linear-FFN branches, all drawn from the ``generator`` passed to
``forward``.

``remat`` (``transformer.py:340-341, 482-483, 569-572``: ``nn.remat`` of
each block) checkpoints every block of a training forward with autograd
on (:func:`checkpoint_block`): its activations are dropped and the
backward runs its forward again, drawing what the forward drew from the
generator and leaving the BatchNorm running statistics as the forward left
them. ``scan_layers`` (``:311-357, 472-479, 547-566``: ``nn.scan`` over one
``block``, every leaf stacked on axis 0) holds the blocks in a
:class:`BlockStack` named as the JAX stack (``blocks``, ``enc_blocks``,
``dec_blocks``) instead of ``block{i}`` children; ``utils/weights.py``
slices the stacked leaves into it and stacks them back. The arithmetic is
the unrolled stack's, and the blocks draw from the generator in order
(JAX's scan splits the dropout rng per layer instead).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

import numpy as np

from vptr_tpu_torch.models.layers import (
    BatchNorm,
    DropPath,
    Dropout,
    LayerNorm,
    Mlp,
    MlpDWBN,
    MultiHeadAttention,
    TemporalAttention,
    WindowAttention,
    _linear,
    bernoulli_keep,
    use_kernels,
)
from vptr_tpu_torch.models.position import (
    position_embedding_1d,
    position_embedding_2d,
    position_embedding_3d,
)
from vptr_tpu_torch.ops.window import (
    temporal_window_partition,
    temporal_window_reverse,
)

def shard_transformer(model: nn.Module, mesh, tensor_parallel: bool = True) -> nn.Module:
    """Cut a whole transformer to model rank ``mesh.model_rank``'s share of
    ``mesh.model`` (tensor parallelism), in place; the identity at model 1.

    Every parameter and buffer the TP rules name
    (:func:`vptr_tpu_torch.parallel.mesh.tp_dim`) becomes its share (whole
    heads, the matching hidden channels), each attention, linear FFN and
    conv FFN holds its share (their ``shard``), and each temporal attention
    built with ``sequence_parallel`` runs over its share of the columns.
    ``model.tp_shards`` maps each sharded name to its dim (what the
    optimizer's norm, the checkpoints and the weight conversions read).
    ``tensor_parallel=False`` keeps every parameter whole and sets the
    sequence-parallel columns only (``state_sharding(...,
    tensor_parallel=False)``'s counterpart).
    Every kernel route runs on the model axis: fused_ffn (#7/#8 on a
    hidden subset), fused_dw (#9/#10's tiled route split at its
    statistics), fused_conv_ffn (#11/#12's tiled route as fc1's
    column-parallel and fc2's row-parallel steps) and fused_residual (#1
    unfolded, the residual added after the reduce). Raises ValueError where
    the heads or the hidden do not split (a rank holds whole heads; the JAX
    package would split one)."""
    from vptr_tpu_torch.parallel.mesh import shard_of, tp_dim

    size, rank = mesh.model, mesh.model_rank
    model.tp_shards = {}
    if size == 1:
        return model
    for m in model.modules():
        if isinstance(m, TemporalAttention) and m.sequence_parallel:
            m.sp = (size, rank)
    if not tensor_parallel:
        return model
    for m in model.modules():
        if isinstance(m, (MultiHeadAttention, Mlp, MlpDWBN)):
            m.shard(size, rank)
    with torch.no_grad():
        for name, t in list(model.state_dict(keep_vars=True).items()):
            dim = tp_dim(name)
            if dim is None:
                continue
            *path, leaf = name.split(".")
            owner = model.get_submodule(".".join(path))
            part = shard_of(name, t.detach(), size, rank).clone()
            if isinstance(t, nn.Parameter):
                setattr(owner, leaf, nn.Parameter(part, requires_grad=t.requires_grad))
            else:
                owner.register_buffer(leaf, part, persistent=True)
            model.tp_shards[name] = dim
    return model


def tp_shards(model: Optional[nn.Module]) -> Dict[str, int]:
    """The sharded names of a transformer (:func:`shard_transformer`), {}
    for a whole one or another module."""
    return getattr(model, "tp_shards", None) or {}


class BlockStack(nn.ModuleList):
    """The blocks of a ``scan_layers`` stack, ``<stack>.{i}``. The JAX tree
    holds one ``<stack>/block`` whose every leaf is stacked on axis 0 over
    the blocks; :func:`~vptr_tpu_torch.utils.weights.load_jax_variables`
    slices such a leaf into the blocks and
    :func:`~vptr_tpu_torch.utils.weights.export_jax_variables` stacks it
    back."""


def _blocks(model: nn.Module, blocks: List[nn.Module], scan: bool,
            stack: str, prefix: str) -> None:
    """Register ``blocks`` on ``model``: as the :class:`BlockStack`
    ``stack`` with ``scan``, else as ``<prefix>{i}`` children."""
    if scan:
        model.add_module(stack, BlockStack(blocks))
    else:
        for i, block in enumerate(blocks):
            model.add_module(f"{prefix}{i}", block)


def _layers(model: nn.Module, scan: bool, stack: str, prefix: str,
            n: int) -> List[nn.Module]:
    """The blocks :func:`_blocks` registered, in order."""
    if scan:
        return list(getattr(model, stack))
    return [getattr(model, f"{prefix}{i}") for i in range(n)]


def checkpoint_block(block: nn.Module, generator: Optional[torch.Generator],
                     *args):
    """``block(*args, generator=generator)`` with its activations
    checkpointed (``torch.utils.checkpoint``, non-reentrant): autograd keeps
    the block's inputs only, and the backward runs the block's forward
    again before its own.

    That recompute must compute what the forward computed. Every training
    draw (the kernels' dropout seeds, the DropPath / Dropout masks) comes
    from ``generator``, which ``torch.utils.checkpoint`` does not restore
    (``preserve_rng_state`` covers only the default generators, which
    nothing here draws from, so it is off). So the generator's state at
    the block's entry is kept; the recompute starts from it, and the state
    the generator had when the recompute began is put back after it, so the
    step's later draws and the next step's stay where they were. The
    BatchNorm running statistics the recompute would move a second time
    (the NAR encoder's conv FFN; under W ranks their sums pass through an
    all-reduce again, in the same order on every rank) are put back too:
    they move once a step, as flax keeps only the forward's
    ``batch_stats``."""
    entry = None if generator is None else generator.get_state()
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:                  # the forward
            return block(*a, generator=generator)
        now = None if generator is None else generator.get_state()
        stats = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
        if entry is not None:
            generator.set_state(entry)
        try:
            return block(*a, generator=generator)
        finally:
            if now is not None:
                generator.set_state(now)
            with torch.no_grad():
                for m, (mean, var) in zip(norms, stats):
                    m.running_mean.copy_(mean)
                    m.running_var.copy_(var)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def _run_block(model: nn.Module, block: nn.Module, generator, *args):
    """One block of ``model``'s stack: checkpointed with ``model.remat`` in
    a training forward with autograd on, else called directly (remat
    changes nothing in eval mode or under ``no_grad``)."""
    if model.remat and model.training and torch.is_grad_enabled():
        return checkpoint_block(block, generator, *args)
    return block(*args, generator=generator)


def _ffn(ffn: Mlp, norm: LayerNorm, x, generator):
    """The linear feed-forward sublayer before its residual: on the fused
    route the norm's affine goes into the kernel with the raw x
    (``transformer.py:151-155``), else the norm runs first."""
    if ffn.fused:
        return ffn(x, generator, ln=(norm.weight, norm.bias))
    return ffn(norm(x), generator)


def _temporal(ta: TemporalAttention, norm: LayerNorm, x, pos_t, generator):
    """The temporal self-attention sublayer before its residual: on the
    folded route the norm's affine goes into the kernel with the raw x
    (``transformer.py:141-145``), else the norm runs first."""
    if ta.attn.fused_full:
        return ta(x, pos_t, generator, ln=(norm.weight, norm.bias))
    return ta(norm(x), pos_t, generator)


class EncoderBlock(nn.Module):
    """VidHRFormerBlockEnc: FAR (``far``: causal temporal attention,
    LayerNormHWC conv FFN) or the NAR encoder's (non-causal, BatchNorm conv
    FFN); ``conv_ffn_norm`` overrides the conv-FFN norm."""

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
        self.fold = fused_attention and fused_full
        self.fused_residual = fused_residual
        attn_drop = dropout if attn_dropout is None else attn_dropout
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.slmhsa = WindowAttention(dim, num_heads, window, fused_attention,
                                      fused_full, dtype, attn_drop, rpe)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.spatial_ffn = MlpDWBN(
            dim, ffn_hidden_ratio * dim, enc_h, enc_w,
            conv_ffn_norm or ("layer" if far else "batch"), dtype, dropout,
            fused_dw, fused_conv_ffn)
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.temporal = TemporalAttention(dim, num_heads, causal=far,
                                          fused=fused_attention, dtype=dtype,
                                          dropout=attn_drop,
                                          fused_full=self.fold
                                          and fused_full_temporal,
                                          sequence_parallel=sequence_parallel)
        self.norm4 = LayerNorm(dim, dtype=dtype)
        self.ffn = Mlp(dim, dim_feedforward, dtype, dropout, fused_ffn)
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
        x = x + drop(_temporal(self.temporal, self.norm3, x, pos_t, generator))
        return x + drop(_ffn(self.ffn, self.norm4, x, generator))


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
                 sequence_parallel: bool = False, remat: bool = False,
                 scan_layers: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.t_max = num_past_frames + num_future_frames
        self.dtype = dtype
        self.remat, self.scan_layers = remat, scan_layers
        _blocks(self, [EncoderBlock(
            d_model, num_heads, enc_h, enc_w, window, drop_path,
            ffn_hidden_ratio, ffn_hidden_ratio * d_model, far=True,
            rpe=rpe, fused_attention=fused_attention,
            fused_full=fused_full, fused_full_temporal=fused_full_temporal,
            fused_residual=fused_residual, fused_ffn=fused_ffn,
            fused_dw=fused_dw, fused_conv_ffn=fused_conv_ffn,
            sequence_parallel=sequence_parallel, dropout=dropout,
            attn_dropout=attn_dropout, dtype=dtype)
            for _ in range(num_encoder_layers)], scan_layers, "blocks", "block")
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
        for block in _layers(self, self.scan_layers, "blocks", "block",
                             self.num_encoder_layers):
            x = _run_block(self, block, generator, x, self.pos2d, pos_t)
        return torch.relu(self.final_norm(x))


class TSLMA(nn.Module):
    """Temporal-spatial local multi-head attention (``transformer.py:280-308``;
    reference VidHRFormer_modules.py:219-284): encoder-decoder attention
    over the (T x win^2)-token sequences of each spatial window. Its one
    ``attn`` runs without the window kernels' folding (``fused_full`` off):
    q, k and v projections, ``attention_core`` (the kernel with
    ``fused``), the out projection."""

    def __init__(self, dim: int, num_heads: int, window: int = 4,
                 dropout: float = 0.0, fused: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window = window
        self.attn = MultiHeadAttention(dim, num_heads, fused, False, dtype,
                                       dropout)

    def forward(self, memory, query, pos3d, generator=None):
        """memory: (N, T1, h, w, C), query: (N, T2, h, w, C), pos3d: (T1 +
        T2, win, win, C) (keys take its first T1 frames, queries the rest,
        each cast to the activations' dtype). Returns (N, T2, h, w, C)."""
        t1 = memory.shape[1]
        t2, h, w, c = query.shape[1:]
        win2 = self.window * self.window
        mem_w = temporal_window_partition(memory, self.window)
        qry_w = temporal_window_partition(query, self.window)
        pos = pos3d.reshape(t1 + t2, win2, c)
        pos_k = pos[:t1].reshape(1, t1 * win2, c).to(mem_w.dtype)
        pos_q = pos[t1:t1 + t2].reshape(1, t2 * win2, c).to(qry_w.dtype)
        out = self.attn(qry_w + pos_q, mem_w + pos_k, mem_w, generator=generator)
        return temporal_window_reverse(out, self.window, t2, (h, w))


class DecoderBlockNAR(nn.Module):
    """VidHRFormerBlockDecNAR (``transformer.py:159-277``; reference
    VidHRFormer_modules.py:125-211) with full temporal enc-dec attention
    (``enc_dec``) or, with ``tslma``, :class:`TSLMA` in its place (a
    ``tslma`` child instead of ``enc_dec``, as flax creates only the one it
    calls; it takes the block's ``dropout``, not ``attn_dropout``).
    ``fused_residual`` is accepted and unused, as in the JAX package: the
    window self-attention's value differs from its q/k input."""

    def __init__(self, dim: int, num_heads: int, enc_h: int, enc_w: int,
                 window: int = 4, drop_path: float = 0.0,
                 ffn_hidden_ratio: int = 4, dim_feedforward: int = 2112,
                 tslma: bool = False, rpe: bool = False,
                 fused_attention: bool = False, fused_full: bool = False,
                 fused_full_temporal: bool = False,
                 fused_residual: bool = False, fused_ffn: bool = False,
                 fused_dw: bool = False, fused_conv_ffn: bool = False,
                 sequence_parallel: bool = False,
                 dropout: float = 0.0, attn_dropout: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del fused_residual
        attn_drop = dropout if attn_dropout is None else attn_dropout
        conv_ffn = lambda: MlpDWBN(dim, ffn_hidden_ratio * dim, enc_h, enc_w,
                                   "layer", dtype, dropout, fused_dw,
                                   fused_conv_ffn)
        temporal = lambda fused_full: TemporalAttention(
            dim, num_heads, False, fused_attention, dtype, attn_drop, fused_full,
            sequence_parallel)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.slmhsa = WindowAttention(dim, num_heads, window, fused_attention,
                                      fused_full, dtype, attn_drop, rpe)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.spatial_ffn = conv_ffn()
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.temporal = temporal(fused_attention and fused_full
                                 and fused_full_temporal)
        self.norm4 = LayerNorm(dim, dtype=dtype)
        self.ffn = Mlp(dim, dim_feedforward, dtype, dropout, fused_ffn)
        self.norm5 = LayerNorm(dim, dtype=dtype)
        self.use_tslma = tslma
        if tslma:
            self.tslma = TSLMA(dim, num_heads, window, dropout, fused_attention,
                               dtype)
        else:
            self.enc_dec = temporal(False)
        self.norm6 = LayerNorm(dim, dtype=dtype)
        self.spatial_ffn2 = conv_ffn()
        self.drop_path = DropPath(drop_path)
        self.drop = Dropout(dropout)

    def forward(self, tgt, query_pos, memory, pos2d, pos_t_future, pos_t_past,
                pos3d=None, generator=None):
        """tgt, query_pos: (N, Tf, h, w, C); memory: (N, Tp, h, w, C);
        pos_t_future (Tf, C) and pos_t_past (Tp, C) go on the enc-dec
        queries and keys; ``pos3d`` (Tp + Tf, win, win, C) on TSLMA's."""
        dp = lambda y: self.drop_path(y, generator)
        drop = lambda y: self.drop(y, generator)
        # 1) window self-attention: q/k carry query_pos, the value does not
        t2 = self.norm1(tgt)
        tgt = tgt + dp(self.slmhsa(t2 + query_pos, pos2d, value=t2,
                                   generator=generator))
        tgt = tgt + dp(self.spatial_ffn(self.norm2(tgt), generator))
        tgt = tgt + drop(_temporal(self.temporal, self.norm3, tgt, pos_t_future,
                                   generator))
        tgt = tgt + drop(_ffn(self.ffn, self.norm4, tgt, generator))
        # 5) encoder-decoder attention: TSLMA over space-time windows, or
        #    over time at each location
        if self.use_tslma:
            y = self.tslma(memory, self.norm5(tgt) + query_pos, pos3d, generator)
        else:
            y = self.enc_dec(self.norm5(tgt) + query_pos, pos_t_future, generator,
                             kv=memory, pos_k=pos_t_past)
        tgt = tgt + dp(y)
        return tgt + dp(self.spatial_ffn2(self.norm6(tgt), generator))


class VPTRFormerNAR(nn.Module):
    """Non-autoregressive latent transformer (``transformer.py:491-649``):
    (N, Tp, h, w, d_model) past latents -> (N, Tf, h, w, d_model) future
    latents in one call. Parameter names mirror the JAX tree (``enc_block{i}``,
    ``dec_block{i}`` or, with ``scan_layers``, ``enc_blocks.{i}``,
    ``dec_blocks.{i}``; ``enc_norm``, ``dec_norm``, ``frame_queries``,
    ``nce_fc1``, ``nce_fc2``)."""

    def __init__(self, num_past_frames: int = 10, num_future_frames: int = 10,
                 enc_h: int = 8, enc_w: int = 8, d_model: int = 528,
                 num_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, window: int = 4,
                 dropout: float = 0.1, drop_path: float = 0.1,
                 attn_dropout: Optional[float] = None,
                 ffn_hidden_ratio: int = 4, tslma: bool = False,
                 rpe: bool = True, conv_ffn_norm_enc: Optional[str] = None,
                 remat: bool = False, scan_layers: bool = False,
                 dtype: torch.dtype = torch.float32, **routes):
        """``routes``: the kernel-route flags of :class:`EncoderBlock`
        (``fused_attention``, ``fused_full``, ...)."""
        super().__init__()
        self.enc_h, self.enc_w, self.dtype = enc_h, enc_w, dtype
        self.remat, self.scan_layers = remat, scan_layers
        self.num_future_frames = num_future_frames
        self.t_max = num_past_frames + num_future_frames
        common = dict(dim=d_model, num_heads=num_heads, enc_h=enc_h,
                      enc_w=enc_w, window=window, drop_path=drop_path,
                      ffn_hidden_ratio=ffn_hidden_ratio,
                      dim_feedforward=ffn_hidden_ratio * d_model, rpe=rpe,
                      dropout=dropout, attn_dropout=attn_dropout, dtype=dtype,
                      **routes)
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        _blocks(self, [EncoderBlock(far=False, conv_ffn_norm=conv_ffn_norm_enc,
                                    **common) for _ in range(num_encoder_layers)],
                scan_layers, "enc_blocks", "enc_block")
        _blocks(self, [DecoderBlockNAR(tslma=tslma, **common)
                       for _ in range(num_decoder_layers)],
                scan_layers, "dec_blocks", "dec_block")
        self.enc_norm = LayerNorm(d_model, dtype=dtype)
        self.dec_norm = LayerNorm(d_model, dtype=dtype)
        # learned frame queries (reference: VPTR_modules.py:132)
        self.frame_queries = nn.Parameter(
            torch.zeros(num_future_frames, enc_h, enc_w, d_model))
        # NCE projector (reference: VPTR_modules.py:135-137)
        self.nce_fc1 = nn.Linear(d_model, d_model)
        self.nce_fc2 = nn.Linear(d_model, d_model)
        self.register_buffer(
            "pos2d", position_embedding_2d(window, window, d_model).reshape(
                window * window, d_model), persistent=False)
        self.register_buffer("pos_t", position_embedding_1d(self.t_max, d_model),
                             persistent=False)
        # TSLMA's (t, y, x) table over the Tp + Tf frames (transformer.py:606-607)
        self.register_buffer("pos3d", position_embedding_3d(
            self.t_max, window, window, d_model) if tslma else None,
            persistent=False)

    def forward(self, past_feats, generator: Optional[torch.Generator] = None):
        """``generator``: the source of every training draw; needed in train
        mode with a dropout rate above 0."""
        n, tp, h, w = past_feats.shape[:4]
        if (h, w) != (self.enc_h, self.enc_w):
            raise ValueError(f"latent spatial {(h, w)} != configured (enc_h, "
                             f"enc_w) = {(self.enc_h, self.enc_w)}: the frame "
                             "queries are bound to the latent geometry")
        tf = self.num_future_frames
        if tp + tf > self.t_max:
            raise ValueError(f"{tp} past frames exceed the {self.t_max - tf} "
                             "the position table covers")
        x = past_feats.to(self.dtype)
        pos_past, pos_future = self.pos_t[:tp], self.pos_t[tp:tp + tf]
        for block in _layers(self, self.scan_layers, "enc_blocks", "enc_block",
                             self.num_encoder_layers):
            x = _run_block(self, block, generator, x, self.pos2d, pos_past)
        memory = self.enc_norm(x)
        # queries broadcast over the batch; the target starts at zero
        query_pos = self.frame_queries.to(self.dtype)[None].expand(
            (n,) + self.frame_queries.shape)
        tgt = torch.zeros(query_pos.shape, dtype=self.dtype, device=x.device)
        for block in _layers(self, self.scan_layers, "dec_blocks", "dec_block",
                             self.num_decoder_layers):
            tgt = _run_block(self, block, generator, tgt, query_pos, memory,
                             self.pos2d, pos_future, pos_past, self.pos3d)
        return torch.relu(self.dec_norm(tgt))

    def nce_project(self, feats):
        """The BiPatchNCE projector on (..., d_model) features:
        nce_fc2(relu(nce_fc1(feats))) in the compute dtype."""
        return _linear(self.nce_fc2,
                       torch.relu(_linear(self.nce_fc1, feats, self.dtype)),
                       self.dtype)


def _xavier_uniform_flax_(p: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``xavier_uniform`` on an (..., in, out) parameter: fan-in and
    fan-out are the last two axes times the product of the others."""
    receptive = int(np.prod(p.shape[:-2]))
    bound = (6.0 / ((p.shape[-2] + p.shape[-1]) * receptive)) ** 0.5
    with torch.no_grad():
        p.uniform_(-bound, bound, generator=generator)


def init_transformer_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init: xavier-uniform Dense and conv weights and
    frame queries, zero biases, LayerNorm / BatchNorm scale 1 / shift 0,
    the RPE tables truncated-normal with std 0.02."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, BatchNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, WindowAttention) and m.rpe:
            nn.init.trunc_normal_(m.rpe_table, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
        elif isinstance(m, VPTRFormerNAR):
            _xavier_uniform_flax_(m.frame_queries, generator)


def build_transformer(cfg, dtype: torch.dtype = torch.float32, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      kernels: str = "cuda", mesh=None) -> nn.Module:
    """The FAR or NAR transformer of a TransformerConfig (``cfg.variant``),
    initialised on the CPU from ``generator`` (default seed 0), moved to
    ``device``, in eval mode. ``kernels="plain"`` routes it through the
    kernels' plain versions. ``mesh``: a (data, model) mesh whose model
    axis shards the whole model after its initialisation
    (:func:`shard_transformer`: every rank draws the whole init from the
    seed, as one process does, then keeps its share)."""
    from vptr_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if cfg.variant not in ("far", "nar"):
        raise ValueError(f"unknown variant {cfg.variant!r}")
    if cfg.d_model % cfg.n_heads:
        raise ValueError(f"d_model {cfg.d_model} is not divisible by "
                         f"{cfg.n_heads} heads")
    common = dict(
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
        sequence_parallel=cfg.sequence_parallel, remat=cfg.remat,
        scan_layers=cfg.scan_layers, dtype=dtype)
    if cfg.variant == "far":
        model = VPTRFormerFAR(**common)
    else:
        model = VPTRFormerNAR(
            num_decoder_layers=cfg.num_decoder_layers, tslma=cfg.tslma,
            conv_ffn_norm_enc=(None if cfg.conv_ffn_norm == "auto"
                               else cfg.conv_ffn_norm), **common)
    init_transformer_(model, generator if generator is not None
                      else torch.Generator().manual_seed(0))
    if mesh is not None:
        shard_transformer(model, mesh)
    return use_kernels(model.to(device).eval(), kernels)
