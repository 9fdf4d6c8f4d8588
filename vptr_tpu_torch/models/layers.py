"""Transformer layers of the FAR and NAR paths, in PyTorch (eval and train
mode).

Counterpart of ``vptr_tpu/models/layers.py``:

* :class:`MultiHeadAttention` with three routes: the LayerNorm-folded
  whole-sublayer kernel (``fused_attention_ln``, ``layers.py:236-265``),
  the two-stream whole-sublayer kernel for q_in = k_in with a separate
  value (``fused_attention``, ``layers.py:277-293``, the NAR decoder's
  window self-attention) and torch projections feeding the attention-core
  kernel (``layers.py:309-326``; Lq may differ from Lk); ``fused=False``
  runs the same arithmetic in plain PyTorch. The JAX package sends
  rectangular (Lq != Lk) cross-attention to XLA by a TPU measurement
  (``FUSED_RECT_DISABLE``); the port runs it on the attention-core kernel,
  whose forward is the same function.
* :class:`WindowAttention` (absolute 2D sine position on q/k, or the
  learned relative-position bias with :func:`relative_position_index`),
  :class:`TemporalAttention` (causal mask as a -1e30 (1, T, T) bias;
  cross-attention over ``kv``), :class:`LayerNorm`, :class:`LayerNormHWC`,
  :class:`BatchNorm` and :class:`GroupNorm` (flax semantics; also the
  autoencoder's and the discriminator's), :class:`MlpDWBN` in both norm
  flavours, :class:`Mlp`, :class:`DropPath` and :class:`Dropout` (both the
  identity in eval mode).
* The feed-forward kernel routes: :class:`Mlp` with ``fused`` takes its
  leading LayerNorm's affine and the raw x into ``fused_ffn``
  (``layers.py:736-757``); the LayerNorm :class:`MlpDWBN` with ``fused_dw``
  runs its middle chain in ``fused_dw_chain`` (``layers.py:632-658``), and
  with ``fused_ln`` its fc1 and fc2 stages (1x1 conv, whole-sample norm,
  GELU) in ``conv_ln_gelu`` (``layers.py:660-684``).
* The temporal kernel route: :class:`TemporalAttention` with ``fused_full``
  takes its sublayer's LayerNorm affine and the raw x into
  ``fused_attention_ln`` (``layers.py:503-508``), as the window sublayer
  does.

Train mode (``module.train()``): attention-weight dropout runs inside the
kernels from an int32 seed per call; BatchNorm normalises with the batch
statistics and updates its running ones; DropPath and Dropout draw their masks
with ``torch.rand``. Every draw comes from the ``generator`` the caller
passes down through ``forward`` (a torch.Generator on the activations'
device); there is no global RNG, and a training forward with a dropout rate
above 0 and no generator raises. The masks differ from ``jax.random``'s
(another generator); the kernels' hash masks are bit-equal to the JAX
package's for the same seed.

Under a process group of W > 1 ranks (:mod:`vptr_tpu_torch.parallel`) each
rank holds b rows of a global batch of W·b, and every train-mode module
computes what one process computes at the global batch: BatchNorm takes its
statistics over the global batch (the per-channel sums all-reduced through
autograd); DropPath and Dropout draw the global shape from the shared
generator and keep rows r·b .. (r+1)·b; the kernels' seed is folded by the
rank's element offset (:func:`~vptr_tpu_torch.parallel.mesh.fold_seed`),
since every kernel's mask index is sample-major (windows n·T·nW, temporal
columns n·HW, FFN rows n·T·HW, dw samples n·T). Every rank's generator
advances identically.

Tensor parallelism (a mesh with ``model`` M > 1,
:func:`~vptr_tpu_torch.models.transformer.shard_transformer`): each module
that holds heads or hidden channels holds its rank's share of them (whole
heads [m H/M, (m+1) H/M) and the matching hidden channels, by the TP rules
of :mod:`vptr_tpu_torch.parallel.mesh`) and runs the Megatron pattern:
its replicated input enters the TP region (:func:`enter_model`: the
backward sums the input's gradient over the model group), the
column-parallel products (q/k/v, linear1, fc1) and what follows them per
head or channel run on the share, and the row-parallel product (out_proj,
linear2, fc2) gives a partial sum that :func:`reduce_model` adds up over
the model group, in f32, before the replicated bias is added once. The
kernels take the head subset (``mask_heads``, ``head0``), so their
dropout is the whole call's; a hidden dropout draws the global shape and
keeps the rank's rows and channels; LayerNormHWC over the split hidden
takes its moments over the model group (:func:`model_sum`). On the kernel
routes: ``fused_ffn`` runs kernels #7/#8 on the rank's hidden columns
(``mask_cols``, ``col0``: the hidden dropout at the global column) into a
partial sum, b2 added after the reduce; ``fused_dw`` runs the chain on
the rank's hidden channels with its whole-sample LayerNorms over every
rank's (``fused_dw_chain(..., model=)``: on the card #9/#10's tiled route
split at its statistics, which are exchanged over the model group);
``fused_conv_ffn`` runs kernels #11/#12 as fc1's column-parallel and fc2's
row-parallel call (``conv_ln_gelu(..., model=, rows=)``: on the card the
tiled route's steps, norm1's statistics exchanged over the model group and
fc2's partial products summed in f32 before its bias); the
residual-folded window sublayer (``fused_residual``) calls #1 unfolded on
the head subset and adds x + scale * branch once after the reduce. Sequence
parallelism (``TemporalAttention.sp``): each model rank attends over a
contiguous share of the flattened (N·HW) temporal columns with every head
(the sublayer's parameters gathered whole for the call, their gradients
summed over the model group), and the shares are gathered after.

Each kernel-backed module's (attention, :class:`Mlp`, :class:`MlpDWBN`)
``kernels`` attribute is ``"cuda"`` (the wrappers: the kernel on a CUDA
tensor, the plain version on a CPU tensor) or ``"plain"`` (the plain
version everywhere); :func:`use_kernels` sets it on a whole model, for the
on-card comparison of the two. Parameters are f32,
``dtype`` is the compute dtype; names mirror the JAX parameter tree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vptr_tpu_torch.ops.attention_core import attention_core, attention_core_plain
from vptr_tpu_torch.ops.conv_ln_gelu import conv_ln_gelu, conv_ln_gelu_plain
from vptr_tpu_torch.ops.dropout import padded_tokens
from vptr_tpu_torch.ops.fused_dw_chain import fused_dw_chain, fused_dw_chain_plain
from vptr_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_plain
from vptr_tpu_torch.ops.fused_window_attention import (
    fused_attention,
    fused_attention_ln,
    fused_attention_ln_plain,
    fused_attention_ln_res,
    fused_attention_plain,
)
from vptr_tpu_torch.ops.window import (
    pad_to_window,
    unpad_from_window,
    window_partition,
    window_reverse,
)
from vptr_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    data_rank,
    data_size,
    enter_model,
    gather_model,
    gather_params,
    model_rank,
    model_size,
    model_sum,
    rank_seed,
    reduce_model,
    scatter_model,
)

KERNEL_MODES = ("cuda", "plain")


def use_kernels(model: nn.Module, kernels: str) -> nn.Module:
    """Route every kernel-backed module of ``model`` (attention and both
    feed-forwards) through the kernels (``"cuda"``) or their plain versions
    (``"plain"``)."""
    if kernels not in KERNEL_MODES:
        raise ValueError(f"kernels must be one of {KERNEL_MODES}, got {kernels!r}")
    for m in model.modules():
        if isinstance(m, (MultiHeadAttention, Mlp, MlpDWBN)):
            m.kernels = kernels
    return model


def relative_position_index(window: int) -> np.ndarray:
    """(w^2, w^2) index into the (2w-1)^2-row relative-position table, the
    Swin construction (``layers.py:94-108``)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One int32 kernel seed in [0, 2^31 - 1), drawn on ``device`` (no host
    synchronisation), as the JAX package's ``dropout_seed`` draws from
    ``make_rng("dropout")`` (``layers.py:223-228``)."""
    if generator is None:
        raise ValueError("a training forward with dropout needs a generator")
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)


def bernoulli_keep(shape, keep: float, generator: Optional[torch.Generator],
                   device, split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Boolean mask of ``shape`` (an int or a tuple), True with probability
    ``keep``. Under W > 1 data ranks the leading axis is this rank's b rows
    of the global batch: the mask of the global shape (W·b, ...) is drawn
    and rows r·b .. (r+1)·b kept, so every rank draws what one process at
    the global batch draws. ``split`` (dim, M, m): ``shape``'s ``dim`` is
    model rank m's share of M (a tensor-parallel hidden); the draw takes
    the whole dim and keeps the share."""
    if generator is None:
        raise ValueError("a training forward with dropout needs a generator")
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    w, b, r = data_size(), shape[0], data_rank()
    full = [w * b] + list(shape[1:])
    if split is not None:
        dim, m_size, m_rank = split
        dim %= len(shape)
        full[dim] *= m_size
    mask = torch.rand(full, generator=generator, device=device)[r * b:(r + 1) * b]
    if split is not None:
        mask = mask.narrow(dim, m_rank * shape[dim], shape[dim])
    return mask < keep


def _keep_scaled(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """where(keep, x / (1 - rate), 0) with the divisor in x's dtype, as a
    JAX Python-float divisor is (a weak type)."""
    div = torch.tensor(1.0 - rate, dtype=x.dtype)
    return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype, device=x.device))


def _linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """nn.Dense in ``dtype``: input, kernel and bias cast to it."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           dtype: torch.dtype) -> torch.Tensor:
    """:func:`_linear` of a weight (out, in) and bias (or None) given as
    tensors."""
    return F.linear(x.to(dtype), w.to(dtype), None if b is None else b.to(dtype))


def _row_parallel_out(partial: torch.Tensor, bias: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel product's output: the ranks' partial sums added up
    over the model group in f32, the replicated bias added once, cast to
    ``dtype``."""
    return (reduce_model(partial) + bias.float()).to(dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with f32 statistics whose result is cast to ``dtype``."""

    def __init__(self, shape, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(shape, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class LayerNormHWC(LayerNorm):
    """LayerNorm over a whole (C, H, W) NCHW sample with per-element affine
    (``layers.py:522-543``; the JAX module stores its affine (H, W, C)).

    ``tp`` (set by :meth:`shard`): the module holds its model rank's share
    of the C channels (and of the affine); the sample's moments are taken
    over every rank's channels (:func:`model_sum`, forward and backward)."""

    tp: Optional[Tuple[int, int]] = None

    def shard(self, size: int, rank: int) -> None:
        self.tp = (size, rank)
        self.normalized_shape = tuple(self.weight.shape)

    def forward(self, x):
        if self.tp is None:
            return super().forward(x)
        x32 = x.float()
        n = x32[0].numel() * self.tp[0]
        view = lambda v: v[:, None, None, None]
        mean = model_sum(x32.sum((1, 2, 3))) / n
        d = x32 - view(mean)
        var = model_sum((d * d).sum((1, 2, 3))) / n
        y = d * view(torch.rsqrt(var + self.eps)) * self.weight + self.bias
        return y.to(self.dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention with separate q/k/v/out projections over (..., L, C).

    :meth:`shard` keeps heads [m H/M, (m+1) H/M) of model rank m: q/k/v
    project C to Cl = H/M hd, out_proj Cl to C into a partial sum (see the
    module notes)."""

    def __init__(self, dim: int, num_heads: int, fused: bool = False,
                 fused_full: bool = False, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not divisible by {num_heads} heads")
        self.dim, self.num_heads = dim, num_heads
        self.dropout = dropout           # attention-weight dropout (train)
        self.fused, self.fused_full = fused, fused_full
        self.dtype = dtype
        self.kernels = "cuda"            # see use_kernels
        self.tp: Optional[Tuple[int, int]] = None    # (M, m) after shard()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def shard(self, size: int, rank: int) -> None:
        """Hold model rank ``rank``'s heads of ``size`` (the parameters are
        cut by ``shard_transformer``); whole heads only."""
        if self.num_heads % size:
            raise ValueError(
                f"n_heads {self.num_heads} does not split over mesh.model={size}: a rank "
                f"holds whole heads (d_model {self.dim} = {self.num_heads} heads of "
                f"{self.dim // self.num_heads}); the JAX package would split a head, which "
                f"the head-subset kernels cannot take")
        self.tp = (size, rank)

    @property
    def local_heads(self) -> int:
        return self.num_heads if self.tp is None else self.num_heads // self.tp[0]

    def _params(self, sp: bool, ln):
        """(wq, bq, wk, bk, wv, bv, wo, bo, ls, lb) in torch layouts: the
        module's own, or for a sequence-parallel call (``sp``) every head's
        (gathered from the model ranks when sharded), their gradients and
        the folded LayerNorm's summed over the model group."""
        ps = [self.q_proj.weight, self.q_proj.bias, self.k_proj.weight, self.k_proj.bias,
              self.v_proj.weight, self.v_proj.bias, self.out_proj.weight,
              self.out_proj.bias]
        lns = list(ln) if ln is not None else []
        if sp:
            dims = ([0, 0, 0, 0, 0, 0, 1, None] if self.tp is not None else [None] * 8)
            ps = gather_params(ps + lns, dims + [None] * len(lns))
            ps, lns = ps[:8], ps[8:]
        return ps + (lns or [None, None])

    def _window_seed(self, seed, windows: int, tokens: int, index=None):
        """The seed of this rank's ``windows`` of a window-kernel call (#1,
        #5): its mask index runs over the padded token count and every
        head."""
        lp = padded_tokens(tokens, self.dtype)
        return rank_seed(seed, windows * self.num_heads * lp * lp, index)

    def forward(self, q_in, k_in, v_in, *, bias=None,
                ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                qk_pos=None, residual: bool = False, branch_scale=None,
                generator: Optional[torch.Generator] = None, sp: bool = False):
        """``ln``: (scale, bias) of the sublayer's leading LayerNorm; callers
        then pass the raw x as q_in = k_in = v_in and q/k = LN(x) + qk_pos,
        v = LN(x). ``residual`` (fused LN route only) returns x +
        branch_scale * attn(...), ``branch_scale`` (leading batch,) f32 or
        None. ``bias``: None or (1 | H, Lq, Lk) additive logits (the rank's
        heads of a per-head bias when sharded). Without ``ln``, q_in = k_in
        of v_in's shape takes the two-stream kernel on the fused_full route.
        ``sp``: a sequence-parallel call over this rank's share of the
        columns, with every head (the caller scatters and gathers)."""
        plain = self.kernels == "plain"
        rate = self.dropout if self.training else 0.0
        seed = draw_seed(generator, q_in.device) if rate > 0.0 else 0
        tp = self.tp is not None and not sp
        heads = self.local_heads if tp else self.num_heads
        mask = dict(mask_heads=self.num_heads, head0=self.tp[1] * heads) if tp else {}
        # the seed's share: the data rank's rows, or under SP the (data,
        # model) rank's share of the flattened columns
        index = data_rank() * model_size() + model_rank() if sp else None
        wq, bq, wk, bk, wv, bv, wo, bo, ls, lb = self._params(sp, ln)
        x_res = q_in         # the residual's x, outside the TP region
        if tp:      # into the TP region: the inputs' gradients sum over the ranks
            uniq = []
            for t in (q_in, k_in, v_in):
                if not any(t is u for u in uniq):
                    uniq.append(t)
            # a one-head bias is every rank's: its gradient, a sum over the
            # rank's heads, sums over the model group too
            shared = bias if bias is not None and bias.shape[0] == 1 else None
            moved = enter_model(*uniq, ls, lb, shared)
            pick = lambda t: moved[next(i for i, u in enumerate(uniq) if t is u)]
            q_in, k_in, v_in = pick(q_in), pick(k_in), pick(v_in)
            ls, lb = moved[-3:-1]
            bias = moved[-1] if shared is not None else bias
        out_bias = torch.zeros_like(bo.float()) if tp else bo.float()

        def finish(out):   # (..., C): the whole output, or the rank's partial sum
            return _row_parallel_out(out, bo, self.dtype) if tp else out

        def weights():     # the kernels' (in, out) layout, the biases f32
            return [w.t().to(self.dtype).contiguous() if i % 2 == 0 else w.float()
                    for i, w in enumerate((wq, bq, wk, bk, wv, bv, wo))] + [out_bias]

        if ln is not None:
            if not (q_in is k_in and k_in is v_in):
                raise ValueError("ln folding expects q_in = k_in = v_in = x")
            if self.fused and self.fused_full:
                lead, l = q_in.shape[:-2], q_in.shape[-2]
                xf = q_in.reshape(-1, l, self.dim).to(self.dtype).contiguous()
                seed = self._window_seed(seed, xf.shape[0], l, index)
                args = (xf, *weights(), ls.float(), lb.float(),
                        None if qk_pos is None else qk_pos.float().contiguous(), bias)
                scale = branch_scale if residual else None
                if tp and residual:
                    # each rank's branch is a partial sum: x + scale * (the
                    # sum + bo) after the reduce, not x folded in per rank
                    part = (fused_attention_ln_plain(*args, seed, heads, rate, **mask)
                            if plain else fused_attention_ln(*args, seed, heads, rate, **mask))
                    out = reduce_model(part) + bo.float()
                    if scale is not None:
                        out = out * scale.float()[:, None, None]
                    out = (x_res.reshape(xf.shape).float() + out).to(self.dtype)
                    return out.reshape(lead + (l, self.dim))
                if plain:
                    out = fused_attention_ln_plain(
                        *args, seed, heads, rate, scale, residual, **mask)
                elif residual:
                    out = fused_attention_ln_res(*args, scale, seed, heads, rate)
                else:
                    out = fused_attention_ln(*args, seed, heads, rate, **mask)
                return finish(out).reshape(lead + (l, self.dim))
            xn = F.layer_norm(q_in.float(), (self.dim,), ls, lb, 1e-5).to(self.dtype)
            q_in = k_in = xn + qk_pos.to(self.dtype) if qk_pos is not None else xn
            v_in = xn
            if residual:
                raise NotImplementedError(
                    "the residual-folded sublayer runs on the fused route only")

        if (self.fused and self.fused_full and q_in is k_in
                and v_in.shape == q_in.shape and q_in.shape[-1] == self.dim):
            # the whole sublayer with v from its own input (kernel #5)
            lead, l = q_in.shape[:-2], q_in.shape[-2]
            flat = lambda z: z.reshape(-1, l, self.dim).to(self.dtype).contiguous()
            fn = fused_attention_plain if plain else fused_attention
            xqk = flat(q_in)
            out = fn(xqk, flat(v_in), *weights(), bias,
                     self._window_seed(seed, xqk.shape[0], l, index), heads, rate, **mask)
            return finish(out).reshape(lead + (l, self.dim))

        q = _dense(q_in, wq, bq, self.dtype)
        k = _dense(k_in, wk, bk, self.dtype)
        v = _dense(v_in, wv, bv, self.dtype)
        hd = q.shape[-1] // heads

        def split(z):  # (..., L, Cl) -> (B, H, L, hd): a view of the projection
            z = z.reshape(z.shape[:-1] + (heads, hd))
            return z.movedim(-2, -3).reshape((-1, heads, z.shape[-3], hd))

        core = attention_core if self.fused and not plain else attention_core_plain
        qh, kh, vh = split(q), split(k), split(v)
        seed = rank_seed(seed, qh.shape[0] * self.num_heads * qh.shape[2] * kh.shape[2], index)
        out = core(qh, kh, vh, bias, seed, rate, **mask)
        out = out.transpose(1, 2).reshape(q.shape)   # a view where out has q's layout
        if tp:
            return finish(_dense(out, wo, None, self.dtype))
        return _dense(out, wo, bo, self.dtype)


class WindowAttention(nn.Module):
    """Local spatial window self-attention over (N, T, H, W, C): the 2D sine
    position goes on q/k only, or with ``rpe`` a learned relative-position
    bias (``rpe_table``, ((2w-1)^2, heads)) goes on the logits instead."""

    def __init__(self, dim: int, num_heads: int, window: int = 4,
                 fused: bool = False, fused_full: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 rpe: bool = False):
        super().__init__()
        self.window, self.rpe = window, rpe
        self.attn = MultiHeadAttention(dim, num_heads, fused, fused_full,
                                       dtype, dropout)
        if rpe:
            self.rpe_table = nn.Parameter(
                torch.zeros((2 * window - 1) ** 2, num_heads))
            onehot = np.eye((2 * window - 1) ** 2, dtype=np.float32)[
                relative_position_index(window).reshape(-1)]
            self.register_buffer("rpe_onehot", torch.from_numpy(onehot),
                                 persistent=False)

    def rpe_bias(self) -> torch.Tensor:
        """(heads, L, L) f32 bias gathered from ``rpe_table``. The gather is
        a one-hot product summed in a fixed order: exact forward, and a
        table gradient that is the same on every run (an index gather's
        backward would scatter-add with atomics on the card)."""
        l = self.window * self.window
        bias = (self.rpe_onehot[:, :, None] * self.rpe_table[None]).sum(1)
        return bias.reshape(l, l, -1).permute(2, 0, 1).contiguous()

    def forward(self, x, pos2d, *, value=None, ln=None, residual: bool = False,
                branch_scale=None, generator=None):
        """``pos2d``: (window*window, C). ``value``: (N, T, H, W, C), the v
        input when it differs from x (the NAR decoder). ``ln``: pass the
        raw pre-norm x and the norm folds into the fused kernel; ``residual``
        then returns the whole sublayer x + branch_scale * attn(LN(x)), with
        ``branch_scale`` a per-frame (N*T,) f32 factor (the DropPath mask)
        or None."""
        n, t, h, w, c = x.shape
        tokens = self.window * self.window
        bias = self.rpe_bias() if self.rpe else None

        def to_windows(z):
            z, offs = pad_to_window(z.reshape(n * t, h, w, c), self.window)
            return window_partition(z, self.window), offs, z.shape[1:3]

        xw, offs, padded_hw = to_windows(x)
        if ln is not None:
            if value is not None:
                raise ValueError("ln folding needs value=None")
            win_scale = None
            if residual and branch_scale is not None:
                # per frame -> per window (frame-major partition order)
                win_scale = branch_scale.float().repeat_interleave(
                    xw.shape[0] // (n * t))
            out = self.attn(xw, xw, xw, bias=bias, ln=ln,
                            qk_pos=None if self.rpe else pos2d.reshape(tokens, c),
                            residual=residual, branch_scale=win_scale,
                            generator=generator)
        else:
            qk = xw if self.rpe else xw + pos2d.reshape(1, tokens, c).to(xw.dtype)
            vw = xw if value is None else to_windows(value)[0]
            out = self.attn(qk, qk, vw, bias=bias, generator=generator)
        out = window_reverse(out, self.window, padded_hw)
        return unpad_from_window(out, (h, w), offs).reshape(n, t, h, w, c)


class TemporalAttention(nn.Module):
    """Attention over the time axis at every (n, h, w) position; ``causal``
    adds the static mask as a -1e30 (1, T, T) bias (self-attention only).
    ``fused_full`` (with ``fused``): a self-attention call with ``ln`` runs
    the whole sublayer, its LayerNorm folded in, in ``fused_attention_ln``
    (``layers.py:503-508``).

    ``sequence_parallel`` (``layers.py:452-491``'s ``sp``): on a mesh with a
    model axis (``sp`` set by ``shard_transformer``) each model rank runs
    the attention, every head, over a contiguous share of the N·HW columns
    (flattened: the JAX package shards the HW axis, the port the flattened
    one, so a rank's kernel-mask elements are one contiguous range), and
    the shares are gathered after."""

    def __init__(self, dim: int, num_heads: int, causal: bool = False,
                 fused: bool = False, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, fused_full: bool = False,
                 sequence_parallel: bool = False):
        super().__init__()
        self.causal = causal
        self.sequence_parallel = sequence_parallel
        self.sp: Optional[Tuple[int, int]] = None     # (M, m) on a model axis
        self.attn = MultiHeadAttention(dim, num_heads, fused, fused_full, dtype,
                                       dropout)

    def forward(self, x, pos_q, generator=None, *, kv=None, pos_k=None, ln=None):
        """x: (N, T, H, W, C), ``pos_q``: (T, C). Cross-attention
        (``layers.py:510-518``): keys and values from ``kv`` (N, Tk, H, W,
        C), ``pos_k`` (Tk, C) on the keys. ``ln``: the sublayer's LayerNorm
        (scale, bias) with x the raw pre-norm input (self-attention only):
        q/k = LN(x) + pos_q, v = LN(x)."""
        n, t, h, w, c = x.shape
        sp = self.sp is not None
        if sp and (n * h * w) % self.sp[0]:
            raise ValueError(f"sequence_parallel: {n * h * w} temporal columns (N {n} x "
                             f"{h * w}) do not split over mesh.model={self.sp[0]}")

        def cols(y):   # (N, T, H, W, C) -> (N, H*W, T, C), or this rank's share of the rows
            y = y.permute(0, 2, 3, 1, 4).reshape(n, h * w, y.shape[1], c)
            return scatter_model(y.reshape(n * h * w, y.shape[2], c)) if sp else y

        def back(out):
            out = gather_model(out) if sp else out
            return out.reshape(n, h, w, t, c).permute(0, 3, 1, 2, 4)

        bias = None
        if self.causal and kv is None:   # -1e30 above the diagonal
            bias = torch.full((t, t), -1e30, device=x.device).triu(1)[None]
        xc = cols(x)
        if ln is not None:
            if kv is not None:
                raise ValueError("ln folding needs self-attention (kv=None)")
            return back(self.attn(xc, xc, xc, bias=bias, ln=ln, qk_pos=pos_q,
                                  generator=generator, sp=sp))
        q = xc + pos_q[None].to(x.dtype)
        if kv is None:
            k, v = q, xc
        else:
            v = cols(kv)
            k = v + pos_k[None].to(x.dtype)
        return back(self.attn(q, k, v, bias=bias, generator=generator, sp=sp))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels of
    an NCHW tensor (``layers.py:625-627``), with flax's arithmetic: f32
    statistics, the variance as E[x^2] - E[x]^2 clamped at 0 (biased), y =
    (x - mean) * (rsqrt(var + eps) * scale) + bias cast to ``dtype``. In
    train mode it normalises with the batch statistics (gradients flow
    through them) and sets running = 0.9 running + 0.1 batch, the variance
    biased too (torch's ``BatchNorm2d`` keeps the unbiased one); in eval
    mode it uses the running statistics. Under W > 1 data ranks the
    train-mode statistics are the global batch's: the per-channel sums of x
    and x^2 and the count, all-reduced together through autograd over the
    data group (the backward sums their gradients over it), so every data
    rank's running statistics update identically. Under tensor parallelism
    a BatchNorm over the conv FFN's split hidden holds its rank's channels
    (their statistics need no other model rank's)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        view = lambda v: v[:, None, None]
        if self.training:
            x32 = x.float()
            if data_size() > 1:
                mean, sq = _global_moments(x32)
            else:
                mean, sq = x32.mean((0, 2, 3)), (x32 * x32).mean((0, 2, 3))
            var = torch.clamp(sq - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - view(mean)) * view(mul) + view(self.bias)
        return y.to(self.dtype)


def _global_moments(x32: torch.Tensor):
    """(E[x], E[x^2]) per channel of an NCHW tensor over every data rank's
    rows: one all-reduce of the sums and the count."""
    c = x32.shape[1]
    count = x32.new_full((1,), x32.numel() / c)
    total = all_reduce_sum(torch.cat([x32.sum((0, 2, 3)),
                                      (x32 * x32).sum((0, 2, 3)), count]))
    n = total[2 * c]
    return total[:c] / n, total[c:2 * c] / n


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(epsilon=1e-5)`` over the channels of an NCHW
    tensor: ``groups`` groups of C // groups channels, f32 statistics over
    (group channels, H, W) with the biased variance, the per-channel affine,
    the result cast to ``dtype``. No running statistics: train and eval
    mode are the same."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % groups:
            raise ValueError(f"{channels} channels do not split into {groups} groups")
        self.groups, self.eps, self.dtype = groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.group_norm(x.float(), self.groups, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class MlpDWBN(nn.Module):
    """HRFormer conv feed-forward: 1x1 -> norm -> GELU -> depthwise 3x3 ->
    norm -> GELU -> drop -> 1x1 -> norm -> GELU -> drop (exact erf GELU;
    ``layers.py:686-696``). ``norm="layer"``: LayerNormHWC, whose affine
    binds to (h, w) (FAR blocks, the NAR decoder); ``norm="batch"``:
    :class:`BatchNorm` (the NAR encoder).

    ``fused_dw`` (LayerNorm flavour only; ignored for BatchNorm, as
    ``layers.py:632``): the chain between the two 1x1 products runs in the
    ``fused_dw_chain`` kernel (A&S GELU, dropout in-kernel from a drawn
    seed); fc1 and fc2 stay channels-last products outside it, then norm3
    -> GELU -> drop (``layers.py:632-658``). ``fused_ln`` (LayerNorm flavour
    only, after ``fused_dw`` in precedence, as ``layers.py:660``): fc1 ->
    norm1 -> GELU and fc2 -> norm3 -> GELU each run in the ``conv_ln_gelu``
    kernel (A&S GELU); the depthwise conv, norm2, the exact GELU and both
    dropouts stay outside it (``layers.py:660-684``). Same parameters on
    every route."""

    def __init__(self, dim: int, hidden_dim: int, h: int, w: int,
                 norm: str = "layer", dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, fused_dw: bool = False,
                 fused_ln: bool = False):
        super().__init__()
        if norm not in ("layer", "batch"):
            raise ValueError(f"MlpDWBN norm must be 'layer' or 'batch', got {norm!r}")
        make_norm = ((lambda ch: LayerNormHWC((ch, h, w), dtype=dtype))
                     if norm == "layer" else
                     (lambda ch: BatchNorm(ch, dtype=dtype)))
        self.dtype = dtype
        self.fused_dw = fused_dw and norm == "layer"
        self.fused_ln = fused_ln and norm == "layer" and not self.fused_dw
        self.kernels = "cuda"            # see use_kernels
        self.fc1 = nn.Conv2d(dim, hidden_dim, 1)
        self.norm1 = make_norm(hidden_dim)
        self.dw3x3 = nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1,
                               groups=hidden_dim)
        self.norm2 = make_norm(hidden_dim)
        self.fc2 = nn.Conv2d(hidden_dim, dim, 1)
        self.norm3 = make_norm(dim)
        self.drop = Dropout(dropout)
        self.tp: Optional[Tuple[int, int]] = None     # (M, m) after shard()

    def shard(self, size: int, rank: int) -> None:
        """Hold model rank ``rank``'s share of the hidden channels (fc1's
        and dw3x3's outputs, fc2's inputs, norm1's and norm2's channels;
        the parameters are cut by ``shard_transformer``). Every route runs
        on the share: the ``fused_ln`` route's kernels #11/#12 as the
        column- and row-parallel steps of their tiled route."""
        hidden = self.fc1.out_channels
        if hidden % size:
            raise ValueError(f"the conv FFN's {hidden} hidden channels do not split "
                             f"over mesh.model={size}")
        self.tp = (size, rank)
        local = hidden // size
        self.fc1.out_channels = self.dw3x3.in_channels = self.fc2.in_channels = local
        self.dw3x3.out_channels = self.dw3x3.groups = local
        for norm in (self.norm1, self.norm2):
            if isinstance(norm, LayerNormHWC):
                norm.shard(size, rank)

    def _conv(self, conv: nn.Conv2d, y):
        return F.conv2d(y, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                        conv.stride, conv.padding, groups=conv.groups)

    def _pointwise(self, conv: nn.Conv2d, y):
        """A 1x1 conv on channels-last y (..., C_in) in the compute dtype."""
        return F.linear(y, conv.weight[:, :, 0, 0].to(self.dtype),
                        conv.bias.to(self.dtype))

    def _fused_forward(self, x, generator):
        """The ``fused_dw`` route. Under tensor parallelism fc1 is
        column-parallel (x into the TP region), the chain runs on the rank's
        hidden channels with its LayerNorms over every rank's (``model``),
        and fc2 is row-parallel (its partial sums reduced, then the bias)."""
        n, t, h, w, c = x.shape
        hd = self.fc1.out_channels
        x = x.reshape(n * t, h * w, c).to(self.dtype)
        if self.tp is not None:
            x = enter_model(x)[0]
        y = self._pointwise(self.fc1, x)
        rate = self.drop.rate if self.training else 0.0
        seed = draw_seed(generator, x.device) if rate > 0.0 else 0

        def hwc(p):   # a LayerNormHWC affine (hd, h, w) -> (h w, hd)
            return p.permute(1, 2, 0).reshape(h * w, hd).contiguous()

        # (n t, h w, hidden), sample-major over the whole hidden
        m = 1 if self.tp is None else self.tp[0]
        seed = rank_seed(seed, y.numel() * m)
        chain = fused_dw_chain_plain if self.kernels == "plain" else fused_dw_chain
        y = chain(y.contiguous(), self.dw3x3.weight.reshape(hd, 9).t().contiguous(),
                  self.dw3x3.bias, hwc(self.norm1.weight), hwc(self.norm1.bias),
                  hwc(self.norm2.weight), hwc(self.norm2.bias), seed, w, rate, model=self.tp)
        if self.tp is not None:
            y = F.linear(y, self.fc2.weight[:, :, 0, 0].to(self.dtype))
            y = _row_parallel_out(y, self.fc2.bias, self.dtype)
        else:
            y = self._pointwise(self.fc2, y)
        y = y.reshape(n * t, h, w, c).permute(0, 3, 1, 2)
        y = self.drop(F.gelu(self.norm3(y)), generator)
        return y.permute(0, 2, 3, 1).reshape(n, t, h, w, c)

    def _conv_ln_forward(self, x, generator):
        """The ``fused_ln`` route. Under tensor parallelism fc1 is
        column-parallel (x into the TP region; norm1's statistics over
        every rank's hidden channels), the depthwise conv, norm2 and the
        hidden dropout run on the rank's hidden channels, and fc2 is
        row-parallel (the partial products summed over the model group
        before its bias, norm3 on the whole)."""
        n, t, h, w, c = x.shape
        fn = conv_ln_gelu_plain if self.kernels == "plain" else conv_ln_gelu

        def stage(conv: nn.Conv2d, norm: LayerNormHWC, z, rows):
            # z (n t, h w, C_in) -> gelu(norm(conv(z))) (n t, h w, C_out); the
            # LayerNormHWC affine (C_out, h, w) goes in as (h w, C_out)
            cout = conv.out_channels
            hwc = lambda p: p.permute(1, 2, 0).reshape(h * w, cout).contiguous()
            return fn(z.contiguous(), conv.weight[:, :, 0, 0].t().to(self.dtype).contiguous(),
                      conv.bias.float(), hwc(norm.weight), hwc(norm.bias), model=self.tp,
                      rows=rows)

        x = x.reshape(n * t, h * w, c).to(self.dtype)
        if self.tp is not None:
            x = enter_model(x)[0]
        y = stage(self.fc1, self.norm1, x, False)
        hd = y.shape[-1]
        y = y.reshape(n * t, h, w, hd).permute(0, 3, 1, 2)
        split = {} if self.tp is None else {"split": (1,) + self.tp}
        y = self.drop(F.gelu(self.norm2(self._conv(self.dw3x3, y))), generator, **split)
        y = stage(self.fc2, self.norm3, y.permute(0, 2, 3, 1).reshape(n * t, h * w, hd), True)
        return self.drop(y, generator).reshape(n, t, h, w, c)

    def forward(self, x, generator=None):
        if self.fused_dw:
            return self._fused_forward(x, generator)
        if self.fused_ln:
            return self._conv_ln_forward(x, generator)
        n, t, h, w, c = x.shape
        y = x.reshape(n * t, h, w, c).permute(0, 3, 1, 2).to(self.dtype)
        if self.tp is not None:     # the hidden split over the model ranks
            y = F.gelu(self.norm1(self._conv(self.fc1, enter_model(y)[0])))
            y = self.drop(F.gelu(self.norm2(self._conv(self.dw3x3, y))), generator,
                          split=(1,) + self.tp)
            y = F.conv2d(y, self.fc2.weight.to(self.dtype))
            y = (reduce_model(y) + self.fc2.bias.float()[:, None, None]).to(self.dtype)
        else:
            y = F.gelu(self.norm1(self._conv(self.fc1, y)))
            y = self.drop(F.gelu(self.norm2(self._conv(self.dw3x3, y))), generator)
            y = self._conv(self.fc2, y)
        y = self.drop(F.gelu(self.norm3(y)), generator)
        return y.permute(0, 2, 3, 1).reshape(n, t, h, w, -1)


class Mlp(nn.Module):
    """Linear feed-forward: linear2(drop(gelu(linear1(x))))
    (``layers.py:716-765``).

    ``fused`` with ``ln`` = (scale, bias) of the sublayer's leading
    LayerNorm and the raw x: LN + fc1 + GELU + dropout + fc2 run in the
    ``fused_ffn`` kernel (A&S GELU, hidden dropout in-kernel from a drawn
    seed; ``layers.py:736-757``). Same parameters either way."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 fused: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused = fused
        self.kernels = "cuda"            # see use_kernels
        self.linear1 = nn.Linear(dim, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, dim)
        self.drop = Dropout(dropout)
        self.tp: Optional[Tuple[int, int]] = None     # (M, m) after shard()

    def shard(self, size: int, rank: int) -> None:
        """Hold model rank ``rank``'s share of the hidden (linear1's outputs,
        linear2's inputs; the parameters are cut by ``shard_transformer``)."""
        if self.linear1.out_features % size:
            raise ValueError(f"the FFN's {self.linear1.out_features} hidden features do "
                             f"not split over mesh.model={size}")
        self.tp = (size, rank)

    def forward(self, x, generator=None, *,
                ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """``ln``: the fused route's (scale, bias) of the leading LayerNorm,
        with x the raw pre-norm input; the unfused route takes the normed x."""
        if self.fused:
            rate = self.drop.rate if self.training else 0.0
            seed = draw_seed(generator, x.device) if rate > 0.0 else 0
            dim = x.shape[-1]
            ls, lb = ln
            # the hidden dropout's row stride is the whole hidden's Hg; under
            # tensor parallelism the kernel holds columns m Hl .. (m+1) Hl
            hl = self.linear1.weight.shape[0]
            m_size, m_rank = self.tp or (1, 0)
            seed = rank_seed(seed, x.numel() // dim * hl * m_size)
            b2 = self.linear2.bias.float()
            if self.tp is not None:   # x, ls, lb into the TP region; b2 after the sum
                x, ls, lb = enter_model(x, ls, lb)
                b2 = torch.zeros_like(b2)
            fn = fused_ffn_plain if self.kernels == "plain" else fused_ffn
            out = fn(x.reshape(-1, dim).to(self.dtype).contiguous(),
                     self.linear1.weight.t().to(self.dtype).contiguous(),
                     self.linear1.bias.float(),
                     self.linear2.weight.t().to(self.dtype).contiguous(),
                     b2, ls.float(), lb.float(), seed, rate, hl * m_size, hl * m_rank)
            if self.tp is not None:
                out = _row_parallel_out(out, self.linear2.bias, self.dtype)
            return out.reshape(x.shape)
        if self.tp is not None:     # linear1 column-, linear2 row-parallel
            y = F.gelu(_linear(self.linear1, enter_model(x)[0], self.dtype))
            y = self.drop(y, generator, split=(-1,) + self.tp)
            return _row_parallel_out(_dense(y, self.linear2.weight, None, self.dtype),
                                     self.linear2.bias, self.dtype)
        y = self.drop(F.gelu(_linear(self.linear1, x, self.dtype)), generator)
        return _linear(self.linear2, y, self.dtype)


class DropPath(nn.Module):
    """Stochastic depth: drop the whole residual branch per sample (leading
    axis) with probability ``rate``, else scale it by 1 / (1 - rate)
    (``layers.py:699-713``); the identity in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = bernoulli_keep(x.shape[0], 1.0 - self.rate, generator, x.device)
        return _keep_scaled(x, keep.view((-1,) + (1,) * (x.ndim - 1)), self.rate)


class Dropout(nn.Module):
    """Element-wise dropout (flax ``nn.Dropout``): keep with probability
    1 - rate and scale by 1 / (1 - rate); the identity in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None,
                split: Optional[Tuple[int, int, int]] = None):
        """``split``: (dim, M, m) when x's ``dim`` is model rank m's share
        (:func:`bernoulli_keep`)."""
        if not self.training or self.rate == 0.0:
            return x
        keep = bernoulli_keep(x.shape, 1.0 - self.rate, generator, x.device, split)
        return _keep_scaled(x, keep, self.rate)
