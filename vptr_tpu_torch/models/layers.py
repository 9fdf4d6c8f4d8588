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
from vptr_tpu_torch.parallel.mesh import all_reduce_sum, host_id, num_hosts, rank_seed

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
                   device) -> torch.Tensor:
    """Boolean mask of ``shape`` (an int or a tuple), True with probability
    ``keep``. Under W > 1 ranks the leading axis is this rank's b rows of
    the global batch: the mask of the global shape (W·b, ...) is drawn and
    rows r·b .. (r+1)·b kept, so every rank draws what one process at the
    global batch draws."""
    if generator is None:
        raise ValueError("a training forward with dropout needs a generator")
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    w, b, r = num_hosts(), shape[0], host_id()
    full = torch.rand((w * b,) + shape[1:], generator=generator, device=device)
    return full[r * b:(r + 1) * b] < keep


def _keep_scaled(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """where(keep, x / (1 - rate), 0) with the divisor in x's dtype, as a
    JAX Python-float divisor is (a weak type)."""
    div = torch.tensor(1.0 - rate, dtype=x.dtype)
    return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype, device=x.device))


def _linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """nn.Dense in ``dtype``: input, kernel and bias cast to it."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


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
    (``layers.py:522-543``; the JAX module stores its affine (H, W, C))."""


class MultiHeadAttention(nn.Module):
    """Self-attention with separate q/k/v/out projections over (..., L, C)."""

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
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def _window_seed(self, seed, windows: int, tokens: int):
        """The seed of this rank's ``windows`` of a window-kernel call (#1,
        #5): its mask index runs over the padded token count."""
        lp = padded_tokens(tokens, self.dtype)
        return rank_seed(seed, windows * self.num_heads * lp * lp)

    def _dense_params(self):
        """(W (in, out) in dtype, b f32) for q, k, v, out — the fused
        kernel's operand layout (the JAX Dense kernel layout)."""
        return [(lin.weight.t().to(self.dtype).contiguous(), lin.bias.float())
                for lin in (self.q_proj, self.k_proj, self.v_proj,
                            self.out_proj)]

    def forward(self, q_in, k_in, v_in, *, bias=None,
                ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                qk_pos=None, residual: bool = False, branch_scale=None,
                generator: Optional[torch.Generator] = None):
        """``ln``: (scale, bias) of the sublayer's leading LayerNorm; callers
        then pass the raw x as q_in = k_in = v_in and q/k = LN(x) + qk_pos,
        v = LN(x). ``residual`` (fused LN route only) returns x +
        branch_scale * attn(...), ``branch_scale`` (leading batch,) f32 or
        None. ``bias``: None or (1 | H, Lq, Lk) additive logits. Without
        ``ln``, q_in = k_in of v_in's shape takes the two-stream kernel on
        the fused_full route."""
        plain = self.kernels == "plain"
        rate = self.dropout if self.training else 0.0
        seed = draw_seed(generator, q_in.device) if rate > 0.0 else 0
        if ln is not None:
            if not (q_in is k_in and k_in is v_in):
                raise ValueError("ln folding expects q_in = k_in = v_in = x")
            if self.fused and self.fused_full:
                (wq, bq), (wk, bk), (wv, bv), (wo, bo) = self._dense_params()
                lead, l = q_in.shape[:-2], q_in.shape[-2]
                xf = q_in.reshape(-1, l, self.dim).to(self.dtype).contiguous()
                seed = self._window_seed(seed, xf.shape[0], l)
                args = (xf, wq, bq, wk, bk, wv, bv, wo, bo, ln[0].float(),
                        ln[1].float(),
                        None if qk_pos is None else qk_pos.float().contiguous(),
                        bias)
                scale = branch_scale if residual else None
                if plain:
                    out = fused_attention_ln_plain(
                        *args, seed, self.num_heads, rate, scale, residual)
                elif residual:
                    out = fused_attention_ln_res(*args, scale, seed,
                                                 self.num_heads, rate)
                else:
                    out = fused_attention_ln(*args, seed, self.num_heads, rate)
                return out.reshape(lead + (l, self.dim))
            xn = F.layer_norm(q_in.float(), (self.dim,), ln[0], ln[1],
                              1e-5).to(self.dtype)
            q_in = k_in = xn + qk_pos.to(self.dtype) if qk_pos is not None else xn
            v_in = xn
            if residual:
                raise NotImplementedError(
                    "the residual-folded sublayer runs on the fused route only")

        if (self.fused and self.fused_full and q_in is k_in
                and v_in.shape == q_in.shape and q_in.shape[-1] == self.dim):
            # the whole sublayer with v from its own input (kernel #5)
            (wq, bq), (wk, bk), (wv, bv), (wo, bo) = self._dense_params()
            lead, l = q_in.shape[:-2], q_in.shape[-2]
            flat = lambda z: z.reshape(-1, l, self.dim).to(self.dtype).contiguous()
            fn = fused_attention_plain if plain else fused_attention
            xqk = flat(q_in)
            out = fn(xqk, flat(v_in), wq, bq, wk, bk, wv, bv, wo, bo, bias,
                     self._window_seed(seed, xqk.shape[0], l), self.num_heads, rate)
            return out.reshape(lead + (l, self.dim))

        hd = self.dim // self.num_heads
        q = _linear(self.q_proj, q_in, self.dtype)
        k = _linear(self.k_proj, k_in, self.dtype)
        v = _linear(self.v_proj, v_in, self.dtype)

        def heads(z):  # (..., L, C) -> (B, H, L, hd): a view of the projection
            z = z.reshape(z.shape[:-1] + (self.num_heads, hd))
            return z.movedim(-2, -3).reshape((-1, self.num_heads, z.shape[-3], hd))

        core = attention_core if self.fused and not plain else attention_core_plain
        qh, kh, vh = heads(q), heads(k), heads(v)
        seed = rank_seed(seed, qh.shape[0] * self.num_heads * qh.shape[2] * kh.shape[2])
        out = core(qh, kh, vh, bias, seed, rate)
        out = out.transpose(1, 2).reshape(q.shape)   # a view where out has q's layout
        return _linear(self.out_proj, out, self.dtype)


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
    (``layers.py:503-508``)."""

    def __init__(self, dim: int, num_heads: int, causal: bool = False,
                 fused: bool = False, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, fused_full: bool = False):
        super().__init__()
        self.causal = causal
        self.attn = MultiHeadAttention(dim, num_heads, fused, fused_full, dtype,
                                       dropout)

    def forward(self, x, pos_q, generator=None, *, kv=None, pos_k=None, ln=None):
        """x: (N, T, H, W, C), ``pos_q``: (T, C). Cross-attention
        (``layers.py:510-518``): keys and values from ``kv`` (N, Tk, H, W,
        C), ``pos_k`` (Tk, C) on the keys. ``ln``: the sublayer's LayerNorm
        (scale, bias) with x the raw pre-norm input (self-attention only):
        q/k = LN(x) + pos_q, v = LN(x)."""
        n, t, h, w, c = x.shape

        def cols(y):   # (N, T, H, W, C) -> (N, H*W, T, C)
            return y.permute(0, 2, 3, 1, 4).reshape(n, h * w, y.shape[1], c)

        bias = None
        if self.causal and kv is None:   # -1e30 above the diagonal
            bias = torch.full((t, t), -1e30, device=x.device).triu(1)[None]
        xc = cols(x)
        if ln is not None:
            if kv is not None:
                raise ValueError("ln folding needs self-attention (kv=None)")
            out = self.attn(xc, xc, xc, bias=bias, ln=ln, qk_pos=pos_q,
                            generator=generator)
            return out.reshape(n, h, w, t, c).permute(0, 3, 1, 2, 4)
        q = xc + pos_q[None, None].to(x.dtype)
        if kv is None:
            k, v = q, xc
        else:
            v = cols(kv)
            k = v + pos_k[None, None].to(x.dtype)
        out = self.attn(q, k, v, bias=bias, generator=generator)
        return out.reshape(n, h, w, t, c).permute(0, 3, 1, 2, 4)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels of
    an NCHW tensor (``layers.py:625-627``), with flax's arithmetic: f32
    statistics, the variance as E[x^2] - E[x]^2 clamped at 0 (biased), y =
    (x - mean) * (rsqrt(var + eps) * scale) + bias cast to ``dtype``. In
    train mode it normalises with the batch statistics (gradients flow
    through them) and sets running = 0.9 running + 0.1 batch, the variance
    biased too (torch's ``BatchNorm2d`` keeps the unbiased one); in eval
    mode it uses the running statistics. Under W > 1 ranks the train-mode
    statistics are the global batch's: the per-channel sums of x and x^2
    and the count, all-reduced together through autograd (the backward
    sums their gradients over the ranks), so every rank's running
    statistics update identically."""

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
            if num_hosts() > 1:
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
    """(E[x], E[x^2]) per channel of an NCHW tensor over every rank's rows:
    one all-reduce of the sums and the count."""
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

    def _conv(self, conv: nn.Conv2d, y):
        return F.conv2d(y, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                        conv.stride, conv.padding, groups=conv.groups)

    def _pointwise(self, conv: nn.Conv2d, y):
        """A 1x1 conv on channels-last y (..., C_in) in the compute dtype."""
        return F.linear(y, conv.weight[:, :, 0, 0].to(self.dtype),
                        conv.bias.to(self.dtype))

    def _fused_forward(self, x, generator):
        n, t, h, w, c = x.shape
        hd = self.fc1.out_channels
        y = self._pointwise(self.fc1, x.reshape(n * t, h * w, c).to(self.dtype))
        rate = self.drop.rate if self.training else 0.0
        seed = draw_seed(generator, x.device) if rate > 0.0 else 0

        def hwc(p):   # a LayerNormHWC affine (hd, h, w) -> (h w, hd)
            return p.permute(1, 2, 0).reshape(h * w, hd).contiguous()

        seed = rank_seed(seed, y.numel())         # (n t, h w, hd), sample-major
        chain = fused_dw_chain_plain if self.kernels == "plain" else fused_dw_chain
        y = chain(y.contiguous(), self.dw3x3.weight.reshape(hd, 9).t().contiguous(),
                  self.dw3x3.bias, hwc(self.norm1.weight), hwc(self.norm1.bias),
                  hwc(self.norm2.weight), hwc(self.norm2.bias), seed, w, rate)
        y = self._pointwise(self.fc2, y).reshape(n * t, h, w, c).permute(0, 3, 1, 2)
        y = self.drop(F.gelu(self.norm3(y)), generator)
        return y.permute(0, 2, 3, 1).reshape(n, t, h, w, c)

    def _conv_ln_forward(self, x, generator):
        n, t, h, w, c = x.shape
        fn = conv_ln_gelu_plain if self.kernels == "plain" else conv_ln_gelu

        def stage(conv: nn.Conv2d, norm: LayerNormHWC, z):
            # z (n t, h w, C_in) -> gelu(norm(conv(z))) (n t, h w, C_out); the
            # LayerNormHWC affine (C_out, h, w) goes in as (h w, C_out)
            cout = conv.out_channels
            hwc = lambda p: p.permute(1, 2, 0).reshape(h * w, cout).contiguous()
            return fn(z.contiguous(), conv.weight[:, :, 0, 0].t().to(self.dtype).contiguous(),
                      conv.bias.float(), hwc(norm.weight), hwc(norm.bias))

        y = stage(self.fc1, self.norm1, x.reshape(n * t, h * w, c).to(self.dtype))
        hd = y.shape[-1]
        y = y.reshape(n * t, h, w, hd).permute(0, 3, 1, 2)
        y = self.drop(F.gelu(self.norm2(self._conv(self.dw3x3, y))), generator)
        y = stage(self.fc2, self.norm3, y.permute(0, 2, 3, 1).reshape(n * t, h * w, hd))
        return self.drop(y, generator).reshape(n, t, h, w, c)

    def forward(self, x, generator=None):
        if self.fused_dw:
            return self._fused_forward(x, generator)
        if self.fused_ln:
            return self._conv_ln_forward(x, generator)
        n, t, h, w, c = x.shape
        y = x.reshape(n * t, h, w, c).permute(0, 3, 1, 2).to(self.dtype)
        y = F.gelu(self.norm1(self._conv(self.fc1, y)))
        y = self.drop(F.gelu(self.norm2(self._conv(self.dw3x3, y))), generator)
        y = self.drop(F.gelu(self.norm3(self._conv(self.fc2, y))), generator)
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

    def forward(self, x, generator=None, *,
                ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """``ln``: the fused route's (scale, bias) of the leading LayerNorm,
        with x the raw pre-norm input; the unfused route takes the normed x."""
        if self.fused:
            rate = self.drop.rate if self.training else 0.0
            seed = draw_seed(generator, x.device) if rate > 0.0 else 0
            dim = x.shape[-1]
            seed = rank_seed(seed, x.numel() // dim * self.linear1.out_features)
            fn = fused_ffn_plain if self.kernels == "plain" else fused_ffn
            out = fn(x.reshape(-1, dim).to(self.dtype).contiguous(),
                     self.linear1.weight.t().to(self.dtype).contiguous(),
                     self.linear1.bias.float(),
                     self.linear2.weight.t().to(self.dtype).contiguous(),
                     self.linear2.bias.float(), ln[0].float(), ln[1].float(),
                     seed, rate)
            return out.reshape(x.shape)
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

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = bernoulli_keep(x.shape, 1.0 - self.rate, generator, x.device)
        return _keep_scaled(x, keep, self.rate)
