"""Counter-hash PRNG of the kernels' in-kernel dropout.

Counterpart of ``vptr_tpu/ops/attention_core.py:65-116`` (``_hash_uniform``,
``_keep_mask``, ``dropout_keep_mask``), ``fused_window_attention.py:55-67``
(``_keep_mask_head``), ``fused_ffn.py:47-57`` and ``fused_dw_chain.py:44-60``.
A weight's keep decision is a pure function of (seed, element index), so a
kernel's backward regenerates its forward mask from the seed alone. The
attention kernels' element index is

    idx = ((b * H + h) * Tq + r) * Tk + c          (uint32, wrapping)

with ``b`` the global batch (or window) index and ``h`` the global head: a
call over heads h0 .. h0 + Hl - 1 of Hg (tensor parallelism) indexes
((b * Hg + h0 + h) * Tq + r) * Tk + c (``mask_heads``, ``head0``); the
feed-forward kernels
index their hidden by row * H + col (:func:`ffn_keep_mask`) and the
dw chain by (sample * HW + r) * C + col (:func:`dw_keep_mask`), and a
call over hidden columns c0 .. c0 + Hl - 1 of Hg by row * Hg + c0 + col
(``mask_cols``, ``col0``). The device
function with the same arithmetic is ``csrc/hash_dropout.cuh``; this module
is its torch twin, bit-equal to the JAX functions, used by the plain
versions and the tests.

torch has no general uint32 arithmetic, so the twin computes in int64 and
masks to 32 bits after every multiply and add.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

GOLDEN = 0x9E3779B9        # 2^32 / golden ratio
MIX1 = 0x7FEB352D          # murmur3-variant finalizer constants
MIX2 = 0x846CA68B
_U32 = 0xFFFFFFFF

Seed = Union[int, torch.Tensor]


def seed_u32(seed: Seed, device=None) -> torch.Tensor:
    """An int32 seed (Python int or one-element tensor) as its uint32 bit
    pattern in an int64 tensor (a negative int32 wraps, like
    ``.astype(jnp.uint32)``)."""
    s = torch.as_tensor(seed, device=device).reshape(()).to(torch.int64)
    return s & _U32


def _mul32(a, m: int):
    """(a * m) mod 2^32 for 0 <= a, m < 2^32 without leaving int64: the
    constant is split in 16-bit halves so no partial product overflows."""
    lo, hi = m & 0xFFFF, m >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def hash_uniform(idx: torch.Tensor, seed: Seed) -> torch.Tensor:
    """uniform[0, 1) float32 of the uint32 element index ``idx`` (int64
    tensor holding values < 2^32) and ``seed``: the murmur3-style finalizer,
    then the top 24 bits as the mantissa."""
    x = (idx + _mul32(seed_u32(seed, idx.device), GOLDEN)) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, MIX2)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def element_index(b: int, h: int, tq: int, tk: int, *,
                  tq_index: Optional[int] = None, tk_index: Optional[int] = None,
                  mask_heads: Optional[int] = None, head0: int = 0,
                  device=None) -> torch.Tensor:
    """(b, h, tq, tk) int64 tensor of the uint32 index ((b*H' + h0 + h)*Tq'
    + r)*Tk' + c. ``tq_index`` and ``tk_index`` (default tq, tk) are the Tq'
    and Tk' of the index when they differ from the tensor's extent: the
    window kernel indexes a window's tokens by the padded token count
    (:func:`padded_tokens`) while only the first L rows and columns exist.
    ``mask_heads`` (H', default h) and ``head0`` (h0): the h heads are heads
    h0 .. h0 + h - 1 of H'."""
    tqi = tq if tq_index is None else tq_index
    tki = tk if tk_index is None else tk_index
    hg = h if mask_heads is None else mask_heads
    if head0 < 0 or head0 + h > hg:
        raise ValueError(f"heads {head0} .. {head0 + h - 1} are not heads of {hg}")
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    bi = ar(b).view(b, 1, 1, 1)
    hi = ar(h).view(1, h, 1, 1) + head0
    r = ar(tq).view(1, 1, tq, 1)
    c = ar(tk).view(1, 1, 1, tk)
    idx = (_mul32(bi, hg) + hi) & _U32
    idx = (_mul32(idx, tqi) + r) & _U32
    return (_mul32(idx, tki) + c) & _U32


def dropout_keep_mask(seed: Seed, b: int, h: int, t: int, rate: float,
                      tk: Optional[int] = None, device=None,
                      mask_heads: Optional[int] = None, head0: int = 0) -> torch.Tensor:
    """(B, H, T, Tk) boolean keep mask for the whole tensor (``tk`` defaults
    to ``t``), bit-equal to ``vptr_tpu.ops.attention_core.dropout_keep_mask``;
    with ``mask_heads`` and ``head0`` the rows of heads h0 .. h0 + H - 1 of
    that call's ``mask_heads``."""
    tk = t if tk is None else tk
    idx = element_index(b, h, t, tk, mask_heads=mask_heads, head0=head0,
                        device=device)
    return hash_uniform(idx, seed) >= torch.tensor(rate, dtype=torch.float32)


def padded_tokens(tokens: int, dtype: torch.dtype) -> int:
    """Token count the window kernel's dropout index runs over: L rounded up
    to 16 for bf16 and to 8 for f32 and f16 (the TPU kernel pads the token
    axis to a sublane multiple before it builds the mask, ``_ln_pad``: 16
    for bfloat16, 8 for every other dtype)."""
    sub = 16 if dtype == torch.bfloat16 else 8
    return -(-tokens // sub) * sub


def window_keep_mask(seed: Seed, windows: int, heads: int, tokens: int,
                     rate: float, dtype: torch.dtype, device=None,
                     mask_heads: Optional[int] = None, head0: int = 0) -> torch.Tensor:
    """(BW, H, L, L) keep mask of the window kernels: the element index runs
    over the padded token count of ``dtype`` (and over the global heads
    with ``mask_heads`` and ``head0``)."""
    lp = padded_tokens(tokens, dtype)
    idx = element_index(windows, heads, tokens, tokens, tq_index=lp,
                        tk_index=lp, mask_heads=mask_heads, head0=head0,
                        device=device)
    return hash_uniform(idx, seed) >= torch.tensor(rate, dtype=torch.float32)


def column_index(rows: int, cols: int, mask_cols: Optional[int] = None,
                 col0: int = 0, device=None) -> torch.Tensor:
    """(rows, cols) int64 tensor of the uint32 index row * C' + c0 + col:
    the ``cols`` columns are columns c0 .. c0 + cols - 1 of ``mask_cols``
    (C', default ``cols``)."""
    cg = cols if mask_cols is None else mask_cols
    if col0 < 0 or col0 + cols > cg:
        raise ValueError(f"columns {col0} .. {col0 + cols - 1} are not columns of {cg}")
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    return (_mul32(ar(rows)[:, None] & _U32, cg) + col0 + ar(cols)[None, :]) & _U32


def ffn_keep_mask(seed: Seed, rows: int, cols: int, rate: float,
                  device=None, mask_cols: Optional[int] = None,
                  col0: int = 0) -> torch.Tensor:
    """(rows, cols) hidden-dropout keep mask of the fused FFN kernel: the
    element index is row * cols + col (``fused_ffn.py:47-57``); with
    ``mask_cols`` and ``col0`` the columns c0 .. c0 + cols - 1 of that
    call's ``mask_cols``."""
    idx = column_index(rows, cols, mask_cols, col0, device)
    return hash_uniform(idx, seed) >= torch.tensor(rate, dtype=torch.float32)


def dw_keep_mask(seed: Seed, n: int, hw: int, c: int, rate: float,
                 device=None, mask_cols: Optional[int] = None,
                 col0: int = 0) -> torch.Tensor:
    """(N, HW, C) keep mask of the fused dw-chain kernel: the element index
    is (sample * HW + r) * C + col with r over the (h, w) positions in
    row-major order (``fused_dw_chain.py:44-60``); with ``mask_cols`` and
    ``col0`` the channels c0 .. c0 + C - 1 of that call's ``mask_cols``."""
    idx = column_index(n * hw, c, mask_cols, col0, device).view(n, hw, c)
    return hash_uniform(idx, seed) >= torch.tensor(rate, dtype=torch.float32)


def apply_dropout(w: torch.Tensor, keep: Optional[torch.Tensor],
                  rate: float) -> torch.Tensor:
    """``where(keep, w / (1 - rate), 0)`` in f32 (a division, as the TPU
    kernels: multiplying by the reciprocal is not bit-equal)."""
    if keep is None or rate <= 0.0:
        return w
    return torch.where(keep, w / torch.tensor(1.0 - rate, dtype=w.dtype),
                       torch.zeros((), dtype=w.dtype, device=w.device))
