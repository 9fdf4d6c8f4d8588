"""Fused attention sublayers over short token sequences (window attention).

Counterpart of ``vptr_tpu/ops/fused_window_attention.py``, whose four TPU
kernels are joined in pairs by ``jax.custom_vjp``:

    out = out_proj(attn(q/k = LN(x) + pos, v = LN(x)))       # fused_attention_ln
    out = x + scale * out_proj(attn(...))                    # fused_attention_ln_res
    out = out_proj(attn(q/k = x_qk, v = x_v))                # fused_attention

* ``fused_attention_ln`` / ``_res``: ``_fused_ln_forward`` (``_kernel_ln``,
  ``pl.pallas_call`` at :586) -> ``csrc/fused_window_attention_ln.cu``
  (kernel #1); ``_fused_ln_backward`` (:769) ->
  ``csrc/fused_window_attention_ln_bwd.cu`` (#3).
* ``fused_attention``: ``_fused_forward`` (``_kernel``, :239) ->
  ``csrc/fused_window_attention.cu`` (#5); ``_fused_backward`` (:386) ->
  ``csrc/fused_window_attention_bwd.cu`` (#6). The NAR decoder's window
  self-attention: q/k from LN(tgt) + query_pos, v from LN(tgt).

The kernels are CUDA C++ for sm_90a; #1/#5 share
``csrc/fused_window_attention.cuh`` and #3/#6
``csrc/fused_window_attention_bwd.cuh`` (a template flag folds the LN in),
whose notes say what bounds each on the card and what the design does
about that. Both directions' bf16 routes run their products on ``wgmma``
(``csrc/wg_rows.cuh``, ``csrc/wg_dw.cuh``) when C is a multiple of 8, and
other shapes, f32 and f16 on FMAs; :func:`kernel_route` and
:func:`backward_route` name the route. The forward's bf16 route is four
passes (LayerNorm rows; q, k, v; the attention per (window, head) on
``mma.sync``; the out projection with + bo, * scale, + x in its
epilogue) over scratch the wrapper allocates and frees when the call
returns.

* The wrappers are ``torch.autograd.Function``s: for CUDA tensors they
  launch the kernels (or raise), for CPU tensors they take the plain
  versions (``*_plain`` forward, ``*_backward_plain`` backward).
* ``fused_attention_ln.launches`` / ``.bwd_launches`` count calls of #1
  and #3 by either LN wrapper (one a call, however many passes it runs),
  ``fused_attention.launches`` / ``.bwd_launches`` of #5 and #6, and
  nothing else; ``.launches_by_route`` / ``.bwd_launches_by_route`` split
  them by route ("wgmma", "fma").
* Weights are (C_in, C_out) like the JAX Dense kernels, in the compute
  dtype; biases, the LN affine, ``pos`` and ``scale`` are f32. Gradients
  come back in each operand's dtype; ``pos`` (a sine table) and ``scale``
  (a DropPath mask) get zero gradients, as in the JAX package.
* Attention-weight dropout is the counter hash of ``ops/dropout.py``; its
  element index runs over the padded token count (:func:`padded_tokens`),
  as the TPU kernels pad the token axis before building their masks.
* A head subset (tensor parallelism): with ``num_heads`` H of ``mask_heads``
  Hg starting at ``head0`` h0, Wq, Wk, Wv are (C, Cl) and Wo (Cl, C), Cl = H
  hd the inner width (hd = Cl / H); the call computes those heads' share of
  the sublayer, out = [a_h0 .. a_h0+H-1] Wo + bo, whose sum over the
  subsets (with bo added once) is the whole call's output. The mask is the
  whole call's rows of those heads; the gradients of x (and of ls, lb) are
  the subset's shares, dbo the whole column sum of g.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from vptr_tpu_torch.ops import _build
from vptr_tpu_torch.ops.attention_core import (
    _check_heads,
    _dropout_args,
    needs_grad,
    q_scale,
    seed_tensor,
)
from vptr_tpu_torch.ops.dropout import (
    Seed,
    apply_dropout,
    padded_tokens,
    window_keep_mask,
)

MAX_TOKENS = 32
MAX_HEAD_DIM = 128
LN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("wgmma", "fma")


def _heads_attention(q, k, v, bias, seed, num_heads, dropout_rate, mask_heads=None,
                     head0=0):
    """Per-head attention of the window kernels in plain PyTorch: q, k, v
    (B, L, Cl) projections in the compute dtype. Returns (qs, w, keep,
    w_drop rounded, split) with qs = q_h * scale rounded, w the f32
    pre-dropout weights, all (B, H, L, ...)."""
    b, l, c = q.shape
    hd = c // num_heads
    dt = q.dtype

    def split(z):  # (B, L, C) -> (B, H, L, hd)
        return z.reshape(b, l, num_heads, hd).transpose(1, 2)

    qs = split(q) * torch.tensor(q_scale(hd, dt), dtype=dt)
    logits = torch.matmul(qs.float(), split(k).float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1)
    keep = None
    if dropout_rate > 0.0:
        keep = window_keep_mask(seed, b, num_heads, l, dropout_rate, dt,
                                device=q.device, mask_heads=mask_heads, head0=head0)
    w_drop = apply_dropout(w, keep, dropout_rate).to(dt)
    return qs, w, keep, w_drop, split


def _sublayer_plain(xqk, xv, wq, bq, wk, bk, wv, bv, wo, bo, bias, seed,
                    num_heads, dropout_rate, mask_heads=None, head0=0):
    """The attention sublayer after its inputs, with the kernels' rounding
    points: q/k from ``xqk`` and v from ``xv`` (B, L, C, compute dtype),
    each rounded after its f32 bias add; per-head attention; the merged
    heads rounded; returns the output projection + bo in f32 (unrounded)."""
    dt = xqk.dtype
    b, l, _ = xqk.shape

    def proj(a, w, bb):
        return (torch.matmul(a.float(), w.float()) + bb.float()).to(dt)

    v = proj(xv, wv, bv)
    _, _, _, w_drop, split = _heads_attention(
        proj(xqk, wq, bq), proj(xqk, wk, bk), v, bias, seed, num_heads,
        dropout_rate, mask_heads, head0)
    o = torch.matmul(w_drop.float(), split(v).float()).to(dt)
    out = torch.matmul(o.transpose(1, 2).reshape(b, l, wq.shape[1]).float(), wo.float())
    return out + bo.float()


def fused_attention_plain(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo,
                          bias=None, seed: Seed = 0, num_heads: int = 8,
                          dropout_rate: float = 0.0, mask_heads=None,
                          head0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel #5 (``_reference_attention`` with
    the Pallas kernel's rounding points): q/k from ``x_qk``, v from
    ``x_v``, each rounded after its f32 bias add, q * scale rounded, f32
    softmax, dropout, weights rounded before the value product, the merged
    heads rounded, the output projection in f32 plus bo, rounded once."""
    return _sublayer_plain(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias,
                           seed, num_heads, dropout_rate, mask_heads,
                           head0).to(x_qk.dtype)


def fused_attention_ln_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb,
                             pos=None, bias=None, seed: Seed = 0,
                             num_heads: int = 8, dropout_rate: float = 0.0,
                             scale=None, res: bool = False, mask_heads=None,
                             head0: int = 0) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: xn rounded
    to x's dtype, q/k/v rounded after their f32 bias add, q * scale rounded,
    f32 softmax, dropout, weights rounded before the value product, the
    merged heads rounded, the output projection in f32 plus bo (then
    ``* scale`` per window and ``+ x`` when ``res``), rounded once."""
    dt = x.dtype
    c = x.shape[-1]
    x32 = x.float()
    xn = F.layer_norm(x32, (c,), ls.float(), lb.float(), LN_EPS).to(dt)
    xqk = xn + pos.to(dt) if pos is not None else xn
    out = _sublayer_plain(xqk, xn, wq, bq, wk, bk, wv, bv, wo, bo, bias, seed,
                          num_heads, dropout_rate, mask_heads, head0)
    if scale is not None:
        out = out * scale.float()[:, None, None]
    if res:
        out = out + x32
    return out.to(dt)


def _sublayer_backward_plain(xqk, xn, wq, bq, wk, bk, wv, bv, wo, bias, seed,
                             g2, bw, l, num_heads, dropout_rate, need_dbias,
                             mask_heads=None, head0=0):
    """The backward after the sublayer's inputs (mirrors ``_bwd_kernel``):
    ``xqk`` / ``xn`` (R, C) the q/k and v inputs in the compute dtype, ``g2``
    (R, C) f32 the output cotangent (times the branch scale). Recomputes
    q/k/v, the per-head softmax and mask; then the attention backward per
    head and the weight and bias gradients summed over all windows.
    Rounding points: w_drop rounded to the compute dtype before the dv
    product, the merged heads rounded before dWo; dq/dk/dv stay f32 into
    the dW products and into d(xqk) = dq Wq^T + dk Wk^T and d(xn) =
    dv Wv^T (both f32). Returns (dxqk, dxn, dwq, dbq, dwk, dbk, dwv, dbv,
    dwo, dbo, dbias): each dW in its weight's dtype, the vectors f32,
    dbias f32 in the bias's shape (or None)."""
    dt = xqk.dtype
    c = wq.shape[1]                  # the inner width Cl (C for every head)
    hd = c // num_heads

    def proj(a, w, bb):
        return (torch.matmul(a.float(), w.float()) + bb.float()).to(dt)

    q3, k3, v3 = (proj(xqk, wq, bq), proj(xqk, wk, bk), proj(xn, wv, bv))
    qs, w, keep, w_drop, split = _heads_attention(
        q3.reshape(bw, l, c), k3.reshape(bw, l, c), v3.reshape(bw, l, c),
        bias, seed, num_heads, dropout_rate, mask_heads, head0)
    vh = split(v3.reshape(bw, l, c)).float()
    attn = torch.matmul(w_drop.float(), vh).to(dt)
    dao = split(torch.matmul(g2, wo.float().t()).reshape(bw, l, c))
    dv = torch.matmul(w_drop.float().transpose(-1, -2), dao)
    dw = apply_dropout(torch.matmul(dao, vh.transpose(-1, -2)), keep,
                       dropout_rate)
    dl = w * (dw - torch.sum(dw * w, dim=-1, keepdim=True))
    dq = torch.matmul(dl, split(k3.reshape(bw, l, c)).float()) * (hd ** -0.5)
    dk = torch.matmul(dl.transpose(-1, -2), qs.float())

    def merge(z):  # (B, H, L, hd) -> (B*L, C)
        return z.transpose(1, 2).reshape(-1, c)

    attn2, dq2, dk2, dv2 = merge(attn).float(), merge(dq), merge(dk), merge(dv)
    dwq = torch.matmul(xqk.float().t(), dq2)
    dwk = torch.matmul(xqk.float().t(), dk2)
    dwv = torch.matmul(xn.float().t(), dv2)
    dwo = torch.matmul(attn2.t(), g2)
    dxqk = torch.matmul(dq2, wq.float().t()) + torch.matmul(dk2, wk.float().t())
    dxn = torch.matmul(dv2, wv.float().t())
    dbias = None
    if bias is not None and need_dbias:
        dbias = dl.sum(0)
        if bias.shape[0] == 1:
            dbias = dbias.sum(0, keepdim=True)
    return (dxqk, dxn, dwq.to(wq.dtype), dq2.sum(0), dwk.to(wk.dtype),
            dk2.sum(0), dwv.to(wv.dtype), dv2.sum(0), dwo.to(wo.dtype),
            g2.sum(0), dbias)


def fused_attention_backward_plain(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo,
                                   bias, seed, g, num_heads: int = 8,
                                   dropout_rate: float = 0.0,
                                   need_dbias: bool = True, mask_heads=None,
                                   head0: int = 0):
    """Plain backward of kernel #5 (mirrors ``_bwd_kernel``). Returns
    (dx_qk, dx_v, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dbias): dx_qk =
    dq Wq^T + dk Wk^T and dx_v = dv Wv^T summed in f32 and rounded to the
    inputs' dtype once, each dW in its weight's dtype, the vectors f32,
    dbias f32 in the bias's shape (or None)."""
    del bo
    bw, l, c = x_qk.shape
    dxqk, dxv, *rest = _sublayer_backward_plain(
        x_qk.reshape(-1, c), x_v.reshape(-1, c), wq, bq, wk, bk, wv, bv, wo,
        bias, seed, g.float().reshape(-1, c), bw, l, num_heads, dropout_rate,
        need_dbias, mask_heads, head0)
    dt = x_qk.dtype
    return (dxqk.to(dt).reshape(bw, l, c), dxv.to(dt).reshape(bw, l, c),
            *rest)


def fused_attention_ln_backward_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, ls,
                                      lb, pos, bias, seed, g,
                                      num_heads: int = 8,
                                      dropout_rate: float = 0.0, scale=None,
                                      res: bool = False,
                                      need_dbias: bool = True, mask_heads=None,
                                      head0: int = 0):
    """Plain backward (mirrors ``_bwd_kernel_ln``): recompute LN, +pos,
    q/k/v, the per-head softmax and mask; then the attention backward per
    head and the weight, LN-affine and bias gradients summed over all
    windows. Rounding points: w_drop rounded to the compute dtype before
    the dv product, the merged heads rounded before dWo; dq/dk/dv stay f32
    into the dW products and into d(xn). Returns (dx, dwq, dbq, dwk, dbk,
    dwv, dbv, dwo, dbo, dls, dlb, dbias): dx in x's dtype, each dW in its
    weight's dtype, the vectors f32, dbias f32 in the bias's shape (or
    None)."""
    dt = x.dtype
    bw, l, c = x.shape
    x2 = x.float().reshape(-1, c)
    g2_raw = g.float().reshape(-1, c)
    g2 = g2_raw
    if scale is not None:
        g2 = (g.float() * scale.float()[:, None, None]).reshape(-1, c)
    mean = x2.mean(1, keepdim=True)
    xc = x2 - mean
    rstd = torch.rsqrt((xc * xc).mean(1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    lsf, lbf = ls.float(), lb.float()
    xn = (xhat * lsf + lbf).to(dt)
    xqk = xn
    if pos is not None:
        xqk = (xn.reshape(bw, l, c) + pos.to(dt)).reshape(-1, c)
    dxqk, dxv, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dbias = \
        _sublayer_backward_plain(xqk, xn, wq, bq, wk, bk, wv, bv, wo, bias,
                                 seed, g2, bw, l, num_heads, dropout_rate,
                                 need_dbias, mask_heads, head0)
    dxn = dxqk + dxv
    dls = (dxn * xhat).sum(0)
    dlb = dxn.sum(0)
    dxhat = dxn * lsf
    m1 = dxhat.mean(1, keepdim=True)
    m2 = (dxhat * xhat).mean(1, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * rstd
    if res:
        dx = dx + g2_raw
    return (dx.to(dt).reshape(bw, l, c), dwq, dbq, dwk, dbk, dwv, dbv, dwo,
            dbo, dls, dlb, dbias)


class _FusedAttentionLN(torch.autograd.Function):
    """Both wrappers; ``res`` selects the ``_ln_res`` epilogue."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias,
                scale, seed, num_heads, rate, res, mask_heads, head0):
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos,
                              bias, scale, seed)
        ctx.num_heads, ctx.rate, ctx.res = num_heads, rate, res
        ctx.heads = (mask_heads, head0)
        return _forward(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias,
                        scale, seed, num_heads, rate, res, mask_heads, head0)

    @staticmethod
    def backward(ctx, g):
        (x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale,
         seed) = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[12]
        (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dls, dlb,
         dbias) = fused_attention_ln_backward(
            x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, seed,
            g.contiguous(), ctx.num_heads, ctx.rate, scale, ctx.res, need_dbias,
            *ctx.heads)
        cast = lambda d, ref: None if d is None else d.to(ref.dtype)
        dpos = torch.zeros_like(pos) if ctx.needs_input_grad[11] else None
        dscale = torch.zeros_like(scale) if ctx.needs_input_grad[13] else None
        return (dx, dwq, cast(dbq, bq), dwk, cast(dbk, bk), dwv, cast(dbv, bv),
                dwo, cast(dbo, bo), cast(dls, ls), cast(dlb, lb), dpos,
                cast(dbias, bias), dscale, None, None, None, None, None, None)


def fused_attention_ln(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos=None,
                       bias=None, seed: Seed = 0, num_heads: int = 8,
                       dropout_rate: float = 0.0, mask_heads=None,
                       head0: int = 0) -> torch.Tensor:
    """LN-folded attention sublayer over x (B, L, C), L <= 32. ``pos``:
    optional (L, C) table added to q/k only; ``bias``: optional
    (1 | heads, L, L) additive logits; ``seed``/``dropout_rate``: the
    attention-weight dropout; ``mask_heads``/``head0``: a head subset (the
    module notes)."""
    return _apply(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, None,
                  seed, num_heads, dropout_rate, False, mask_heads, head0)


def fused_attention_ln_res(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb,
                           pos=None, bias=None, scale=None, seed: Seed = 0,
                           num_heads: int = 8,
                           dropout_rate: float = 0.0) -> torch.Tensor:
    """``x + scale * fused_attention_ln(x, ...)`` in one kernel; ``scale``:
    optional (B,) f32 per-window branch factor (the DropPath mask)."""
    return _apply(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale,
                  seed, num_heads, dropout_rate, True, None, 0)


def _forward(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale,
             seed, num_heads, rate, res, mask_heads=None, head0=0):
    """The forward for either device; ``seed`` a tensor or None (rate 0)."""
    if x.device.type == "cpu":
        return fused_attention_ln_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, ls,
                                        lb, pos, bias, seed, num_heads, rate,
                                        scale, res, mask_heads, head0)
    return _run_forward(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale,
                        seed, num_heads, rate, res, mask_heads=mask_heads, head0=head0)


def _apply(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale, seed,
           num_heads, rate, res, mask_heads, head0):
    if x.device.type != "cpu" and not x.is_cuda:
        raise ValueError(f"fused_attention_ln: unsupported device {x.device}")
    _check_heads(num_heads, mask_heads, head0)
    rate = float(rate)
    seed = seed_tensor(seed, x.device) if rate > 0.0 else None
    args = (x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale, seed,
            num_heads, rate, res, mask_heads, head0)
    if needs_grad(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale):
        return _FusedAttentionLN.apply(*args)
    return _forward(*args)


fused_attention_ln.launches = 0
fused_attention_ln.bwd_launches = 0
fused_attention_ln.launches_by_route = dict.fromkeys(ROUTES, 0)
fused_attention_ln.bwd_launches_by_route = dict.fromkeys(ROUTES, 0)


def fused_attention_ln_backward(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos,
                                bias, seed, g, num_heads: int = 8,
                                dropout_rate: float = 0.0, scale=None,
                                res: bool = False, need_dbias: bool = True,
                                mask_heads=None, head0: int = 0):
    """The backward of both wrappers on its own (what the autograd Function
    calls): the kernel for CUDA tensors (counted in
    ``fused_attention_ln.bwd_launches``),
    :func:`fused_attention_ln_backward_plain` for CPU tensors. Returns the
    tuple that function documents."""
    if x.device.type == "cpu":
        return fused_attention_ln_backward_plain(
            x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, seed, g,
            num_heads, dropout_rate, scale, res, need_dbias, mask_heads, head0)
    if dropout_rate > 0.0:
        seed = seed_tensor(seed, x.device)
    return _backward_kernel(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos,
                            bias, seed, g, num_heads, dropout_rate, scale, res,
                            need_dbias and bias is not None, mask_heads=mask_heads,
                            head0=head0)


class _FusedAttention(torch.autograd.Function):
    """The two-stream wrapper (kernels #5 / #6)."""

    @staticmethod
    def forward(ctx, x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias, seed,
                num_heads, rate, mask_heads, head0):
        ctx.save_for_backward(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias,
                              seed)
        ctx.num_heads, ctx.rate, ctx.heads = num_heads, rate, (mask_heads, head0)
        return _forward_two(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias,
                            seed, num_heads, rate, mask_heads, head0)

    @staticmethod
    def backward(ctx, g):
        x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias, seed = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[10]
        (dxqk, dxv, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo,
         dbias) = fused_attention_backward(
            x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias, seed,
            g.contiguous(), ctx.num_heads, ctx.rate, need_dbias, *ctx.heads)
        cast = lambda d, ref: None if d is None else d.to(ref.dtype)
        return (dxqk, dxv, dwq, cast(dbq, bq), dwk, cast(dbk, bk), dwv,
                cast(dbv, bv), dwo, cast(dbo, bo), cast(dbias, bias), None,
                None, None, None, None)


def fused_attention(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias=None,
                    seed: Seed = 0, num_heads: int = 8,
                    dropout_rate: float = 0.0, mask_heads=None,
                    head0: int = 0) -> torch.Tensor:
    """Attention sublayer over (B, L, C), L <= 32, with q/k from ``x_qk``
    and v from ``x_v`` (same shape and dtype). ``bias``: optional
    (1 | heads, L, L) additive logits (the relative-position bias);
    ``seed``/``dropout_rate``: the attention-weight dropout;
    ``mask_heads``/``head0``: a head subset (the module notes).
    Differentiable in every tensor but the seed."""
    if x_qk.device.type != "cpu" and not x_qk.is_cuda:
        raise ValueError(f"fused_attention: unsupported device {x_qk.device}")
    _check_heads(num_heads, mask_heads, head0)
    rate = float(dropout_rate)
    seed = seed_tensor(seed, x_qk.device) if rate > 0.0 else None
    args = (x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias, seed, num_heads,
            rate, mask_heads, head0)
    if needs_grad(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias):
        return _FusedAttention.apply(*args)
    return _forward_two(*args)


fused_attention.launches = 0
fused_attention.bwd_launches = 0
fused_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
fused_attention.bwd_launches_by_route = dict.fromkeys(ROUTES, 0)


def _forward_two(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias, seed,
                 num_heads, rate, mask_heads=None, head0=0):
    """Kernel #5's forward for either device; ``seed`` a tensor or None."""
    if x_qk.device.type == "cpu":
        return fused_attention_plain(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo,
                                     bias, seed, num_heads, rate, mask_heads, head0)
    return _run_forward(x_qk, wq, bq, wk, bk, wv, bv, wo, bo, None, None, None, bias, None,
                        seed, num_heads, rate, False, x_v=x_v, mask_heads=mask_heads,
                        head0=head0)


def fused_attention_backward(x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias,
                             seed, g, num_heads: int = 8,
                             dropout_rate: float = 0.0,
                             need_dbias: bool = True, mask_heads=None,
                             head0: int = 0):
    """Kernel #5's backward on its own (what the autograd Function calls):
    kernel #6 for CUDA tensors (counted in ``fused_attention.bwd_launches``),
    :func:`fused_attention_backward_plain` for CPU tensors. Returns the
    tuple that function documents."""
    if x_qk.device.type == "cpu":
        return fused_attention_backward_plain(
            x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo, bias, seed, g,
            num_heads, dropout_rate, need_dbias, mask_heads, head0)
    if dropout_rate > 0.0:
        seed = seed_tensor(seed, x_qk.device)
    return _backward_kernel(x_qk, wq, bq, wk, bk, wv, bv, wo, bo, None, None,
                            None, bias, seed, g, num_heads, dropout_rate, None,
                            False, need_dbias and bias is not None, x_v=x_v,
                            mask_heads=mask_heads, head0=head0)


SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90


def _attn_smem(tokens: int, inner: int) -> int:
    """Shared memory of the wgmma route's attention pass (``attn_smem`` in
    ``csrc/fused_window_attention.cuh``): q, k, v rows of padded width."""
    ld = inner if inner % 16 else inner + 8
    return 3 * tokens * ld * 2


def kernel_route(tokens: int, channels: int, dtype: torch.dtype,
                 inner: Optional[int] = None) -> str:
    """Which route the forward kernels (#1, #5) take: ``"wgmma"`` (bf16, C
    and the inner width Cl (``inner``, default C: every head) multiples of
    8, any number of windows: LayerNorm rows, q/k/v and the out projection
    on the warpgroup MMA fed by TMA, the attention per (window, head) on
    ``mma.sync``) or ``"fma"`` (FMAs on the CUDA cores; f32, f16, and
    bf16 at other widths, e.g. Cl = 132). Chosen from the shape before any launch;
    the libraries' ``*_route`` entry points say the same."""
    inner = channels if inner is None else inner
    return ("wgmma" if dtype == torch.bfloat16 and channels % 8 == 0 and inner % 8 == 0
            and _attn_smem(tokens, inner) <= SMEM_LIMIT else "fma")


def backward_route(tokens: int, channels: int, dtype: torch.dtype,
                   ln: bool = True, inner: Optional[int] = None) -> str:
    """Which route the backward kernel (#3 with ``ln``, else #6) takes:
    ``"wgmma"`` (bf16, C and the inner width ``inner`` (default C)
    multiples of 8, any number of rows: every product on the warpgroup
    MMA, fed by TMA) or ``"fma"`` (FMAs on the CUDA cores: f32, f16, and
    bf16 at other widths). Chosen from the
    shape before the launch; ``tokens`` and ``ln`` do not enter; the
    libraries' ``*_route`` entry points say the same."""
    del tokens, ln
    inner = channels if inner is None else inner
    return ("wgmma" if dtype == torch.bfloat16 and channels % 8 == 0 and inner % 8 == 0
            else "fma")


def rows_product(a, b, a_lo=None, b_mn: bool = True) -> torch.Tensor:
    """(a + a_lo) @ B in f32 on the backward's row-tiled ``wgmma`` product
    (128-row tiles, TMA-fed), with a, a_lo (R, K) bf16 on the card and B =
    b (K, N) read MN-major as stored when ``b_mn`` (the projections'
    operand: then no a_lo), else b is B^T (N, K), K-major as stored
    (d(attn)'s and d(xn)'s); K and N multiples of 8. That product on its
    own; not counted in any launch count."""
    rows, k = a.shape if a.dim() == 2 else (0, 0)
    n = (b.shape[1] if b_mn else b.shape[0]) if b.dim() == 2 else 0
    want_b = (k, n) if b_mn else (n, k)
    if (a.dim() != 2 or not a.is_cuda or rows < 1 or k % 8 or n % 8 or k < 8 or n < 8
            or (b_mn and a_lo is not None) or tuple(b.shape) != want_b
            or any(t.dtype != torch.bfloat16 or t.device != a.device
                   or not t.is_contiguous() or t.data_ptr() % 16
                   for t in (a, b) + (() if a_lo is None else (a_lo,)))
            or (a_lo is not None and a_lo.shape != a.shape)):
        raise ValueError(f"rows_product takes a (R, K) (and a_lo) and b (K, N) (b_mn) or "
                         f"(N, K) bf16 on the card, K and N multiples of 8, got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} {b.dtype}")
    out = torch.empty(rows, n, dtype=torch.float32, device=a.device)
    lib, _ = _lib_bwd(True)
    p = _build.ptr
    err = lib.vptr_window_rows_product(p(a), p(a_lo), p(b), p(out), rows, k, n, int(b_mn),
                                       torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "rows_product")
    return out


def attention_pass(q, k, v, bias=None, seed: Seed = 0, num_heads: int = 8,
                   dropout_rate: float = 0.0) -> torch.Tensor:
    """The forward's attention pass on its own: q, k, v (B, L, C) bf16 on
    the card (q already scaled and rounded), C a multiple of 8; ``bias``
    (1 | heads, L, L) or None; returns the merged heads (B, L, C) bf16,
    ``dropout(softmax(q_h k_h^T + bias_h)) v_h`` with the kernels' rounding
    points (the weights rounded after dropout). Not counted in any launch
    count."""
    bw, l, c = q.shape if q.dim() == 3 else (0, 0, 0)
    if (q.dim() != 3 or not q.is_cuda or c % 8
            or any(t.shape != q.shape or t.dtype != torch.bfloat16 or t.device != q.device
                   or not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"attention_pass takes q, k, v of one (B, L, C) bf16 shape on "
                         f"the card, C a multiple of 8, got {tuple(q.shape)} {q.dtype}")
    bias_t, bias_heads = None, 0
    if bias is not None:
        bias_t = bias.to(device=q.device, dtype=torch.float32).contiguous()
        bias_heads = bias_t.shape[0]
    rate = float(dropout_rate)
    seed_t = seed_tensor(seed, q.device) if rate > 0.0 else None
    out = torch.empty_like(q)
    lib, p = _lib(), _build.ptr
    err = lib.vptr_window_attention_pass(
        p(q), p(k), p(v), p(bias_t), p(out), bw, l, c, num_heads, bias_heads,
        *_dropout_args(seed_t, rate), padded_tokens(l, q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "attention_pass")
    return out


def out_projection(a, wo, bo, tokens: int, scale=None, res=None) -> torch.Tensor:
    """The forward's out projection on its own: ``(a @ wo + bo) *
    scale[row // tokens] (+ res)`` in f32, rounded once to bf16, on the
    ``wgmma`` row-tiled product; a, res (R, C) and wo (C, C) bf16, bo (C,)
    and scale (R // tokens,) f32, on the card, C a multiple of 8. Not
    counted in any launch count."""
    rows, c = a.shape if a.dim() == 2 else (0, 0)
    bf = torch.bfloat16
    if (a.dim() != 2 or not a.is_cuda or rows < 1 or c % 8 or c < 8
            or tuple(wo.shape) != (c, c) or tuple(bo.shape) != (c,)
            or (res is not None and res.shape != a.shape)
            or (scale is not None and tuple(scale.shape) != (-(-rows // tokens),))
            or any(t.dtype != dt or t.device != a.device or not t.is_contiguous()
                   or t.data_ptr() % 16
                   for t, dt in ((a, bf), (wo, bf), (bo, torch.float32), (res, bf),
                                 (scale, torch.float32)) if t is not None)):
        raise ValueError(f"out_projection takes a (R, C), wo (C, C) bf16, bo (C,) f32 on "
                         f"the card, C a multiple of 8, got {tuple(a.shape)} {a.dtype}")
    out = torch.empty_like(a)
    lib, p = _lib(), _build.ptr
    err = lib.vptr_window_out_projection(
        p(a), p(wo), p(bo), p(scale), p(res), p(out), rows, tokens, c,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "out_projection")
    return out


def weight_products(xs, his, los):
    """x_j^T (hi_j + lo_j) in f32 for the four j on the backward's weight
    product (``wgmma``, both operands MN-major as they lie in memory, the
    four in one launch, K = rows in the backward's chunks summed in order),
    with every x_j, hi_j, lo_j (R, C) bf16 on the card, C a multiple of 8;
    a lo_j of None makes that product one term. Returns (4, C, C). That
    product on its own; not counted in any launch count."""
    x0 = xs[0]
    rows, c = x0.shape if x0.dim() == 2 else (0, 0)
    given = [t for t in (*xs, *his, *los) if t is not None]
    if (len(xs) != 4 or len(his) != 4 or len(los) != 4 or not x0.is_cuda or rows < 1
            or c < 8 or c % 8 or any(h is None for h in his)
            or any(t.shape != (rows, c) or t.dtype != torch.bfloat16
                   or t.device != x0.device or not t.is_contiguous() or t.data_ptr() % 16
                   for t in given)):
        raise ValueError("weight_products takes four x, hi and lo (or None) of one (R, C) "
                         "bf16 shape on the card, C a multiple of 8")
    lib, entry = _lib_bwd(True)
    ksplit = getattr(lib, f"{entry}_ksplit")(rows, c, c, _DTYPES[torch.bfloat16])
    part = torch.empty(4, ksplit, c, c, dtype=torch.float32, device=x0.device)
    out = torch.empty(4, c, c, dtype=torch.float32, device=x0.device)
    ptrs = lambda ts: (ctypes.c_void_p * 4)(*[_build.ptr(t) for t in ts])
    err = lib.vptr_window_weight_products(ptrs(xs), ptrs(his), ptrs(los), _build.ptr(part),
                                          _build.ptr(out), rows, c,
                                          torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(lib, err, "weight_products")
    return out


def _operands(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale,
              num_heads, x_v=None):
    """Check every operand against what the kernels take (the activations
    and weights 16-byte aligned: the ``wgmma`` routes read their rows by
    TMA); returns (bias f32 contiguous or None, bias_heads, the inner width
    Cl of Wq)."""
    bw, l, c = x.shape
    cl = wq.shape[1] if wq.dim() == 2 else c
    if cl % num_heads or cl // num_heads > MAX_HEAD_DIM or l > MAX_TOKENS:
        raise ValueError(f"fused_attention_ln kernel takes L <= {MAX_TOKENS} "
                         f"and a head width <= {MAX_HEAD_DIM} dividing Cl; got "
                         f"L={l} C={c} Cl={cl} heads={num_heads}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_attention_ln kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")

    def operand(t, shape, dtype, name, align=1):
        if t is None:
            return
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused_attention_ln: {name} is "
                             f"{tuple(t.shape)} {t.dtype}, wants {shape} {dtype}")
        if (not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % align):
            raise ValueError(f"fused_attention_ln: {name} must be contiguous "
                             f"on {x.device} ({align}-byte aligned)")

    f32 = torch.float32
    operand(x, (bw, l, c), x.dtype, "x", align=16)
    operand(x_v, (bw, l, c), x.dtype, "x_v", align=16)
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        operand(w, (c, cl), x.dtype, name, align=16)
    operand(wo, (cl, c), x.dtype, "wo", align=16)
    for name, v, n in (("bq", bq, cl), ("bk", bk, cl), ("bv", bv, cl), ("bo", bo, c),
                       ("ls", ls, c), ("lb", lb, c)):
        operand(v, (n,), f32, name)
    operand(pos, (l, c), f32, "pos")
    operand(scale, (bw,), f32, "scale")
    if cl != c and (scale is not None):
        raise ValueError("fused_attention_ln: a head subset takes no scale")
    if bias is None:
        return None, 0, cl
    bias = bias.to(device=x.device, dtype=f32).contiguous()
    if tuple(bias.shape) not in ((1, l, l), (num_heads, l, l)):
        raise ValueError(f"fused_attention_ln: bias {tuple(bias.shape)} "
                         f"is not (1|{num_heads}, {l}, {l})")
    return bias, bias.shape[0], cl


class _FwdArgs(ctypes.Structure):
    """Mirror of ``FwdArgs`` in ``csrc/fused_window_attention.cuh``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "xv", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ls", "lb",
        "pos", "bias", "scale", "seed", "out",
        "mean", "rstd", "xn", "xqk", "q", "k", "v", "attn")]
        + [(n, ctypes.c_int) for n in (
            "windows", "tokens", "channels", "heads", "bias_heads", "res",
            "mask_tokens", "dtype", "inner", "mask_heads", "head0")]
        + [(n, ctypes.c_float) for n in ("qscale", "eps", "rate", "keep_div")])


def _run_forward(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, scale,
                 seed, num_heads, rate, res, x_v=None, mask_heads=None, head0=0):
    """Kernel #1 (LayerNorm folded in) or, with ``x_v``, kernel #5 (x is
    then x_qk): the route the shape takes, with the wgmma route's scratch
    (one allocation, returned to torch's stream-ordered allocator when the
    call returns: later work on the stream runs after the passes), counted
    in the wrapper's ``launches`` and ``launches_by_route``. Returns the
    output."""
    ln = x_v is None
    name = "fused_attention_ln" if ln else "fused_attention"
    bias, bias_heads, cl = _operands(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb,
                                     pos, bias, scale, num_heads, x_v)
    bw, l, c = x.shape
    dt, dev = x.dtype, x.device
    lib, entry = (_lib(), "vptr_fused_window_attention_ln") if ln else (
        _lib_two(), "vptr_fused_window_attention")
    smem = getattr(lib, f"{entry}_smem")(l, c, cl, num_heads, _DTYPES[dt])
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name} kernel: L={l}, C={c}, Cl={cl}, {dt} needs {smem} B of "
                         f"shared memory (> {SMEM_LIMIT})")
    rows = bw * l
    scratch, ptrs = None, {}
    wg = bool(getattr(lib, f"{entry}_route")(l, c, cl, _DTYPES[dt]))
    if wg:
        # one allocation, carved into 256-byte aligned pieces
        plane = -(-rows * c * x.element_size() // 256) * 256
        inner = -(-rows * cl * x.element_size() // 256) * 256
        sizes = dict(q=inner, k=inner, v=inner, attn=inner)
        if ln:
            vec = -(-rows * 4 // 256) * 256
            sizes.update(xn=plane, mean=vec, rstd=vec)
            if pos is not None:
                sizes["xqk"] = plane
        scratch = torch.empty(sum(sizes.values()), dtype=torch.uint8, device=dev)
        at = scratch.data_ptr()
        for part, n in sizes.items():
            ptrs[part], at = at, at + n
    out = torch.empty_like(x)
    p = _build.ptr
    seed_p, rate, keep_div = _dropout_args(seed, rate)
    a = _FwdArgs(
        x=p(x), xv=p(x_v), wq=p(wq), bq=p(bq), wk=p(wk), bk=p(bk), wv=p(wv), bv=p(bv),
        wo=p(wo), bo=p(bo), ls=p(ls), lb=p(lb), pos=p(pos), bias=p(bias),
        scale=p(scale), seed=seed_p, out=p(out), **ptrs,
        windows=bw, tokens=l, channels=c, heads=num_heads, bias_heads=bias_heads,
        res=int(res), mask_tokens=padded_tokens(l, dt), dtype=_DTYPES[dt], inner=cl,
        mask_heads=mask_heads or 0, head0=head0,
        qscale=q_scale(cl // num_heads, dt), eps=LN_EPS, rate=rate, keep_div=keep_div)
    err = getattr(lib, entry)(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, name)
    counter = fused_attention_ln if ln else fused_attention
    counter.launches += 1
    counter.launches_by_route["wgmma" if wg else "fma"] += 1
    return out


class _BwdArgs(ctypes.Structure):
    """Mirror of ``BwdArgs`` in ``csrc/fused_window_attention_bwd.cuh``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "xv", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "ls", "lb",
        "pos", "bias", "scale", "seed", "g",
        "dx", "dxv", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo", "dls",
        "dlb", "dbias",
        "mean", "rstd", "xn", "xqk", "q", "k", "v", "attn", "dao", "dq",
        "dk", "dv", "dl", "colpart", "partial", "wpart", "planes", "wcat")]
        + [(n, ctypes.c_int) for n in (
            "windows", "tokens", "channels", "heads", "bias_heads", "res",
            "mask_tokens", "dtype", "ksplit", "inner", "mask_heads", "head0")]
        + [(n, ctypes.c_float) for n in ("qscale", "dscale", "eps", "rate",
                                         "keep_div")])


def _backward_kernel(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias,
                     seed, g, num_heads, rate, scale, res, need_dbias,
                     x_v=None, mask_heads=None, head0=0):
    """Kernel #3 (LayerNorm folded in) or, with ``x_v``, kernel #6 (x is
    then x_qk); returns the gradients in the order of the matching plain
    backward."""
    ln = x_v is None
    name = "fused_attention_ln" if ln else "fused_attention"
    bias, bias_heads, cl = _operands(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb,
                                     pos, bias, scale, num_heads, x_v)
    bw, l, c = x.shape
    if cl != c and res:
        raise ValueError(f"{'fused_attention_ln' if x_v is None else 'fused_attention'} "
                         f"backward: a head subset takes no residual")
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"{name} backward: g {tuple(g.shape)} "
                         f"{g.dtype} does not match x {tuple(x.shape)} {x.dtype}")
    rows, dt, dev = bw * l, x.dtype, x.device
    f32 = torch.float32
    lib, entry = _lib_bwd(ln)
    wg = bool(getattr(lib, f"{entry}_route")(c, cl, _DTYPES[dt]))
    if wg and g.data_ptr() % 16:      # TMA reads g's rows
        raise ValueError(f"{name} backward: g must be 16-byte aligned")
    ksplit = getattr(lib, f"{entry}_ksplit")(rows, c, cl, _DTYPES[dt])

    def buf(*shape, dtype=f32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    grads = dict(dx=torch.empty_like(x),
                 dxv=None if ln else torch.empty_like(x_v),
                 dwq=torch.empty_like(wq),
                 dwk=torch.empty_like(wk), dwv=torch.empty_like(wv),
                 dwo=torch.empty_like(wo), dbq=buf(cl), dbk=buf(cl), dbv=buf(cl),
                 dbo=buf(c), dls=buf(c) if ln else None,
                 dlb=buf(c) if ln else None,
                 dbias=buf(*bias.shape) if need_dbias else None)
    # scratch: the projections, the merged heads, d(attn) (then d(xn)),
    # the logit gradients, the window sums of dq, dk, dv and g * scale, the
    # split-K partials; on the wgmma route the bf16 hi and lo planes of [dq
    # dk dv g*scale] and [Wq Wk Wv] side by side, on the FMA route dq, dk,
    # dv in f32 (the projections' width is the inner Cl)
    f32_d = (lambda: None) if wg else (lambda: buf(rows, cl))
    scratch = dict(q=buf(rows, cl, dtype=dt),
                   k=buf(rows, cl, dtype=dt), v=buf(rows, cl, dtype=dt),
                   attn=buf(rows, cl, dtype=dt), dao=buf(rows, c),
                   dq=f32_d(), dk=f32_d(), dv=f32_d(),
                   dl=buf(bw, num_heads, l, l) if need_dbias else None,
                   colpart=buf(4, bw, c), wpart=buf(4, ksplit, c, cl),
                   planes=buf(2, rows, 3 * cl + c, dtype=dt) if wg else None,
                   wcat=buf(c, 3 * cl, dtype=dt) if wg else None)
    if ln:   # the LayerNorm passes' statistics, outputs and column-sum partials
        scratch.update(mean=buf(rows), rstd=buf(rows), xn=buf(rows, c, dtype=dt),
                       xqk=buf(rows, c, dtype=dt),
                       partial=buf(2, getattr(lib, f"{entry}_partials")(rows), c))
    p = _build.ptr
    a = _BwdArgs(
        x=p(x), xv=p(x_v), wq=p(wq), bq=p(bq), wk=p(wk), bk=p(bk), wv=p(wv), bv=p(bv),
        wo=p(wo), bo=p(bo), ls=p(ls), lb=p(lb), pos=p(pos), bias=p(bias),
        scale=p(scale), seed=p(seed) if rate > 0.0 else None, g=p(g),
        **{k: p(v) for k, v in grads.items()},
        **{k: p(v) for k, v in scratch.items()},
        windows=bw, tokens=l, channels=c, heads=num_heads,
        bias_heads=bias_heads, res=int(res),
        mask_tokens=padded_tokens(l, dt), dtype=_DTYPES[dt], ksplit=ksplit,
        inner=cl, mask_heads=mask_heads or 0, head0=head0,
        qscale=q_scale(cl // num_heads, dt), dscale=(cl // num_heads) ** -0.5,
        eps=LN_EPS, rate=rate, keep_div=1.0 - rate)
    err = getattr(lib, entry)(ctypes.byref(a),
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"{name} backward")
    counter = fused_attention_ln if ln else fused_attention
    counter.bwd_launches += 1
    counter.bwd_launches_by_route["wgmma" if wg else "fma"] += 1
    if ln:
        order = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo",
                 "dls", "dlb", "dbias")
    else:
        order = ("dx", "dxv", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo",
                 "dbo", "dbias")
    return tuple(grads[k] for k in order)


def _lib() -> ctypes.CDLL:
    return _lib_fwd("fused_window_attention_ln", extra=True)


def _lib_two() -> ctypes.CDLL:
    return _lib_fwd("fused_window_attention")


def _lib_fwd(name: str, extra: bool = False) -> ctypes.CDLL:
    """The library of kernel #1 (``extra``: with the passes alone) or #5."""
    lib = _build.load(name)
    fn = getattr(lib, f"vptr_{name}")
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ctypes.POINTER(_FwdArgs), p]
        fn.restype = i
        for part, n, rt in (("smem", 5, ctypes.c_long), ("route", 4, i)):
            g = getattr(lib, f"vptr_{name}_{part}")
            g.argtypes = [i] * n
            g.restype = rt
        if extra:
            lib.vptr_window_attention_pass.argtypes = [p] * 5 + [i] * 5 + [p, f, f, i, p]
            lib.vptr_window_attention_pass.restype = i
            lib.vptr_window_out_projection.argtypes = [p] * 6 + [i] * 3 + [p]
            lib.vptr_window_out_projection.restype = i
    return lib


def _lib_bwd(ln: bool):
    """(library, entry point name) of kernel #3 (``ln``) or #6."""
    name = "fused_window_attention_ln_bwd" if ln else "fused_window_attention_bwd"
    lib, entry = _build.load(name), f"vptr_{name}"
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_BwdArgs), p]
        fn.restype = i
        for part, n in (("ksplit", 4), ("route", 3)) + ((("partials", 1),) if ln else ()):
            f = getattr(lib, f"{entry}_{part}")
            f.argtypes = [i] * n
            f.restype = i
        if ln:
            lib.vptr_window_rows_product.argtypes = [p] * 4 + [i] * 4 + [p]
            lib.vptr_window_rows_product.restype = i
            lib.vptr_window_weight_products.argtypes = [p] * 5 + [i] * 2 + [p]
            lib.vptr_window_weight_products.restype = i
    return lib, entry
