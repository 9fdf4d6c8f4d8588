"""Attention core: dropout(softmax(q k^T * D^-1/2 + bias)) v.

Counterpart of ``vptr_tpu/ops/attention_core.py::attention_core``: the TPU
kernels ``_core_forward`` (``pl.pallas_call`` at :188) and ``_core_backward``
(:317), joined by ``jax.custom_vjp``. Both kernels are in
``csrc/attention_core.cu`` (CUDA C++ for sm_90a); its source note says what
bounds each on the card and what its design does about that.

* The forward has three routes, named by :func:`kernel_route` from the
  shapes. At Tq, Tk <= 32: "mma" (bf16: a batch element a block, q k^T
  and P v on the tensor cores) and "fma" (f32, f16, and the bf16 shapes
  "mma" does not take). Past 32 tokens, up to Tq, Tk <= 160 with D <= 80:
  "long" (TSLMA's space-time windows: a head of a batch element a block,
  bf16 on the tensor cores, f32 on the FMA units; no f16 kernel, so f16
  raises there before any launch, :func:`kernel_route` saying so).
* The backward has the same three, named by :func:`backward_route`:
  "mma" (bf16: a batch element a block, dq, dk and dv on the tensor
  cores), "fma" and "long" (a head a block: a pass over query strips for
  dq, then one over key strips for dk and dv).
* q, k, v (and the backward's g) may each be contiguous (B, H, T, D) or
  the (B, H, T, D) view of a contiguous (B, T, H*D) tensor, the layout of
  the attention layer's projections (``heads()`` in ``models/layers.py``);
  the output has q's layout, and dq, dk, dv have q's, k's and v's. The
  "fma" kernels read and write contiguous rows, so on those routes the
  wrapper copies a strided operand first (and a result back); the "mma"
  and "long" routes read and write both layouts.

* :func:`attention_core` is the wrapper, a ``torch.autograd.Function``. A
  CUDA tensor launches the kernels (or raises); a CPU tensor takes
  :func:`attention_core_plain` forward and
  :func:`attention_core_backward_plain` backward, the same functions in
  plain PyTorch with the same rounding points.
* ``attention_core.launches`` counts forward kernel launches and
  ``attention_core.bwd_launches`` backward kernel launches, nothing else;
  ``attention_core.launches_by_route`` and ``bwd_launches_by_route`` split
  them by route.
* Attention-weight dropout is the counter hash of ``ops/dropout.py``: the
  backward regenerates the forward's mask from the seed. ``seed`` is an
  int32, as a Python int or a one-element int32 tensor on the operands'
  device (drawn there, it costs no host synchronisation).
* A head subset (tensor parallelism): q, k, v may hold heads h0 .. h0 + H
  - 1 of Hg (``mask_heads`` Hg, ``head0`` h0); every route and the plain
  versions then draw those heads' rows of the whole call's dropout mask
  (the element index ``((b Hg + h0 + h) Tq + r) Tk + c``), so the subset's
  output is the whole call's output of those heads. A per-head bias holds
  the subset's heads; a one-head bias's gradient is the subset's share.
* As in the JAX package, ``q * D^-1/2`` multiplies by the scale in q's dtype
  (a Python float times a bf16 array is a bf16 product in JAX), while the
  backward's ``dq * D^-1/2`` is an f32 product.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vptr_tpu_torch.ops import _build
from vptr_tpu_torch.ops.dropout import Seed, apply_dropout, dropout_keep_mask

MAX_TOKENS = 32            # the short routes ("mma", "fma")
MAX_DEPTH = 128
LONG_TOKENS = 160          # the long route
LONG_DEPTH = 80
MAX_SMEM = 232448          # dynamic shared memory of a block on the H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ROUTES = {"fma": 0, "mma": 1, "long": 2}


def _is_long(tq: int, tk: int, depth: int, dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the shape takes the long route; raises past its reach, and
    for a ``dtype`` the long route has no kernel for (float16)."""
    if tq <= MAX_TOKENS and tk <= MAX_TOKENS and depth <= MAX_DEPTH:
        return False
    if tq <= LONG_TOKENS and tk <= LONG_TOKENS and depth <= LONG_DEPTH:
        if dtype == torch.float16:
            raise ValueError(f"attention_core's long route (Tq={tq}, Tk={tk} past "
                             f"{MAX_TOKENS}) takes float32 or bfloat16, got float16; "
                             f"{_build.F16_QUEUED}")
        return True
    raise ValueError(
        f"attention_core kernel takes Tq, Tk <= {MAX_TOKENS} with D <= {MAX_DEPTH}, "
        f"or Tq, Tk <= {LONG_TOKENS} with D <= {LONG_DEPTH} (the long route), got "
        f"Tq={tq} Tk={tk} D={depth}")


def _whole_vectors(heads: int, tq: int, tk: int, depth: int) -> bool:
    """Whether a batch element's q and k/v slices are whole 16-byte vectors
    of bf16 (for the bulk copies and the vector stores)."""
    return heads * tq * depth % 8 == 0 and heads * tk * depth % 8 == 0


def kernel_route(dtype: torch.dtype, heads: int, tq: int, tk: int,
                 depth: int) -> str:
    """The forward kernel that takes (B, ``heads``, Tq, D) attention: "long"
    past 32 tokens (up to Tq, Tk <= 160 with D <= 80, either dtype); at Tq,
    Tk <= 32 and D <= 128 "mma" for bf16 where each batch element's q and
    k/v slices are whole 16-byte vectors and q, k and v of one element fit
    a block's shared memory (with its 8-byte barrier), "fma" otherwise.
    Both layouts keep an element's slice contiguous, so the layout does not
    enter. f16 takes "fma" (no f16 "mma" kernel). Raises past the long
    route's reach, and for f16 past 32 tokens (ValueError naming float16:
    the long route's f16 kernel is queued)."""
    if _is_long(tq, tk, depth, dtype):
        return "long"
    if (dtype == torch.bfloat16 and _whole_vectors(heads, tq, tk, depth)
            and 2 * heads * (tq + 2 * tk) * depth + 8 <= MAX_SMEM):
        return "mma"
    return "fma"


def backward_route(dtype: torch.dtype, heads: int, tq: int, tk: int,
                   depth: int) -> str:
    """The backward kernel that takes (B, ``heads``, Tq, D) attention:
    "long" past 32 tokens, as :func:`kernel_route`; at Tq, Tk <= 32 "mma"
    where the forward's vector conditions hold and q, k, v and g of one
    batch element fit a block's shared memory (with its two 8-byte
    barriers), "fma" otherwise (the library's
    ``vptr_attention_core_bwd_route`` says the same). Raises past the long
    route's reach and for f16 past 32 tokens, as :func:`kernel_route`."""
    if _is_long(tq, tk, depth, dtype):
        return "long"
    if (dtype == torch.bfloat16 and _whole_vectors(heads, tq, tk, depth)
            and 4 * heads * (tq + tk) * depth + 16 <= MAX_SMEM):
        return "mma"
    return "fma"


def layout(t: torch.Tensor) -> Optional[int]:
    """0 for a contiguous (B, H, T, D) tensor, 1 for the (B, H, T, D) view
    of a contiguous (B, T, H*D) one (strides (T H D, D, H D, 1)), None for
    any other strides. Where H or T is 1 the two coincide: 0."""
    if t.is_contiguous():
        return 0
    return 1 if t.transpose(1, 2).is_contiguous() else None


@functools.lru_cache(maxsize=None)
def q_scale(depth: int, dtype: torch.dtype) -> float:
    """``depth ** -0.5`` as the JAX kernels multiply q by it: rounded to the
    compute dtype first."""
    return torch.tensor(depth ** -0.5, dtype=dtype).item()


def _logits_and_weights(q, k, bias, seed, dropout_rate, mask_heads=None, head0=0):
    """(q * scale rounded, f32 softmax weights, keep mask or None)."""
    b, h, tq, d = q.shape
    qs = q * torch.tensor(q_scale(d, q.dtype), dtype=q.dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1)
    keep = None
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed, b, h, tq, dropout_rate, k.shape[2],
                                 device=q.device, mask_heads=mask_heads, head0=head0)
    return qs, w, keep


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, seed: Seed = 0,
                         dropout_rate: float = 0.0, mask_heads: Optional[int] = None,
                         head0: int = 0) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``_kernel``): q * scale is rounded to
    q's dtype, logits and softmax are f32, dropout divides the kept f32
    weights by (1 - rate), the weights are rounded to q's dtype before the
    f32-accumulated value product. ``mask_heads``, ``head0``: q, k, v hold
    heads h0 .. h0 + H - 1 of that many (the module notes)."""
    _, w, keep = _logits_and_weights(q, k, bias, seed, dropout_rate, mask_heads, head0)
    weights = apply_dropout(w, keep, dropout_rate).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def attention_core_backward_plain(q, k, v, bias, seed, g, dropout_rate: float = 0.0,
                                  need_dbias: bool = True, mask_heads: Optional[int] = None,
                                  head0: int = 0):
    """Plain backward (mirrors ``_bwd_kernel``): recompute the softmax and
    the mask, run the softmax backward on the pre-dropout f32 weights.
    Returns (dq, dk, dv) in q's dtype and dbias (f32, the bias's shape:
    summed over the batch, and over heads for a (1, Tq, Tk) bias) or None."""
    qs, w, keep = _logits_and_weights(q, k, bias, seed, dropout_rate, mask_heads, head0)
    gf, vf = g.float(), v.float()
    w_drop = apply_dropout(w, keep, dropout_rate)
    dv = torch.matmul(w_drop.transpose(-1, -2), gf)
    dw = apply_dropout(torch.matmul(gf, vf.transpose(-1, -2)), keep, dropout_rate)
    dl = w * (dw - torch.sum(dw * w, dim=-1, keepdim=True))
    dq = torch.matmul(dl, k.float()) * (q.shape[-1] ** -0.5)
    dk = torch.matmul(dl.transpose(-1, -2), qs.float())
    dbias = None
    if bias is not None and need_dbias:
        dbias = dl.sum(0)
        if bias.shape[0] == 1:
            dbias = dbias.sum(0, keepdim=True)
    dt = q.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt), dbias


def seed_tensor(seed: Seed, device) -> torch.Tensor:
    """The seed as a one-element int32 tensor on ``device`` (the kernels
    read it from device memory; a Python int costs a host-to-device copy,
    so callers on the card pass a tensor drawn there)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int32).reshape(1)
    return torch.tensor([int(seed)], dtype=torch.int32, device=device)


def needs_grad(*tensors) -> bool:
    """Whether autograd will want a backward of an op on ``tensors`` (else
    the wrappers skip the autograd.Function and its per-call cost)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _forward(q, k, v, bias, seed, rate, mask_heads=None, head0=0):
    """The forward for either device; ``seed`` a tensor or None (rate 0)."""
    if q.device.type == "cpu":
        return attention_core_plain(q, k, v, bias, seed, rate, mask_heads, head0)
    return _forward_kernel(q, k, v, bias, seed, rate, mask_heads, head0)


class _AttentionCore(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate, mask_heads, head0):
        ctx.save_for_backward(q, k, v, bias, seed)
        ctx.rate, ctx.heads = rate, (mask_heads, head0)
        return _forward(q, k, v, bias, seed, rate, mask_heads, head0)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seed = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        if layout(g) is None:       # e.g. the expanded gradient of a sum
            g = g.contiguous()
        dq, dk, dv, dbias = attention_core_backward(
            q, k, v, bias, seed, g, ctx.rate, need_dbias, *ctx.heads)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, seed: Seed = 0,
                   dropout_rate: float = 0.0, mask_heads: Optional[int] = None,
                   head0: int = 0) -> torch.Tensor:
    """q: (B, H, Tq, D), k/v: (B, H, Tk, D) (on the card Tq, Tk <= 32 with
    D <= 128, or Tq, Tk <= 160 with D <= 80), each contiguous or the (B, H,
    T, D) view of a contiguous (B, T, H*D);
    ``bias``: None or (1 | H, Tq, Tk) additive logits (a causal mask as
    -1e30). ``mask_heads``, ``head0``: the H heads are heads h0 .. h0 + H -
    1 of ``mask_heads`` (their dropout is the whole call's). Returns (B, H,
    Tq, D) in q's dtype (on the card in q's layout); differentiable in q,
    k, v and bias."""
    if q.device.type != "cpu" and not q.is_cuda:
        raise ValueError(f"attention_core: unsupported device {q.device}")
    _check_heads(q.shape[1], mask_heads, head0)
    rate = float(dropout_rate)
    seed = seed_tensor(seed, q.device) if rate > 0.0 else None
    if needs_grad(q, k, v, bias):
        return _AttentionCore.apply(q, k, v, bias, seed, rate, mask_heads, head0)
    return _forward(q, k, v, bias, seed, rate, mask_heads, head0)


def _check_heads(heads: int, mask_heads: Optional[int], head0: int) -> None:
    if mask_heads is None:
        if head0:
            raise ValueError(f"head0 {head0} needs mask_heads")
    elif head0 < 0 or head0 + heads > mask_heads:
        raise ValueError(f"heads {head0} .. {head0 + heads - 1} are not heads of "
                         f"{mask_heads}")


attention_core.launches = 0
attention_core.bwd_launches = 0
attention_core.launches_by_route = dict.fromkeys(_ROUTES, 0)
attention_core.bwd_launches_by_route = dict.fromkeys(_ROUTES, 0)


def attention_core_backward(q, k, v, bias, seed, g, dropout_rate: float = 0.0,
                            need_dbias: bool = True, mask_heads: Optional[int] = None,
                            head0: int = 0):
    """The backward on its own (what the autograd Function calls): the
    kernel for CUDA tensors (counted in ``attention_core.bwd_launches``;
    q, k, v and g each contiguous or in the layer's layout, see
    :func:`layout`), :func:`attention_core_backward_plain` for CPU tensors.
    Returns (dq, dk, dv, dbias or None); on the card dq, dk and dv have
    q's, k's and v's layouts."""
    _check_heads(q.shape[1], mask_heads, head0)
    if q.device.type == "cpu":
        return attention_core_backward_plain(q, k, v, bias, seed, g,
                                             dropout_rate, need_dbias, mask_heads, head0)
    if dropout_rate > 0.0:
        seed = seed_tensor(seed, q.device)
    return _backward_kernel(q, k, v, bias, seed, g, dropout_rate,
                            need_dbias and bias is not None, mask_heads, head0)


def _check(q, k, v, bias):
    """Shape, dtype and layout checks (each of q, k, v in layout 0 or 1);
    returns (bias f32 contiguous or None, bias_heads, the layouts of q, k,
    v)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"attention_core: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    _is_long(tq, tk, d)                  # raises past the long route's reach
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention_core kernel takes float32, bfloat16 or float16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    layouts = tuple(layout(t) for t in (q, k, v))
    for name, t, lay in zip("qkv", (q, k, v), layouts):
        if lay is None or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"attention_core: {name} must be contiguous or the "
                             f"(B, H, T, D) view of a contiguous (B, T, H*D) on "
                             f"{q.device} (16-byte aligned)")
    if bias is None:
        return None, 0, layouts
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    if bias.shape not in ((1, tq, tk), (h, tq, tk)):
        raise ValueError(f"attention_core: bias {tuple(bias.shape)} is "
                         f"not (1|{h}, {tq}, {tk})")
    return bias, bias.shape[0], layouts


def _dropout_args(seed, rate):
    """(seed pointer or None, rate, 1 - rate) as the kernels take them."""
    if rate <= 0.0:
        return None, 0.0, 1.0
    return seed.data_ptr(), rate, 1.0 - rate


def _forward_kernel(q, k, v, bias, seed, rate, mask_heads=None, head0=0):
    bias, bias_heads, layouts = _check(q, k, v, bias)
    b, h, tq, d = q.shape
    route = kernel_route(q.dtype, h, tq, k.shape[2], d)
    out = torch.empty_like(q)            # q's layout (its strides kept)
    ops, res = (q, k, v), out
    if route == "fma" and any(layouts):  # the FMA kernel reads contiguous rows
        ops, layouts = tuple(t.contiguous() for t in ops), (0, 0, 0)
        res = out if out.is_contiguous() else torch.empty_like(ops[0])
    lib = _lib()
    err = lib.vptr_attention_core(
        *(t.data_ptr() for t in ops), _build.ptr(bias), res.data_ptr(), b, h,
        tq, k.shape[2], d, bias_heads, q_scale(d, q.dtype),
        *_dropout_args(seed, rate), _DTYPES[q.dtype], _ROUTES[route], *layouts,
        mask_heads or 0, head0, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, f"attention_core ({route} route)")
    attention_core.launches += 1
    attention_core.launches_by_route[route] += 1
    if res is not out:
        out.copy_(res)
    return out


def _backward_kernel(q, k, v, bias, seed, g, rate, need_dbias, mask_heads=None, head0=0):
    bias, bias_heads, layouts = _check(q, k, v, bias)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    g_layout = layout(g)
    if (g.shape != q.shape or g.dtype != q.dtype or g.device != q.device
            or g_layout is None or g.data_ptr() % 16):
        raise ValueError(f"attention_core backward: g {tuple(g.shape)} "
                         f"{g.dtype} does not match q {tuple(q.shape)} {q.dtype} "
                         f"(contiguous or the (B, H, T, D) view of a contiguous "
                         f"(B, T, H*D), 16-byte aligned)")
    route = backward_route(q.dtype, h, tq, tk, d)
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    ops, res, layouts = (q, k, v, g), grads, layouts + (g_layout,)
    if route == "fma" and any(layouts):  # the FMA kernel reads and writes contiguous rows
        ops = tuple(t.contiguous() for t in ops)
        res = tuple(r if r.is_contiguous() else torch.empty_like(o)
                    for r, o in zip(grads, ops))
        layouts = (0, 0, 0, 0)
    dl = dbias = None
    if need_dbias:
        dl = torch.empty(b, h, tq, tk, dtype=torch.float32, device=q.device)
        dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    lib = _lib()
    p = _build.ptr
    err = lib.vptr_attention_core_bwd(
        *(p(t) for t in ops[:3]), p(bias), p(ops[3]), *(p(t) for t in res), p(dl),
        p(dbias), b, h, tq, tk, d, bias_heads, q_scale(d, q.dtype), d ** -0.5,
        *_dropout_args(seed, rate), _DTYPES[q.dtype], _ROUTES[route], *layouts,
        mask_heads or 0, head0, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, f"attention_core backward ({route} route)")
    attention_core.bwd_launches += 1
    attention_core.bwd_launches_by_route[route] += 1
    for out, r in zip(grads, res):
        if r is not out:
            out.copy_(r)
    return grads + (dbias,)


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention_core")
    fn = lib.vptr_attention_core
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 5 + [i] * 6 + [f, p, f, f] + [i] * 7 + [p]
        fn.restype = ctypes.c_int
        bwd = lib.vptr_attention_core_bwd
        bwd.argtypes = [p] * 10 + [i] * 6 + [f, f, p, f, f] + [i] * 8 + [p]
        bwd.restype = ctypes.c_int
        lib.vptr_attention_core_bwd_route.argtypes = [i] * 5
        lib.vptr_attention_core_bwd_route.restype = ctypes.c_int
    return lib
