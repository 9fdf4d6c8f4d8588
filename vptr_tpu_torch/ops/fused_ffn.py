"""Fused LayerNorm + linear feed-forward sublayer (norm4 + Mlp) over rows.

Counterpart of ``vptr_tpu/ops/fused_ffn.py``, whose two TPU kernels are
joined by ``jax.custom_vjp``:

    xn = LN(x) * ls + lb                     (f32 statistics, rounded to T)
    h  = gelu(xn @ w1 + b1)                  (f32; A&S erf, ops/gelu.py)
    hd = dropout(h)                          (counter hash, ops/dropout.py)
    y  = bf16(hd) @ w2 + b2                  (f32 sums, rounded to T once)

* ``_forward`` (``pl.pallas_call`` at :188) -> ``csrc/fused_ffn.cu``
  (kernel #7); ``_backward`` (:214) -> ``csrc/fused_ffn_bwd.cu`` (#8). The
  sources' notes say what bounds each on the card and what the design does
  about that.
* :func:`fused_ffn` is a ``torch.autograd.Function``: a CUDA tensor
  launches the kernels (or raises), a CPU tensor takes
  :func:`fused_ffn_plain` forward and :func:`fused_ffn_backward_plain`
  backward. It saves only its inputs for the backward, as the JAX
  ``custom_vjp`` does (the backward recomputes the hidden).
* ``fused_ffn.launches`` / ``.bwd_launches`` count launches of #7 / #8 and
  nothing else.
* x (S, C) and the weights (w1 (C, H), w2 (H, C), the JAX Dense layout)
  are in the compute dtype T; b1, b2, ls, lb are f32. The gradients come
  back in each operand's dtype.
* Tensor parallelism: a call over hidden columns c0 .. c0 + Hl - 1 of Hg
  (``mask_cols`` Hg, ``col0`` c0: w1's columns, b1's and w2's rows, b2
  zero) gives the rank's partial sum of y; its hidden dropout is the whole
  call's mask at those columns, its dx, dls, dlb partial sums and dW1,
  db1, dW2 the rank's shares (``models/layers.py::Mlp`` sums them over the
  model group).
"""

from __future__ import annotations

import ctypes

import torch

from vptr_tpu_torch.ops import _build
from vptr_tpu_torch.ops.attention_core import _dropout_args, needs_grad, seed_tensor
from vptr_tpu_torch.ops.dropout import Seed, apply_dropout, ffn_keep_mask
from vptr_tpu_torch.ops.gelu import gelu_as, gelu_as_grad

LN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ln_rows(x2, ls, lb):
    """Per-row LayerNorm in f32 (two-pass variance, as ``_ln_rows``):
    returns (xn f32, xhat, rstd)."""
    mean = x2.mean(1, keepdim=True)
    xc = x2 - mean
    rstd = torch.rsqrt((xc * xc).mean(1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    return xhat * ls.float() + lb.float(), xhat, rstd


def _keep(seed, rows, hidden, rate, device, mask_cols=None, col0=0):
    return (ffn_keep_mask(seed, rows, hidden, rate, device, mask_cols, col0)
            if rate > 0.0 else None)


def fused_ffn_plain(x, w1, b1, w2, b2, ls, lb, seed: Seed = 0,
                    rate: float = 0.0, mask_cols=None, col0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel #7 (``_reference_ffn``): xn rounded
    to x's dtype, fc1 in f32 + b1, the A&S GELU, the hash dropout (at the
    hidden columns c0 .. of ``mask_cols``, default all), the hidden rounded
    to x's dtype, fc2 in f32 + b2, rounded once."""
    dt = x.dtype
    xn = _ln_rows(x.float(), ls, lb)[0].to(dt)
    a = torch.matmul(xn.float(), w1.float()) + b1.float()
    keep = _keep(seed, x.shape[0], w1.shape[1], rate, x.device, mask_cols, col0)
    hd = apply_dropout(gelu_as(a), keep, rate).to(dt)
    return (torch.matmul(hd.float(), w2.float()) + b2.float()).to(dt)


def fused_ffn_backward_plain(x, w1, b1, w2, b2, ls, lb, seed, g,
                             rate: float = 0.0, mask_cols=None, col0: int = 0):
    """Plain backward of kernel #7 (mirrors ``_bwd_kernel``): recompute
    xn (rounded) and the f32 hidden; every product on f32 operands, dW2
    from the unrounded dropped hidden (the forward's fc2 took it rounded).
    Returns (dx, dw1, db1, dw2, db2, dls, dlb): dx in x's dtype, the
    weight gradients in the weights' dtype, the vectors f32."""
    dt = x.dtype
    g2 = g.float()
    xn32, xhat, rstd = _ln_rows(x.float(), ls, lb)
    xn = xn32.to(dt).float()
    a = torch.matmul(xn, w1.float()) + b1.float()
    keep = _keep(seed, x.shape[0], w1.shape[1], rate, x.device, mask_cols, col0)
    hd = apply_dropout(gelu_as(a), keep, rate)
    dw2 = torch.matmul(hd.t(), g2)
    dh = apply_dropout(torch.matmul(g2, w2.float().t()), keep, rate)
    da = dh * gelu_as_grad(a)
    dw1 = torch.matmul(xn.t(), da)
    dxn = torch.matmul(da, w1.float().t())
    dxhat = dxn * ls.float()
    m1 = dxhat.mean(1, keepdim=True)
    m2 = (dxhat * xhat).mean(1, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * rstd
    return (dx.to(dt), dw1.to(w1.dtype), da.sum(0), dw2.to(w2.dtype),
            g2.sum(0), (dxn * xhat).sum(0), dxn.sum(0))


def _forward(x, w1, b1, w2, b2, ls, lb, seed, rate, mask_cols=None, col0=0):
    """The forward for either device; ``seed`` a tensor or None (rate 0)."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2, ls, lb, seed, rate, mask_cols, col0)
    return _forward_kernel(x, w1, b1, w2, b2, ls, lb, seed, rate, mask_cols, col0)


class _FusedFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ls, lb, seed, rate, mask_cols, col0):
        ctx.save_for_backward(x, w1, b1, w2, b2, ls, lb, seed)
        ctx.rate, ctx.cols = rate, (mask_cols, col0)
        return _forward(x, w1, b1, w2, b2, ls, lb, seed, rate, mask_cols, col0)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, ls, lb, seed = ctx.saved_tensors
        grads = fused_ffn_backward(x, w1, b1, w2, b2, ls, lb, seed,
                                   g.contiguous(), ctx.rate, *ctx.cols)
        refs = (x, w1, b1, w2, b2, ls, lb)
        return tuple(d.to(r.dtype) for d, r in zip(grads, refs)) + (None,) * 4


def fused_ffn(x, w1, b1, w2, b2, ls, lb, seed: Seed = 0,
              rate: float = 0.0, mask_cols=None, col0: int = 0) -> torch.Tensor:
    """norm4 + Mlp over x (S, C): ``ls``/``lb`` the LayerNorm affine (C,),
    ``seed``/``rate`` the in-kernel hidden dropout. The caller adds the
    residual and the block's outer dropout. ``mask_cols``, ``col0``: the
    call holds hidden columns c0 .. c0 + H - 1 of ``mask_cols`` (tensor
    parallelism; the module notes). Differentiable in every tensor but the
    seed."""
    if x.device.type != "cpu" and not x.is_cuda:
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    if col0 < 0 or col0 + w1.shape[-1] > (mask_cols or w1.shape[-1]):
        raise ValueError(f"fused_ffn: hidden columns {col0} .. {col0 + w1.shape[-1] - 1} are "
                         f"not columns of {mask_cols}")
    rate = float(rate)
    seed = seed_tensor(seed, x.device) if rate > 0.0 else None
    if needs_grad(x, w1, b1, w2, b2, ls, lb):
        return _FusedFFN.apply(x, w1, b1, w2, b2, ls, lb, seed, rate, mask_cols, col0)
    return _forward(x, w1, b1, w2, b2, ls, lb, seed, rate, mask_cols, col0)


fused_ffn.launches = 0
fused_ffn.bwd_launches = 0


def fused_ffn_backward(x, w1, b1, w2, b2, ls, lb, seed, g, rate: float = 0.0,
                       mask_cols=None, col0: int = 0):
    """The backward on its own (what the autograd Function calls): kernel
    #8 for CUDA tensors (counted in ``fused_ffn.bwd_launches``),
    :func:`fused_ffn_backward_plain` for CPU tensors. Returns the tuple
    that function documents."""
    if x.device.type == "cpu":
        return fused_ffn_backward_plain(x, w1, b1, w2, b2, ls, lb, seed, g,
                                        rate, mask_cols, col0)
    if rate > 0.0:
        seed = seed_tensor(seed, x.device)
    return _backward_kernel(x, w1, b1, w2, b2, ls, lb, seed, g, rate, mask_cols, col0)


def kernel_route(channels: int, hidden: int, dtype: torch.dtype) -> str:
    """Which route kernel #7 takes: ``"wgmma"`` (bf16 on the warpgroup
    MMA, fed by TMA) or ``"fma"`` (f32 FMAs on the CUDA cores)."""
    code = _build.dtype_code(_DTYPES, dtype, "fused_ffn (#7/#8)")
    return "wgmma" if _lib().vptr_fused_ffn_route(channels, hidden, code) else "fma"


def backward_route(channels: int, hidden: int, dtype: torch.dtype) -> str:
    """Which route kernel #8 takes: ``"wgmma"`` (bf16, C and H multiples
    of 8: every product on the warpgroup MMA, fed by TMA) or ``"fma"`` (f32
    FMAs on the CUDA cores)."""
    code = _build.dtype_code(_DTYPES, dtype, "fused_ffn (#7/#8)")
    return "wgmma" if _lib_bwd().vptr_fused_ffn_bwd_route(channels, hidden, code) else "fma"


def fc1_product(a, b) -> torch.Tensor:
    """a @ b in f32 on kernel #7's fc1 product (``wgmma`` m64n64k16 with b
    read MN-major, as w1 is stored), with a (64, K) and b (K, N) bf16 on
    the card, K a multiple of 16 up to 576 and N a multiple of 16: that
    product on its own. Not counted in ``fused_ffn.launches``."""
    k = a.shape[-1]
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or not a.is_cuda
            or b.device != a.device or a.shape != (64, k) or b.dim() != 2
            or b.shape[0] != k or k % 16 or k > 576 or b.shape[1] % 16
            or not (a.is_contiguous() and b.is_contiguous())):
        raise ValueError(f"fc1_product takes a (64, K) and b (K, N) bf16 on the card, "
                         f"K a multiple of 16 up to 576, N a multiple of 16, got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} {b.dtype}")
    out = torch.empty(64, b.shape[1], dtype=torch.float32, device=a.device)
    lib = _lib()
    err = lib.vptr_ffn_fc1_product(_build.ptr(a), _build.ptr(b), _build.ptr(out), k,
                                   b.shape[1], torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "fc1_product")
    return out


def weight_product(a, b_hi, b_lo, transposed: bool = False) -> torch.Tensor:
    """a^T (b_hi + b_lo) in f32 on kernel #8's weight-gradient product
    (``wgmma`` with both operands MN-major as they lie in memory, K = rows
    split in #8's chunks, whose partials are summed in order), with a (K,
    M) and b_hi, b_lo (K, N) bf16 on the card, M and N multiples of 8: (M,
    N), or (N, M) when ``transposed``, as dW1 and dW2 are written. That
    product on its own; not counted in ``fused_ffn.bwd_launches``."""
    k, m = a.shape if a.dim() == 2 else (0, 0)
    n = b_hi.shape[-1]
    if (a.dim() != 2 or not a.is_cuda or k < 1 or m % 8 or n % 8 or m < 8 or n < 8
            or any(t.dtype != torch.bfloat16 or t.device != a.device
                   or not t.is_contiguous() or t.data_ptr() % 16 for t in (a, b_hi, b_lo))
            or b_hi.shape != (k, n) or b_lo.shape != (k, n)):
        raise ValueError(f"weight_product takes a (K, M) and b_hi, b_lo (K, N) bf16 on the "
                         f"card, M and N multiples of 8, got {tuple(a.shape)} {a.dtype}, "
                         f"{tuple(b_hi.shape)} {b_hi.dtype}, {tuple(b_lo.shape)} {b_lo.dtype}")
    lib = _lib_bwd()
    sizes = (ctypes.c_int * 4)()
    lib.vptr_fused_ffn_bwd_scratch(k, m, n, _DTYPES[torch.bfloat16], sizes)
    part = torch.empty(sizes[1], m, n, dtype=torch.float32, device=a.device)
    out = torch.empty((n, m) if transposed else (m, n), dtype=torch.float32, device=a.device)
    p = _build.ptr
    err = lib.vptr_ffn_weight_product(p(a), p(b_hi), p(b_lo), p(part), p(out), k, m, n,
                                      int(transposed),
                                      torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "weight_product")
    return out


def _operands(x, w1, b1, w2, b2, ls, lb):
    """Check every operand against what the kernels take; returns (S, C,
    H). Rows and weights are read in 16-byte pieces."""
    _build.dtype_code(_DTYPES, x.dtype, "fused_ffn (#7/#8)")
    if x.dim() != 2:
        raise ValueError(f"fused_ffn kernel takes x (S, C), got {tuple(x.shape)}")
    s, c = x.shape
    h = w1.shape[-1]
    f32 = torch.float32
    for name, t, shape, dtype in (
            ("x", x, (s, c), x.dtype), ("w1", w1, (c, h), x.dtype),
            ("b1", b1, (h,), f32), ("w2", w2, (h, c), x.dtype),
            ("b2", b2, (c,), f32), ("ls", ls, (c,), f32), ("lb", lb, (c,), f32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused_ffn: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"wants {shape} {dtype}")
        if not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"fused_ffn: {name} must be contiguous on "
                             f"{x.device} (16-byte aligned)")
    return s, c, h


SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90


def _forward_kernel(x, w1, b1, w2, b2, ls, lb, seed, rate, mask_cols=None, col0=0):
    s, c, h = _operands(x, w1, b1, w2, b2, ls, lb)
    lib = _lib()
    smem = lib.vptr_fused_ffn_smem(c, h, _DTYPES[x.dtype])
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_ffn kernel: C={c}, {x.dtype} needs {smem} B "
                         f"of shared memory (> {SMEM_LIMIT})")
    out = torch.empty_like(x)
    # scratch for the f32 sums of the row tiles that two blocks share
    n_part = lib.vptr_fused_ffn_partials(s, c, h, _DTYPES[x.dtype])
    if n_part < 0:
        raise RuntimeError("fused_ffn kernel: the card's SM count cannot be read")
    part = torch.empty(n_part, dtype=torch.float32, device=x.device) if n_part else None
    p = _build.ptr
    err = lib.vptr_fused_ffn(
        p(x), p(w1), p(b1), p(w2), p(b2), p(ls), p(lb), p(out), p(part), s, c, h,
        LN_EPS, *_dropout_args(seed, rate), mask_cols or 0, col0, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "fused_ffn")
    fused_ffn.launches += 1
    return out


class _BwdArgs(ctypes.Structure):
    """Mirror of ``FfnBwdArgs`` in ``csrc/fused_ffn_bwd.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "w1", "b1", "w2", "b2", "ls", "lb", "seed", "g",
        "dx", "dw1", "db1", "dw2", "db2", "dls", "dlb",
        "mean", "rstd", "xn", "act", "dact", "hilo", "dbpart", "dxn", "wpart1",
        "wpart2", "partial")]
        + [(n, ctypes.c_int) for n in ("rows", "channels", "hidden", "dtype",
                                       "ksplit", "parts", "mask_cols", "col0")]
        + [(n, ctypes.c_float) for n in ("eps", "rate", "keep_div")])


def _backward_kernel(x, w1, b1, w2, b2, ls, lb, seed, g, rate, mask_cols=None, col0=0):
    s, c, h = _operands(x, w1, b1, w2, b2, ls, lb)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() \
            or g.data_ptr() % 16:
        raise ValueError(f"fused_ffn backward: g {tuple(g.shape)} {g.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    dt, dev, f32 = x.dtype, x.device, torch.float32
    lib = _lib_bwd()
    wg = bool(lib.vptr_fused_ffn_bwd_route(c, h, _DTYPES[dt]))
    sizes = (ctypes.c_int * 4)()
    lib.vptr_fused_ffn_bwd_scratch(s, c, h, _DTYPES[dt], sizes)
    rows, ksplit, parts, dbparts = sizes

    def buf(*shape, dtype=f32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    grads = dict(dx=torch.empty_like(x), dw1=torch.empty_like(w1), db1=buf(h),
                 dw2=torch.empty_like(w2), db2=buf(c), dls=buf(c), dlb=buf(c))
    # scratch: the LayerNorm pass; the hidden and its gradient, on the
    # wgmma route as the bf16 hi/lo halves of both (rows padded to the
    # product kernel's 64-row tiles) and db1's row partials, on the FMA
    # route in f32; d(xn), the split-K weight-gradient partials (dW2's
    # transposed on the wgmma route) and the column-sum partials
    scratch = dict(mean=buf(s), rstd=buf(s), xn=buf(s, c, dtype=dt),
                   act=None if wg else buf(s, h), dact=None if wg else buf(s, h),
                   hilo=buf(4, rows, h, dtype=dt) if wg else None,
                   dbpart=buf(dbparts, h) if wg else None,
                   dxn=buf(rows, c), wpart1=buf(ksplit, c, h),
                   wpart2=buf(ksplit, c, h) if wg else buf(ksplit, h, c),
                   partial=buf(parts, h + 3 * c))
    p = _build.ptr
    seed_p, rate, keep_div = _dropout_args(seed, rate)
    a = _BwdArgs(x=p(x), w1=p(w1), b1=p(b1), w2=p(w2), b2=p(b2), ls=p(ls),
                 lb=p(lb), seed=seed_p, g=p(g),
                 **{k: p(v) for k, v in grads.items()},
                 **{k: p(v) for k, v in scratch.items()},
                 rows=s, channels=c, hidden=h, dtype=_DTYPES[dt],
                 ksplit=ksplit, parts=parts, mask_cols=mask_cols or 0, col0=col0,
                 eps=LN_EPS, rate=rate, keep_div=keep_div)
    err = lib.vptr_fused_ffn_bwd(ctypes.byref(a),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused_ffn backward")
    fused_ffn.bwd_launches += 1
    return tuple(grads[k] for k in ("dx", "dw1", "db1", "dw2", "db2", "dls",
                                    "dlb"))


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ffn")
    fn = lib.vptr_fused_ffn
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 9 + [i] * 3 + [f, p, f, f, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.vptr_fused_ffn_smem.argtypes = [i] * 3
        lib.vptr_fused_ffn_smem.restype = ctypes.c_long
        lib.vptr_fused_ffn_partials.argtypes = [i] * 4
        lib.vptr_fused_ffn_partials.restype = ctypes.c_long
        lib.vptr_fused_ffn_route.argtypes = [i] * 3
        lib.vptr_fused_ffn_route.restype = ctypes.c_int
        lib.vptr_ffn_fc1_product.argtypes = [p] * 3 + [i] * 2 + [p]
        lib.vptr_ffn_fc1_product.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("fused_ffn_bwd")
    fn = lib.vptr_fused_ffn_bwd
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_BwdArgs), ctypes.c_void_p]
        fn.restype = i
        lib.vptr_fused_ffn_bwd_route.argtypes = [i] * 3
        lib.vptr_fused_ffn_bwd_route.restype = i
        lib.vptr_fused_ffn_bwd_scratch.argtypes = [i] * 4 + [ctypes.POINTER(i)]
        lib.vptr_fused_ffn_bwd_scratch.restype = None
        lib.vptr_ffn_weight_product.argtypes = [ctypes.c_void_p] * 5 + [i] * 4 + [
            ctypes.c_void_p]
        lib.vptr_ffn_weight_product.restype = i
    return lib
