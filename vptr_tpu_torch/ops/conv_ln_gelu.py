"""Fused 1x1 conv + whole-sample LayerNorm + affine + GELU over samples.

Counterpart of ``vptr_tpu/ops/fused_conv_ln.py``, whose two TPU kernels are
joined by ``jax.custom_vjp``. Over x (N, HW, Cin), channels last:

    u    = x @ w + b                   (f32 sums of the compute-dtype operands)
    zhat = (u - mean) / sqrt(var + eps)  per sample over all HW * Cout values,
                                       two-pass variance
    y    = gelu(zhat * scale + bias2)  (HW, Cout) affine, A&S GELU (ops/gelu.py)

rounded to x's dtype once. ``MlpDWBN``'s fc1 -> norm1 -> GELU and fc2 ->
norm3 -> GELU stages with ``transformer.fused_conv_ffn`` (``layers.py:660-684``).

* ``_forward`` (``pl.pallas_call`` at :174) -> ``csrc/conv_ln_gelu.cu``
  (kernel #11); ``_backward`` (:196) -> ``csrc/conv_ln_gelu_bwd.cu`` (#12);
  both share ``csrc/conv_ln.cuh`` and, in bf16, ``csrc/conv_ln_wg.cuh``:
  Hopper's warpgroup MMA fed by TMA (``csrc/wgmma.cuh``), whose recomputed
  product takes W transposed, (Cout, Cin), which the wrapper makes; each
  source's note says what bounds it and what the design does about that.
  That is the "cluster" route, for HW <= 64; past it (nar_kth_128's HW
  256) the "tiled" route (``csrc/conv_ln_tiled.cuh``) takes u through
  device memory with per-row partial moments; :func:`kernel_route`, a pure
  function of the shapes, names the route.
* :func:`wgmma_product` runs that product alone (64 rows), and
  :func:`wgmma_product_mn` the backward's weight-gradient product (both
  operands MN-major), for checking the building blocks on the card.
* :func:`conv_ln_gelu` is a ``torch.autograd.Function``: a CUDA tensor
  launches the kernels (or raises), a CPU tensor takes
  :func:`conv_ln_gelu_plain` forward and :func:`conv_ln_gelu_backward_plain`
  backward. Only the inputs are saved for the backward, as in the JAX
  ``custom_vjp``.
* ``conv_ln_gelu.launches`` / ``.bwd_launches`` count launches of #11 / #12
  and nothing else (``.launches_by_route`` / ``.bwd_launches_by_route`` the
  same by route).
* x and w (Cin, Cout) are in the compute dtype; b (Cout,), scale and bias2
  (HW, Cout) f32. The gradients: dx in x's dtype, dw in w's dtype (the JAX
  route passes ``kernel.astype(dtype)``, so in bf16 its weight gradient is
  rounded to bf16 before it reaches the f32 parameter), the rest f32.
* No dropout: the route's dropout is the module's, outside the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from vptr_tpu_torch.ops import _build
from vptr_tpu_torch.ops.attention_core import needs_grad
from vptr_tpu_torch.ops.gelu import gelu_as, gelu_as_grad

LN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("cluster", "tiled")   # as the library numbers them


def _project(x, w, b):
    """u = x @ w + b in f32: (N, HW, Cout)."""
    return torch.matmul(x.float(), w.float()) + b.float()


def _sample_stats(u):
    """(zhat, rstd) of the whole-sample LayerNorm over (HW, Cout), two-pass
    variance (``_fwd_kernel``)."""
    mean = u.mean((1, 2), keepdim=True)
    uc = u - mean
    rstd = torch.rsqrt((uc * uc).mean((1, 2), keepdim=True) + LN_EPS)
    return uc * rstd, rstd


def conv_ln_gelu_plain(x, w, b, scale, bias2) -> torch.Tensor:
    """Plain PyTorch version of kernel #11 (``_reference`` /
    ``_fwd_kernel``, eps 1e-5 as every caller passes): all f32 after the
    product, rounded to x's dtype once."""
    zhat, _ = _sample_stats(_project(x, w, b))
    return gelu_as(zhat * scale.float() + bias2.float()).to(x.dtype)


def conv_ln_gelu_backward_plain(x, w, b, scale, bias2, g):
    """Plain backward of kernel #11 (mirrors ``_bwd_kernel``): recompute u;
    da = g gelu'(a); ds = sum da zhat and dt = sum da over the samples;
    du = (dz - mean dz - zhat mean(dz zhat)) rstd with dz = da scale; dW =
    x^T du, db = sum du and dx = du W^T on f32 operands. Returns (dx, dw,
    db, dscale, dbias2): dx in x's dtype, dw in w's dtype, the rest f32."""
    sc = scale.float()
    zhat, rstd = _sample_stats(_project(x, w, b))
    da = g.float() * gelu_as_grad(zhat * sc + bias2.float())
    dz = da * sc
    du = (dz - dz.mean((1, 2), keepdim=True)
          - zhat * (dz * zhat).mean((1, 2), keepdim=True)) * rstd
    du2 = du.reshape(-1, du.shape[-1])
    dw = torch.matmul(x.float().reshape(-1, x.shape[-1]).t(), du2)
    dx = torch.matmul(du, w.float().t())
    return (dx.to(x.dtype), dw.to(w.dtype), du2.sum(0), (da * zhat).sum(0),
            da.sum(0))


def _forward(x, w, b, scale, bias2):
    """The forward for either device."""
    if x.device.type == "cpu":
        return conv_ln_gelu_plain(x, w, b, scale, bias2)
    return _forward_kernel(x, w, b, scale, bias2)


class _ConvLnGelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, scale, bias2):
        ctx.save_for_backward(x, w, b, scale, bias2)
        return _forward(x, w, b, scale, bias2)

    @staticmethod
    def backward(ctx, g):
        x, w, b, scale, bias2 = ctx.saved_tensors
        grads = conv_ln_gelu_backward(x, w, b, scale, bias2, g.contiguous())
        return tuple(d.to(r.dtype) for d, r in zip(grads, (x, w, b, scale, bias2)))


def conv_ln_gelu(x, w, b, scale, bias2) -> torch.Tensor:
    """gelu(LN_sample(x @ w + b) * scale + bias2) over x (N, HW, Cin); see
    the module docstring. Differentiable in every tensor."""
    if x.device.type != "cpu" and not x.is_cuda:
        raise ValueError(f"conv_ln_gelu: unsupported device {x.device}")
    if needs_grad(x, w, b, scale, bias2):
        return _ConvLnGelu.apply(x, w, b, scale, bias2)
    return _forward(x, w, b, scale, bias2)


conv_ln_gelu.launches = 0
conv_ln_gelu.bwd_launches = 0
conv_ln_gelu.launches_by_route = dict.fromkeys(ROUTES, 0)
conv_ln_gelu.bwd_launches_by_route = dict.fromkeys(ROUTES, 0)


def conv_ln_gelu_backward(x, w, b, scale, bias2, g):
    """The backward on its own (what the autograd Function calls): kernel
    #12 for CUDA tensors (counted in ``conv_ln_gelu.bwd_launches``),
    :func:`conv_ln_gelu_backward_plain` for CPU tensors. Returns the tuple
    that function documents."""
    if x.device.type == "cpu":
        return conv_ln_gelu_backward_plain(x, w, b, scale, bias2, g)
    return _backward_kernel(x, w, b, scale, bias2, g)


SMEM_LIMIT = 231424   # bytes of dynamic shared memory a block may take here

# The cluster route's slabs (csrc/conv_ln.cuh: kClnWarps, kClnMaxCt,
# kClnMaxCluster) and the tiled route's limit (csrc/conv_ln_tiled.cuh)
CLN_WARPS, CLN_MAX_CT, CLN_MAX_CLUSTER = 11, 3, 8
TILED_MAX_HW, TILED_MAX_N = 4096, 65535


def cluster_split(cout: int) -> int:
    """Blocks per sample (the thread-block cluster size) the cluster route
    takes for Cout output channels; 0 when it does not take Cout. A pure
    function (``cln_split``): the smallest G <= 8 that splits Cout / 16
    column tiles into slabs of at most 22 tiles, else of at most 33."""
    if cout < 16 or cout % 16:
        return 0
    nt = cout // 16
    for cap in (2 * CLN_WARPS, CLN_MAX_CT * CLN_WARPS):
        for g in range(1, CLN_MAX_CLUSTER + 1):
            if nt % g == 0 and nt // g <= cap:
                return g
    return 0


def kernel_route(hw: int, cin: int, cout: int, dtype: torch.dtype):
    """Which route kernels #11 and #12 take for samples of (HW, Cin) ->
    Cout, in ``dtype`` (the same in both): ``"cluster"`` (HW a multiple of
    16 up to 64 and Cout that :func:`cluster_split` splits: a sample a
    thread-block cluster, its u in registers), ``"tiled"`` (every other HW
    a multiple of 16 up to 4096: u through device memory with per-row
    partial moments) or None (no route: a CUDA tensor raises); Cin and
    Cout multiples of 16 on both. A pure function of the shapes, equal to
    the library's ``vptr_conv_ln_gelu_route``."""
    if (dtype not in _DTYPES or hw < 16 or hw % 16 or cin < 16 or cin % 16
            or cout < 16 or cout % 16):
        return None
    if hw <= 64 and cluster_split(cout):
        return "cluster"
    return "tiled" if hw <= TILED_MAX_HW else None


def _operands(x, w, b, scale, bias2):
    """Check every operand against what the kernels take; returns (N, HW,
    Cin, Cout, route). Rows and weights are read in 16-byte pieces."""
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"conv_ln_gelu kernel takes x (N, HW, Cin) in float32 or "
                         f"bfloat16, got {tuple(x.shape)} {x.dtype}")
    n, hw, cin = x.shape
    cout = w.shape[-1]
    route = kernel_route(hw, cin, cout, x.dtype)
    if route is None or (route == "tiled" and n > TILED_MAX_N):
        raise ValueError(f"conv_ln_gelu kernel takes HW a multiple of 16 (up to 64 on the "
                         f"cluster route, whose Cout splits into at most 8 slabs; up to "
                         f"{TILED_MAX_HW} and N <= {TILED_MAX_N} on the tiled route) and "
                         f"Cin, Cout multiples of 16; got N={n} HW={hw} Cin={cin} "
                         f"Cout={cout}")
    f32 = torch.float32
    for name, t, shape, dtype in (
            ("x", x, (n, hw, cin), x.dtype), ("w", w, (cin, cout), x.dtype),
            ("b", b, (cout,), f32), ("scale", scale, (hw, cout), f32),
            ("bias2", bias2, (hw, cout), f32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"conv_ln_gelu: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"wants {shape} {dtype}")
        if not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"conv_ln_gelu: {name} must be contiguous on "
                             f"{x.device} (16-byte aligned)")
    return n, hw, cin, cout, route


def _tiled_scratch(n, hw, cout, device):
    """The tiled route's f32 scratch: u (N HW, Cout), the per-row partials
    (N, HW, 2) and the per-sample statistics (2, N, 2; the forward uses the
    first N x 2)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty(n * hw, cout, **f32), torch.empty(n, hw, 2, **f32),
            torch.empty(2, n, 2, **f32))


def _forward_kernel(x, w, b, scale, bias2):
    n, hw, cin, cout, route = _operands(x, w, b, scale, bias2)
    lib = _lib()
    out = torch.empty(n, hw, cout, dtype=x.dtype, device=x.device)
    p = _build.ptr
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "tiled":
        u, part, stats = _tiled_scratch(n, hw, cout, x.device)
        err = lib.vptr_conv_ln_gelu_tiled(p(x), p(w), p(b), p(scale), p(bias2), p(out), p(u),
                                          p(part), p(stats), n, hw, cin, cout, LN_EPS,
                                          _DTYPES[x.dtype], stream)
    else:
        smem = lib.vptr_conv_ln_gelu_smem(hw, cout, _DTYPES[x.dtype])
        if smem > SMEM_LIMIT:
            raise ValueError(f"conv_ln_gelu kernel: HW={hw}, Cout={cout} needs {smem} B "
                             f"of shared memory (> {SMEM_LIMIT})")
        if x.dtype == torch.bfloat16:
            w = w.t().contiguous()          # K-major, (Cout, Cin), for the wgmma product
        err = lib.vptr_conv_ln_gelu(p(x), p(w), p(b), p(scale), p(bias2), p(out), n, hw,
                                    cin, cout, LN_EPS, _DTYPES[x.dtype], stream)
    _build.check(lib, err, f"conv_ln_gelu ({route})")
    conv_ln_gelu.launches += 1
    conv_ln_gelu.launches_by_route[route] += 1
    return out


def wgmma_product(a, bt) -> torch.Tensor:
    """a (64, K) @ bt.T in f32 on the forward's wgmma ring product, with a
    and bt (cols, K) bf16 on the card, K a multiple of 16 and cols a
    multiple of 16 up to 528: the building blocks of ``csrc/wgmma.cuh`` on
    their own. Not counted in ``conv_ln_gelu.launches``."""
    k = a.shape[-1]
    if (a.dtype != torch.bfloat16 or bt.dtype != torch.bfloat16 or not a.is_cuda
            or bt.device != a.device or a.shape != (64, k) or bt.dim() != 2
            or bt.shape[1] != k
            or not (a.is_contiguous() and bt.is_contiguous())):
        raise ValueError(f"wgmma_product takes a (64, K) and bt (cols, K) bf16 on the "
                         f"card, got {tuple(a.shape)} {a.dtype}, {tuple(bt.shape)} {bt.dtype}")
    out = torch.empty(64, bt.shape[0], dtype=torch.float32, device=a.device)
    lib = _lib()
    err = lib.vptr_wgmma_product(_build.ptr(a), _build.ptr(bt), _build.ptr(out), k,
                                 bt.shape[0], torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "wgmma_product")
    return out


def wgmma_product_mn(a, b) -> torch.Tensor:
    """a.T @ b in f32 on the backward's weight-gradient product (``wgmma``
    with both operands MN-major, as x and du lie in memory), with a (K, M)
    and b (K, N) bf16 on the card, M and N multiples of 8: that product on
    its own. Not counted in ``conv_ln_gelu.bwd_launches``."""
    k = a.shape[0]
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or not a.is_cuda
            or b.device != a.device or a.dim() != 2 or b.dim() != 2 or b.shape[0] != k
            or a.shape[1] % 8 or b.shape[1] % 8
            or not (a.is_contiguous() and b.is_contiguous())):
        raise ValueError(f"wgmma_product_mn takes a (K, M) and b (K, N) bf16 on the card, "
                         f"M and N multiples of 8, got {tuple(a.shape)} {a.dtype}, "
                         f"{tuple(b.shape)} {b.dtype}")
    out = torch.empty(a.shape[1], b.shape[1], dtype=torch.float32, device=a.device)
    lib = _lib_bwd()
    err = lib.vptr_wgmma_product_mn(_build.ptr(a), _build.ptr(b), _build.ptr(out), k,
                                    a.shape[1], b.shape[1],
                                    torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "wgmma_product_mn")
    return out


class _BwdArgs(ctypes.Structure):
    """Mirror of ``ClnBwdArgs`` in ``csrc/conv_ln_gelu_bwd.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "w", "wt", "b", "scale", "bias2", "g", "dx", "dw", "db", "ds", "dt",
        "du", "pds", "pdt", "pdb", "dbfull", "wpart", "partial", "u", "tpart", "tstats")]
        + [(n, ctypes.c_int) for n in ("N", "HW", "Cin", "Cout", "dtype", "groups",
                                       "ksplit")]
        + [("eps", ctypes.c_float)])


def _backward_kernel(x, w, b, scale, bias2, g):
    n, hw, cin, cout, route = _operands(x, w, b, scale, bias2)
    if g.shape != (n, hw, cout) or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"conv_ln_gelu backward: g {tuple(g.shape)} {g.dtype} "
                         f"does not match the output {(n, hw, cout)} {x.dtype}")
    dt, dev, f32 = x.dtype, x.device, torch.float32
    lib = _lib_bwd()
    rows = n * hw
    groups = lib.vptr_conv_ln_gelu_bwd_groups(n, hw, cout, _DTYPES[dt])
    ksplit = lib.vptr_conv_ln_gelu_bwd_ksplit(rows)
    parts = lib.vptr_conv_ln_gelu_bwd_partials(hw)

    def buf(*shape, dtype=f32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    grads = dict(dx=torch.empty_like(x), dw=torch.empty_like(w), db=buf(cout),
                 ds=buf(hw, cout), dt=buf(hw, cout))
    # scratch: du (f32, or its bf16 hi/lo halves for the tensor cores), the
    # sample groups' partial sums (bf16: a group a sample), the per-position
    # db, the split-K weight-gradient partials and the column-sum partials of db
    scratch = dict(du=buf(2, rows, cout, dtype=dt) if dt == torch.bfloat16
                   else buf(rows, cout),
                   pds=buf(groups, hw, cout), pdt=buf(groups, hw, cout),
                   pdb=buf(groups, hw, cout), dbfull=buf(hw, cout),
                   wpart=buf(ksplit, cin, cout), partial=buf(parts, cout))
    # the cluster route in bf16: W^T (Cout, Cin) too, K-major for the
    # recomputed product on wgmma; the tiled route: u and the statistics
    wt = w.t().contiguous() if dt == torch.bfloat16 and route == "cluster" else None
    if route == "tiled":
        scratch.update(zip(("u", "tpart", "tstats"), _tiled_scratch(n, hw, cout, dev)))
    p = _build.ptr
    a = _BwdArgs(x=p(x), w=p(w), wt=p(wt), b=p(b), scale=p(scale), bias2=p(bias2), g=p(g),
                 **{k: p(v) for k, v in grads.items()},
                 **{k: p(v) for k, v in scratch.items()},
                 N=n, HW=hw, Cin=cin, Cout=cout, dtype=_DTYPES[dt], groups=groups,
                 ksplit=ksplit, eps=LN_EPS)
    err = lib.vptr_conv_ln_gelu_bwd(ctypes.byref(a),
                                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"conv_ln_gelu backward ({route})")
    conv_ln_gelu.bwd_launches += 1
    conv_ln_gelu.bwd_launches_by_route[route] += 1
    return tuple(grads[k] for k in ("dx", "dw", "db", "ds", "dt"))


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_ln_gelu")
    fn = lib.vptr_conv_ln_gelu
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 6 + [i] * 4 + [f, i, p]
        fn.restype = ctypes.c_int
        lib.vptr_conv_ln_gelu_route.argtypes = [i] * 4
        lib.vptr_conv_ln_gelu_route.restype = ctypes.c_int
        lib.vptr_conv_ln_gelu_tiled.argtypes = [p] * 9 + [i] * 4 + [f, i, p]
        lib.vptr_conv_ln_gelu_tiled.restype = ctypes.c_int
        lib.vptr_conv_ln_gelu_smem.argtypes = [i, i, i]
        lib.vptr_conv_ln_gelu_smem.restype = ctypes.c_long
        lib.vptr_wgmma_product.argtypes = [p] * 3 + [i] * 2 + [p]
        lib.vptr_wgmma_product.restype = ctypes.c_int
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("conv_ln_gelu_bwd")
    fn = lib.vptr_conv_ln_gelu_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_BwdArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.vptr_conv_ln_gelu_bwd_groups.argtypes = [ctypes.c_int] * 4
        lib.vptr_conv_ln_gelu_bwd_groups.restype = ctypes.c_int
        lib.vptr_wgmma_product_mn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.vptr_wgmma_product_mn.restype = ctypes.c_int
        for part in ("ksplit", "partials"):
            f = getattr(lib, f"vptr_conv_ln_gelu_bwd_{part}")
            f.argtypes = [ctypes.c_int]
            f.restype = ctypes.c_int
    return lib
