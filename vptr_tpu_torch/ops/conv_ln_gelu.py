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
* Tensor parallelism (``model`` = (M, m)), the two stages of the conv FFN:
  fc1 column-parallel (the default): w, b, scale and bias2 are model rank
  m's share of the Cout channels and the LayerNorm runs over every rank's;
  fc2 row-parallel (``rows=True``): x and w are the rank's share of the Cin
  channels, the ranks' partial products are summed in f32 before b, and the
  output (and b, scale, bias2 and their gradients) is the whole call's on
  every rank. On the card both take the tiled route as steps with the
  model group's exchanges between them, whatever :func:`kernel_route`
  names for the whole shape (:func:`split_forward`, :func:`split_backward`:
  each row's partial moments and LN backward sums over the share gathered
  and merged as HW M partials, so a rank's output differs from the whole
  tiled call's slice by rounding; :func:`rows_forward`,
  :func:`rows_backward`: the partial u gathered and summed in rank order,
  the rest the whole tiled call's, u and the statistics kept for the
  backward). A shape those steps do not take raises. The plain versions
  take the sums over the model group (``ops/_split.py``) and the reduced
  product (:func:`~vptr_tpu_torch.parallel.mesh.reduce_model`). fc1's dx
  is the rank's partial sum (the caller's ``enter_model`` adds them up),
  fc2's the rank's share of the whole.
"""

from __future__ import annotations

import ctypes

import torch

from vptr_tpu_torch.ops import _build
from vptr_tpu_torch.ops._split import (
    model_exchange,
    run_split,
    sample_ln,
    sample_mean,
    share_model,
)
from vptr_tpu_torch.ops.attention_core import needs_grad
from vptr_tpu_torch.ops.gelu import gelu_as, gelu_as_grad
from vptr_tpu_torch.parallel.mesh import reduce_model

LN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("cluster", "tiled")   # as the library numbers them
TP_ROUTES = ("tiled_split", "tiled_rows")   # the tiled route's steps, fc1 / fc2 under TP


def _project(x, w, b, model=None, rows=False):
    """u = x @ w + b in f32: (N, HW, Cout); row-parallel (``rows`` under
    ``model``) the product summed over the model group before b."""
    u = torch.matmul(x.float(), w.float())
    if rows and model is not None:
        u = reduce_model(u)
    return u + b.float()


def conv_ln_gelu_plain(x, w, b, scale, bias2, model=None, rows=False) -> torch.Tensor:
    """Plain PyTorch version of kernel #11 (``_reference`` /
    ``_fwd_kernel``, eps 1e-5 as every caller passes): all f32 after the
    product, rounded to x's dtype once. ``model`` (M, m): model rank m's
    share, column-parallel or ``rows`` row-parallel (the module notes);
    differentiable through the model group's sums."""
    model = share_model(model, "conv_ln_gelu")
    # the statistics run over the model group column-parallel (fc1); u is whole rows (fc2)
    zhat, _ = sample_ln(_project(x, w, b, model, rows), None if rows else model)
    return gelu_as(zhat * scale.float() + bias2.float()).to(x.dtype)


def conv_ln_gelu_backward_plain(x, w, b, scale, bias2, g, model=None, rows=False):
    """Plain backward of kernel #11 (mirrors ``_bwd_kernel``): recompute u;
    da = g gelu'(a); ds = sum da zhat and dt = sum da over the samples;
    du = (dz - mean dz - zhat mean(dz zhat)) rstd with dz = da scale; dW =
    x^T du, db = sum du and dx = du W^T on f32 operands. Returns (dx, dw,
    db, dscale, dbias2): dx in x's dtype, dw in w's dtype, the rest f32.
    Under ``model`` the means run over the model group (column-parallel)
    or u is the reduced product (``rows``); dx is the rank's partial sum
    (column-parallel) or its share (``rows``), dw its share, db, dscale
    and dbias2 its share (column-parallel) or the whole (``rows``)."""
    model = share_model(model, "conv_ln_gelu")
    stats = None if rows else model        # the model group the statistics run over
    sc = scale.float()
    zhat, rstd = sample_ln(_project(x, w, b, model, rows), stats)
    da = g.float() * gelu_as_grad(zhat * sc + bias2.float())
    dz = da * sc
    du = (dz - sample_mean(dz, stats) - zhat * sample_mean(dz * zhat, stats)) * rstd
    du2 = du.reshape(-1, du.shape[-1])
    dw = torch.matmul(x.float().reshape(-1, x.shape[-1]).t(), du2)
    dx = torch.matmul(du, w.float().t())
    return (dx.to(x.dtype), dw.to(w.dtype), du2.sum(0), (da * zhat).sum(0),
            da.sum(0))


def _forward(x, w, b, scale, bias2, model=None, rows=False):
    """The forward for either device: (out, kept), kept what the backward
    takes besides the operands: a rows call's (u, stats) on the card under
    ``model``, else ()."""
    if x.device.type == "cpu":
        return conv_ln_gelu_plain(x, w, b, scale, bias2, model, rows), ()
    model = share_model(model, "conv_ln_gelu")
    if model is None:
        return _forward_kernel(x, w, b, scale, bias2), ()
    if not rows:
        return run_split([split_forward(x, w, b, scale, bias2, model)], model_exchange)[0], ()
    out, *kept = run_split([rows_forward(x, w, b, scale, bias2, model)], model_exchange)[0]
    return out, tuple(kept)


class _ConvLnGelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, scale, bias2, model, rows):
        ctx.model, ctx.rows = model, rows
        out, kept = _forward(x, w, b, scale, bias2, model, rows)
        ctx.save_for_backward(x, w, b, scale, bias2, *kept)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, b, scale, bias2, *kept = ctx.saved_tensors
        grads = conv_ln_gelu_backward(x, w, b, scale, bias2, g.contiguous(), ctx.model,
                                      ctx.rows, kept or None)
        return tuple(d.to(r.dtype) for d, r in zip(grads, (x, w, b, scale, bias2))) + (None,
                                                                                     None)


def conv_ln_gelu(x, w, b, scale, bias2, model=None, rows=False) -> torch.Tensor:
    """gelu(LN_sample(x @ w + b) * scale + bias2) over x (N, HW, Cin); see
    the module docstring. ``model`` (M, m): model rank m's share of a
    column-parallel call, or of a row-parallel one with ``rows``, the call
    a collective of the model group (the module notes). Differentiable in
    every tensor."""
    if x.device.type != "cpu" and not x.is_cuda:
        raise ValueError(f"conv_ln_gelu: unsupported device {x.device}")
    if needs_grad(x, w, b, scale, bias2):
        return _ConvLnGelu.apply(x, w, b, scale, bias2, model, rows)
    return _forward(x, w, b, scale, bias2, model, rows)[0]


conv_ln_gelu.launches = 0
conv_ln_gelu.bwd_launches = 0
conv_ln_gelu.launches_by_route = dict.fromkeys(ROUTES + TP_ROUTES, 0)
conv_ln_gelu.bwd_launches_by_route = dict.fromkeys(ROUTES + TP_ROUTES, 0)


def conv_ln_gelu_backward(x, w, b, scale, bias2, g, model=None, rows=False, kept=None):
    """The backward on its own (what the autograd Function calls): kernel
    #12 for CUDA tensors (counted in ``conv_ln_gelu.bwd_launches``),
    :func:`conv_ln_gelu_backward_plain` for CPU tensors. Returns the tuple
    that function documents. Under ``model`` on the card a rows call takes
    ``kept``, the forward's (u, stats)."""
    if x.device.type == "cpu":
        return conv_ln_gelu_backward_plain(x, w, b, scale, bias2, g, model, rows)
    model = share_model(model, "conv_ln_gelu")
    if model is None:
        return _backward_kernel(x, w, b, scale, bias2, g)
    if not rows:
        return run_split([split_backward(x, w, b, scale, bias2, g, model)], model_exchange)[0]
    if kept is None:
        raise ValueError("conv_ln_gelu: a row-parallel backward on the card takes its "
                         "forward's (u, stats) (rows_forward)")
    return rows_backward(x, w, b, scale, bias2, g, *kept)


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


def tiled_ok(hw: int, cin: int, cout: int) -> bool:
    """Whether the tiled route takes samples of (HW, Cin) -> Cout, in
    either dtype (``cln_tiled_ok``): HW a multiple of 16 up to 4096, Cin
    and Cout multiples of 16."""
    return (16 <= hw <= TILED_MAX_HW and not hw % 16 and cin >= 16 and not cin % 16
            and cout >= 16 and not cout % 16)


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
    _build.dtype_code(_DTYPES, x.dtype, "conv_ln_gelu (#11/#12)")
    if x.dim() != 3:
        raise ValueError(f"conv_ln_gelu kernel takes x (N, HW, Cin), got {tuple(x.shape)}")
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


# ---- the tiled route as steps (tensor parallelism)

def _check_split(what, x, w, model=None):
    """A split or rows call's shape against the tiled steps' limits; a
    shape they do not take raises, naming them."""
    _build.dtype_code(_DTYPES, x.dtype, "conv_ln_gelu (#11/#12)")
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"{what} takes x (N, HW, Cin) and w (Cin, Cout), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, hw, cin = x.shape
    cout = w.shape[1]
    if not tiled_ok(hw, cin, cout) or n > TILED_MAX_N:
        raise ValueError(
            f"{what}{'' if model is None else f' on model rank {model[1]} of {model[0]}'} "
            f"runs the tiled route's steps, which take HW a multiple of 16 up to "
            f"{TILED_MAX_HW}, a rank's Cin and Cout multiples of 16 and N <= {TILED_MAX_N}: "
            f"got N={n} HW={hw} Cin={cin} Cout={cout}")


def _steps(lib, step, dt, x, w, b, scale, bias2, out, u, part, stats, parts, m, n, hw, cin,
           cout, stream):
    p = _build.ptr
    err = lib.vptr_conv_ln_gelu_tiled_step(step, p(x), p(w), p(b), p(scale), p(bias2), p(out),
                                           p(u), p(part), p(stats), p(parts), m, n, hw, cin,
                                           cout, _DTYPES[dt], stream)
    _build.check(lib, err, f"conv_ln_gelu (tiled step {step})")


def _merge(lib, part, out, cnt, mode, stream):
    """Partials ``part`` (N, T, 2) of ``cnt`` values each, in the whole
    call's order, merged into ``out`` (N, 2): mode 0 moments into (mean,
    rstd), 1 sums into their means."""
    part = part.contiguous()
    err = lib.vptr_conv_ln_gelu_tiled_merge(_build.ptr(part), _build.ptr(out), part.shape[0],
                                            part.shape[1], float(cnt), LN_EPS, mode,
                                            torch.cuda.current_stream(part.device).cuda_stream)
    _build.check(lib, err, "conv_ln_gelu tiled merge")


def _row_partials(parts):
    """Every rank's per-row partials (M, N, HW, 2), stacked in rank order,
    as the whole call's (N, HW M, 2): a row's partials rank by rank."""
    m, n, hw, _ = parts.shape
    return parts.permute(1, 2, 0, 3).reshape(n, hw * m, 2)


def split_forward(x, w, b, scale, bias2, model):
    """Kernel #11's tiled route on model rank m's share of the Cout
    channels (``model`` = (M, m); fc1 column-parallel: w, b, scale, bias2
    the share's), as a generator of its exchange: it yields each row's
    partial moments (N, HW, 2) over the share and takes back every rank's
    stacked in rank order (M, N, HW, 2); returns the share's output
    (``ops/_split.py::run_split`` drives it). At M 1 it is the whole tiled
    call. Counted in ``conv_ln_gelu.launches`` when it completes."""
    _check_split("conv_ln_gelu", x, w, model)
    n, hw, cin, cout, _ = _operands(x, w, b, scale, bias2)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty(n, hw, cout, dtype=x.dtype, device=x.device)
    u, part, stats = _tiled_scratch(n, hw, cout, x.device)
    ops = (x, w, b, scale, bias2, out, u, part, stats[0], None, 1, n, hw, cin, cout, stream)
    for step in range(3):
        _steps(lib, step, x.dtype, *ops)
        if step == 1:
            _merge(lib, _row_partials((yield part)), stats[0], cout, 0, stream)
    conv_ln_gelu.launches += 1
    conv_ln_gelu.launches_by_route["tiled_split"] += 1
    return out


def _bwd_steps(lib, a, steps, stream):
    for step in steps:
        err = lib.vptr_conv_ln_gelu_bwd_tiled_step(step, ctypes.byref(a), stream)
        _build.check(lib, err, f"conv_ln_gelu backward (tiled step {step})")


def split_backward(x, w, b, scale, bias2, g, model):
    """Kernel #12's tiled route on model rank m's share, as
    :func:`split_forward`: two exchanges (the recomputed u's per-row
    moments, then LN's per-row backward sums); returns the share's (dx,
    dw, db, dscale, dbias2), dx the rank's partial sum over its channels.
    Counted in ``conv_ln_gelu.bwd_launches`` when it completes."""
    _check_split("conv_ln_gelu backward", x, w, model)
    n, hw, cout = x.shape[0], x.shape[1], w.shape[1]
    u, tpart, tstats = _tiled_scratch(n, hw, cout, x.device)
    a, grads, scratch = _bwd_args(x, w, b, scale, bias2, g, n, tiled=(u, tpart, tstats))
    lib, fwd = _lib_bwd(), _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _bwd_steps(lib, a, (0, 1), stream)                 # u and its moments
    _merge(fwd, _row_partials((yield tpart)), tstats[0], cout, 0, stream)
    _bwd_steps(lib, a, (2,), stream)                   # LN's backward sums
    _merge(fwd, _row_partials((yield tpart)), tstats[1], cout, 1, stream)
    _bwd_steps(lib, a, (3, 4), stream)
    conv_ln_gelu.bwd_launches += 1
    conv_ln_gelu.bwd_launches_by_route["tiled_split"] += 1
    return grads


def rows_forward(x, w, b, scale, bias2, model):
    """Kernel #11's tiled route on model rank m's share of the Cin channels
    (``model`` = (M, m); fc2 row-parallel: x and w the share's, b, scale,
    bias2 whole), as a generator of its exchange: it yields the partial
    product x w (N HW, Cout) f32 and takes back every rank's stacked in
    rank order (M, N HW, Cout), which the moments step sums in rank order
    into u; the rest is the whole tiled call's, the same bits on every
    rank. Returns (out, u, stats): u (N HW, Cout) and the (mean, rstd) (N,
    2) that :func:`rows_backward` takes. Counted in ``conv_ln_gelu.launches``
    when it completes."""
    _check_split("conv_ln_gelu", x, w, model)
    n, hw, cin, cout, _ = _operands(x, w, b, scale, bias2)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty(n, hw, cout, dtype=x.dtype, device=x.device)
    u, part, stats = _tiled_scratch(n, hw, cout, x.device)
    upart = torch.empty_like(u)
    _steps(lib, 0, x.dtype, x, w, b, scale, bias2, out, upart, part, None, None, 1, n, hw,
           cin, cout, stream)
    parts = (yield upart).contiguous()
    del upart
    _steps(lib, 1, x.dtype, x, w, b, scale, bias2, out, u, part, None, parts, parts.shape[0],
           n, hw, cin, cout, stream)
    del parts
    _merge(lib, part, stats[0], cout, 0, stream)
    _steps(lib, 2, x.dtype, x, w, b, scale, bias2, out, u, part, stats[0], None, 1, n, hw, cin,
           cout, stream)
    conv_ln_gelu.launches += 1
    conv_ln_gelu.launches_by_route["tiled_rows"] += 1
    return out, u, stats[0]


def rows_backward(x, w, b, scale, bias2, g, u, stats):
    """Kernel #12's tiled route on model rank m's share of the Cin channels
    (fc2 row-parallel), from the forward's u and (mean, rstd)
    (:func:`rows_forward`): no exchange, LN's backward over the whole u on
    every rank. Returns (dx, dw, db, dscale, dbias2): dx and dw the rank's
    share, db, dscale, dbias2 the whole (the same bits on every rank: they
    are replicated parameters' gradients, not to be summed over the
    group). Counted in ``conv_ln_gelu.bwd_launches``."""
    n, hw, cout = x.shape[0], x.shape[1], w.shape[1]
    _check_split("conv_ln_gelu rows backward", x, w)
    if (u.shape != (n * hw, cout) or stats.shape != (n, 2) or u.dtype != torch.float32
            or not u.is_contiguous()):
        raise ValueError(f"conv_ln_gelu rows backward takes the forward's u ({n * hw}, {cout}) "
                         f"and stats ({n}, 2) f32, got {tuple(u.shape)}, {tuple(stats.shape)}")
    f32 = dict(dtype=torch.float32, device=x.device)
    tpart, tstats = torch.empty(n, hw, 2, **f32), torch.empty(2, n, 2, **f32)
    tstats[0].copy_(stats)
    a, grads, scratch = _bwd_args(x, w, b, scale, bias2, g, n, tiled=(u, tpart, tstats))
    lib = _lib_bwd()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _bwd_steps(lib, a, (2,), stream)
    _merge(_lib(), tpart, tstats[1], cout, 1, stream)
    _bwd_steps(lib, a, (3, 4), stream)
    conv_ln_gelu.bwd_launches += 1
    conv_ln_gelu.bwd_launches_by_route["tiled_rows"] += 1
    return grads


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


def _bwd_args(x, w, b, scale, bias2, g, groups, wt=None, tiled=None):
    """Kernel #12's _BwdArgs, gradients and scratch for ``groups`` sample
    groups of pass 1's partials; ``wt`` W^T (the cluster route in bf16),
    ``tiled`` the tiled route's (u, tpart, tstats). The args hold raw
    pointers: the caller keeps the scratch until its launches are
    enqueued."""
    n, hw, cin, cout, _ = _operands(x, w, b, scale, bias2)
    if g.shape != (n, hw, cout) or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"conv_ln_gelu backward: g {tuple(g.shape)} {g.dtype} "
                         f"does not match the output {(n, hw, cout)} {x.dtype}")
    dt, dev, f32 = x.dtype, x.device, torch.float32
    lib = _lib_bwd()
    rows = n * hw
    ksplit = lib.vptr_conv_ln_gelu_bwd_ksplit(rows)

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
                   wpart=buf(ksplit, cin, cout),
                   partial=buf(lib.vptr_conv_ln_gelu_bwd_partials(hw), cout))
    if tiled is not None:
        scratch.update(zip(("u", "tpart", "tstats"), tiled))
    p = _build.ptr
    a = _BwdArgs(x=p(x), w=p(w), wt=p(wt), b=p(b), scale=p(scale), bias2=p(bias2), g=p(g),
                 **{k: p(v) for k, v in grads.items()},
                 **{k: p(v) for k, v in scratch.items()},
                 N=n, HW=hw, Cin=cin, Cout=cout, dtype=_DTYPES[dt], groups=groups,
                 ksplit=ksplit, eps=LN_EPS)
    return a, tuple(grads[k] for k in ("dx", "dw", "db", "ds", "dt")), scratch


def _backward_kernel(x, w, b, scale, bias2, g):
    n, hw, cin, cout, route = _operands(x, w, b, scale, bias2)
    dt, dev = x.dtype, x.device
    lib = _lib_bwd()
    # the cluster route in bf16: W^T (Cout, Cin) too, K-major for the
    # recomputed product on wgmma; the tiled route: u and the statistics
    wt = w.t().contiguous() if dt == torch.bfloat16 and route == "cluster" else None
    tiled = _tiled_scratch(n, hw, cout, dev) if route == "tiled" else None
    a, grads, scratch = _bwd_args(x, w, b, scale, bias2, g,
                                  lib.vptr_conv_ln_gelu_bwd_groups(n, hw, cout, _DTYPES[dt]),
                                  wt, tiled)
    err = lib.vptr_conv_ln_gelu_bwd(ctypes.byref(a),
                                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"conv_ln_gelu backward ({route})")
    conv_ln_gelu.bwd_launches += 1
    conv_ln_gelu.bwd_launches_by_route[route] += 1
    return grads


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
        lib.vptr_conv_ln_gelu_tiled_step.argtypes = [i] + [p] * 10 + [i] * 6 + [p]
        lib.vptr_conv_ln_gelu_tiled_step.restype = ctypes.c_int
        lib.vptr_conv_ln_gelu_tiled_merge.argtypes = [p, p, i, i, f, f, i, p]
        lib.vptr_conv_ln_gelu_tiled_merge.restype = ctypes.c_int
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
        lib.vptr_conv_ln_gelu_bwd_tiled_step.argtypes = [ctypes.c_int, ctypes.POINTER(_BwdArgs),
                                                         ctypes.c_void_p]
        lib.vptr_conv_ln_gelu_bwd_tiled_step.restype = ctypes.c_int
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
