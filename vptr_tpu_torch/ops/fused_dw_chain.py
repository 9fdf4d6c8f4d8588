"""The conv feed-forward's middle chain between its two 1x1 products:
norm1 -> GELU -> depthwise 3x3 -> norm2 -> GELU -> dropout, per sample.

Counterpart of ``vptr_tpu/ops/fused_dw_chain.py``, whose two TPU kernels are
joined by ``jax.custom_vjp``. Over x (N, HW, C), channels last, row r the
position (r // w, r % w) of an (HW / w, w) grid:

    z1 = gelu(LN(x) * s1 + b1)         whole-sample LayerNorm over (HW, C)
    z2 = dw3x3(z1) + dwb               per channel, zero padding
    z3 = dropout(gelu(LN(z2) * s2 + b2))

with f32 arithmetic, the A&S GELU (``ops/gelu.py``), taps (9, C) row-major
in (dy, dx) (cross-correlation), dwb (C,) and the (HW, C) affines f32.

* ``_forward`` (``pl.pallas_call`` at :294) -> ``csrc/fused_dw_chain.cu``
  (kernel #9); ``_backward`` (:318) -> ``csrc/fused_dw_chain_bwd.cu`` (#10);
  both share ``csrc/dw_chain.cuh``, on their bf16 routes
  ``csrc/dw_persistent.cuh`` and on their tiled routes ``csrc/dw_tiled.cuh``,
  whose notes say what bounds them and what the design does about that.
  Each has three routes, named from the shape and dtype before the launch:
  #9's by :func:`kernel_route` (bf16 takes persistent 16-block clusters
  with the affines and taps held in shared memory for the whole launch; f32
  and the shapes that route refuses a cluster of 8 blocks a sample; the
  samples too large for that, nar_kth_128's 16 x 16 x 2112, the tiled
  route's passes through device memory), #10's by :func:`backward_route`
  (bf16 takes persistent 16-block clusters that keep the affine-gradient
  and tap sums in shared memory across their samples; f32 and the shapes
  that route refuses clusters of 8 blocks over at most 16 groups of
  samples; the samples too large for that the tiled route).
* :func:`fused_dw_chain` is a ``torch.autograd.Function``: a CUDA tensor
  launches the kernels (or raises), a CPU tensor takes
  :func:`fused_dw_chain_plain` forward and
  :func:`fused_dw_chain_backward_plain` backward. Only the inputs are saved
  for the backward, as in the JAX ``custom_vjp``.
* ``fused_dw_chain.launches`` / ``.bwd_launches`` count launches of #9 /
  #10 and nothing else (``.launches_by_route`` / ``.bwd_launches_by_route``
  the same by route).
* The dropout is the counter hash of ``ops/dropout.py`` with element index
  (sample * HW + r) * C + col.
* Tensor parallelism (``model`` = (M, m)): x holds model rank m's share of
  Cg = M C channels, c0 = m C .. c0 + C - 1, and both LayerNorms run over
  the whole sample, every share's channels. On the card the call takes
  the tiled route split at its statistics (:func:`split_forward`,
  :func:`split_backward`): each pass writes the share's per-tile partials,
  every rank's are gathered over the model group
  (:func:`~vptr_tpu_torch.ops._split.run_split`) and merged in
  the whole call's tile order, so a rank's output is its slice of the
  whole tiled call's bits where the share is whole 32-channel tiles (C a
  multiple of 32). A share of 32 k + r channels (far_mnist's 2112 over
  mesh.model 4: 528) ends each grid row in a partial tile of r channels,
  whose masked lanes touch no memory; its partials count W r values and
  the merge weighs every tile by its count, so the statistics differ from
  the whole call's by rounding (:func:`split_ok` says which shares the
  route takes). The plain versions take the sample's sums over the model
  group (:func:`~vptr_tpu_torch.parallel.mesh.model_sum`). The dropout
  indexes by the global channel, (sample * HW + r) * Cg + c0 + col; the
  taps', dwb's and the affines' gradients are the share's.
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
from vptr_tpu_torch.ops.attention_core import _dropout_args, needs_grad, seed_tensor
from vptr_tpu_torch.ops.dropout import Seed, apply_dropout, dw_keep_mask
from vptr_tpu_torch.ops.gelu import gelu_as, gelu_as_grad

LN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("per_sample", "persistent", "tiled")   # #9's routes, as the library numbers them
BWD_ROUTES = ("groups", "persistent", "tiled")   # #10's routes, as its library numbers them


def _dw3x3(z, taps, dwb, w: int):
    """Depthwise 3x3 with zero padding over z (N, HW, C) f32 on the
    (HW / w, w) grid: dwb, then the taps in row-major (dy, dx) order."""
    n, hw, c = z.shape
    zp = torch.nn.functional.pad(z.reshape(n, hw // w, w, c), (0, 0, 1, 1, 1, 1))
    acc = dwb.float().expand(n, hw // w, w, c)
    for t in range(9):
        dy, dx = divmod(t, 3)
        acc = acc + zp[:, dy:dy + hw // w, dx:dx + w] * taps[t].float()
    return acc.reshape(n, hw, c)


def _dw3x3_t(dz, taps, w: int):
    """Transpose of :func:`_dw3x3` in z (its gradient w.r.t. the input)."""
    n, hw, c = dz.shape
    h = hw // w
    dp = torch.nn.functional.pad(dz.reshape(n, h, w, c), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(n, h, w, c, dtype=torch.float32, device=dz.device)
    for t in range(9):
        dy, dx = divmod(t, 3)
        acc = acc + dp[:, 2 - dy:2 - dy + h, 2 - dx:2 - dx + w] * taps[t].float()
    return acc.reshape(n, hw, c)


def _keep(seed, x, rate, model=None):
    n, hw, c = x.shape
    cols = {} if model is None else dict(mask_cols=c * model[0], col0=c * model[1])
    return dw_keep_mask(seed, n, hw, c, rate, x.device, **cols) if rate > 0.0 else None


def _chain(x, taps, dwb, s1, b1, s2, b2, w, model=None):
    """The forward in f32 before the dropout; returns (z3, xhat1, rstd1,
    a1, z1, xhat2, rstd2, a2)."""
    xhat1, rstd1 = sample_ln(x.float(), model)
    a1 = xhat1 * s1.float() + b1.float()
    z1 = gelu_as(a1)
    z2 = _dw3x3(z1, taps, dwb, w)
    xhat2, rstd2 = sample_ln(z2, model)
    a2 = xhat2 * s2.float() + b2.float()
    return gelu_as(a2), xhat1, rstd1, a1, z1, xhat2, rstd2, a2


def fused_dw_chain_plain(x, taps, dwb, s1, b1, s2, b2, seed: Seed = 0, w: int = 8,
                         rate: float = 0.0, model=None) -> torch.Tensor:
    """Plain PyTorch version of kernel #9 (``_reference_dw_chain``): all f32,
    rounded to x's dtype once. ``model`` (M, m): x is model rank m's share
    of the channels (the module notes)."""
    model = share_model(model, "fused_dw_chain")
    z3 = _chain(x, taps, dwb, s1, b1, s2, b2, w, model)[0]
    return apply_dropout(z3, _keep(seed, x, rate, model), rate).to(x.dtype)


def fused_dw_chain_backward_plain(x, taps, dwb, s1, b1, s2, b2, seed, g, w: int = 8,
                                  rate: float = 0.0, model=None):
    """Plain backward of kernel #9 (mirrors ``_bwd_kernel``). Returns (dx,
    dtaps, ddwb, ds1, db1, ds2, db2): dx in x's dtype, the rest f32 summed
    over the samples (under ``model`` the share's)."""
    model = share_model(model, "fused_dw_chain")
    _, xhat1, rstd1, a1, z1, xhat2, rstd2, a2 = _chain(x, taps, dwb, s1, b1,
                                                       s2, b2, w, model)
    gs = apply_dropout(g.float(), _keep(seed, x, rate, model), rate)
    da2 = gs * gelu_as_grad(a2)
    dxh2 = da2 * s2.float()

    def ln_back(dxh, xhat, rstd):
        return (dxh - sample_mean(dxh, model)
                - xhat * sample_mean(dxh * xhat, model)) * rstd

    dz2 = ln_back(dxh2, xhat2, rstd2)
    n, hw, c = x.shape
    zp = torch.nn.functional.pad(z1.reshape(n, hw // w, w, c), (0, 0, 1, 1, 1, 1))
    d4 = dz2.reshape(n, hw // w, w, c)
    dtaps = torch.stack([(zp[:, dy:dy + hw // w, dx:dx + w] * d4).sum((0, 1, 2))
                         for dy, dx in (divmod(t, 3) for t in range(9))])
    da1 = _dw3x3_t(dz2, taps, w) * gelu_as_grad(a1)
    dx = ln_back(da1 * s1.float(), xhat1, rstd1)
    return (dx.to(x.dtype), dtaps, dz2.sum((0, 1)), (da1 * xhat1).sum(0),
            da1.sum(0), (da2 * xhat2).sum(0), da2.sum(0))


def _forward(x, taps, dwb, s1, b1, s2, b2, seed, w, rate, model=None):
    """The forward for either device; ``seed`` a tensor or None (rate 0)."""
    if x.device.type == "cpu":
        return fused_dw_chain_plain(x, taps, dwb, s1, b1, s2, b2, seed, w, rate, model)
    if share_model(model, "fused_dw_chain") is not None:
        return run_split([split_forward(x, taps, dwb, s1, b1, s2, b2, seed, w, rate, model)],
                         model_exchange)[0]
    return _forward_kernel(x, taps, dwb, s1, b1, s2, b2, seed, w, rate)


class _FusedDwChain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, taps, dwb, s1, b1, s2, b2, seed, w, rate, model):
        ctx.save_for_backward(x, taps, dwb, s1, b1, s2, b2, seed)
        ctx.w, ctx.rate, ctx.model = w, rate, model
        return _forward(x, taps, dwb, s1, b1, s2, b2, seed, w, rate, model)

    @staticmethod
    def backward(ctx, g):
        x, taps, dwb, s1, b1, s2, b2, seed = ctx.saved_tensors
        grads = fused_dw_chain_backward(x, taps, dwb, s1, b1, s2, b2, seed,
                                        g.contiguous(), ctx.w, ctx.rate, ctx.model)
        refs = (x, taps, dwb, s1, b1, s2, b2)
        return tuple(d.to(r.dtype) for d, r in zip(grads, refs)) + (None,) * 4


def fused_dw_chain(x, taps, dwb, s1, b1, s2, b2, seed: Seed = 0, w: int = 8,
                   rate: float = 0.0, model=None) -> torch.Tensor:
    """norm1 -> GELU -> dw3x3 -> norm2 -> GELU -> dropout over x (N, HW, C)
    on the (HW / w, w) grid; see the module docstring. The caller runs fc1
    before and fc2 (+ norm3, GELU, dropout) after. ``model`` (M, m): x is
    model rank m's share of the channels, the call a collective of the
    model group (the module notes). Differentiable in every tensor but the
    seed."""
    if x.device.type != "cpu" and not x.is_cuda:
        raise ValueError(f"fused_dw_chain: unsupported device {x.device}")
    rate = float(rate)
    seed = seed_tensor(seed, x.device) if rate > 0.0 else None
    if needs_grad(x, taps, dwb, s1, b1, s2, b2):
        return _FusedDwChain.apply(x, taps, dwb, s1, b1, s2, b2, seed, w, rate, model)
    return _forward(x, taps, dwb, s1, b1, s2, b2, seed, w, rate, model)


fused_dw_chain.launches = 0
fused_dw_chain.bwd_launches = 0
fused_dw_chain.launches_by_route = dict.fromkeys(ROUTES + ("tiled_split",), 0)
fused_dw_chain.bwd_launches_by_route = dict.fromkeys(BWD_ROUTES + ("tiled_split",), 0)


def fused_dw_chain_backward(x, taps, dwb, s1, b1, s2, b2, seed, g, w: int = 8,
                            rate: float = 0.0, model=None):
    """The backward on its own (what the autograd Function calls): kernel
    #10 for CUDA tensors (counted in ``fused_dw_chain.bwd_launches``),
    :func:`fused_dw_chain_backward_plain` for CPU tensors. Returns the tuple
    that function documents."""
    if x.device.type == "cpu":
        return fused_dw_chain_backward_plain(x, taps, dwb, s1, b1, s2, b2, seed,
                                             g, w, rate, model)
    if rate > 0.0:
        seed = seed_tensor(seed, x.device)
    if share_model(model, "fused_dw_chain") is not None:
        return run_split([split_backward(x, taps, dwb, s1, b1, s2, b2, seed, g, w, rate,
                                         model)], model_exchange)[0]
    return _backward_kernel(x, taps, dwb, s1, b1, s2, b2, seed, g, w, rate)


SMEM_LIMIT = 231000   # bytes of dynamic shared memory a block may take here


def per_sample_smem(hw: int, c: int) -> int:
    """Dynamic shared memory of #9's per-sample block for samples of (HW,
    C) (``dw_smem``: two f32 slices of C / 8 channels)."""
    return 4 * 2 * hw * (c // 8)


def groups_smem(hw: int, c: int) -> int:
    """Dynamic shared memory of #10's group block for samples of (HW, C)
    (``bwd_smem``: three f32 slices of C / 8 channels and their ten tap
    sums)."""
    return 4 * 3 * hw * (c // 8) + 4 * 10 * (c // 8)


# The tiled routes (csrc/dw_tiled.cuh: kTCh, kTMaxW, kTMaxN)
T_CH, T_MAX_W, T_MAX_N = 32, 32, 65535


def tiled_ok(hw: int, c: int, w: int) -> bool:
    """Whether the tiled routes of #9 and #10 take samples of (HW, C) on a
    grid w wide, in either dtype: w at most 32 dividing HW, C a multiple
    of 32 (and at most 65,535 samples a call)."""
    return hw >= 1 and 1 <= w <= T_MAX_W and hw % w == 0 and c >= T_CH and c % T_CH == 0


# The persistent route of #9 (csrc/fused_dw_chain.cu: kPCluster, kPThreads,
# kPMaxQ, kPSmemLimit)
P_CLUSTER, P_THREADS, P_MAX_QUADS = 16, 512, 5
P_SMEM_LIMIT = 232448 - 1024 - 2048


def persistent_smem(hw: int, c: int) -> int:
    """Dynamic shared memory of a persistent block for samples of (HW, C)
    (``p_smem``): 128 bytes of alignment, the staged bf16 x (HW rows of the
    slice's cw channels and, where cw is 4 mod 8, 4 more), the four
    affines, z1 and z2 in f32, taps and dwb."""
    cw = c // P_CLUSTER
    e = hw * cw
    return 128 + 2 * hw * (cw + cw % 8) + 4 * (6 * e + 10 * cw)


def kernel_route(hw: int, c: int, dtype: torch.dtype, w: int = 8) -> str:
    """Which route kernel #9 takes for samples of (HW, C) on a grid w wide,
    in ``dtype``: ``"persistent"`` (bf16: as many 16-block clusters as the
    card holds, each walking the samples, a block's 1/16 channel slice of
    the affines and taps in shared memory for the whole launch),
    ``"tiled"`` (either dtype: the samples whose per-sample block would
    need more than ``SMEM_LIMIT`` bytes, in passes through device memory
    with per-tile partial moments; :func:`tiled_ok` says which it takes)
    or ``"per_sample"`` (f32 and every other shape: a cluster of 8 blocks a
    sample, which still refuses a shape whose slice does not fit). The
    persistent route takes HW <= 256, C a multiple of 64 whose slice,
    staged from a 16-byte boundary, is at most 256 channels, and the slice
    within shared memory. A pure function of the shapes, equal to the
    library's ``vptr_fused_dw_chain_route``."""
    if dtype == torch.bfloat16 and 1 <= hw <= 256 and w >= 1 and not hw % w \
            and c >= 4 * P_CLUSTER and not c % (4 * P_CLUSTER):
        cw = c // P_CLUSTER
        if (cw + cw % 8 <= 256 and persistent_smem(hw, c) <= P_SMEM_LIMIT
                and hw * (cw // 4) <= P_MAX_QUADS * P_THREADS):
            return "persistent"
    if per_sample_smem(hw, c) > SMEM_LIMIT and tiled_ok(hw, c, w):
        return "tiled"
    return "per_sample"


# #10's persistent route (csrc/fused_dw_chain_bwd.cu: kBSmemLimit, the
# opt-in maximum less the statistics' 936 bytes of static shared memory and
# 64 for the probe stamps' sums)
B_SMEM_LIMIT = 232448 - 936 - 64


def backward_smem(hw: int, c: int) -> int:
    """Dynamic shared memory of a persistent backward block for samples of
    (HW, C) (``b_smem``): 128 bytes of alignment, the bf16 stage (x or g)
    rounded up to 128 bytes, z2, the four affine-gradient sums and z1 in
    f32, taps and dwb, and the tap and bias gradients' sums."""
    cw = c // P_CLUSTER
    e = hw * cw
    return 128 + -(-2 * hw * (cw + cw % 8) // 128) * 128 + 4 * (6 * e + 20 * cw)


def backward_route(hw: int, c: int, dtype: torch.dtype, w: int = 8) -> str:
    """Which route kernel #10 takes for samples of (HW, C) on a grid w wide,
    in ``dtype``: ``"persistent"`` (bf16: as many 16-block clusters as the
    card holds, each walking the samples and keeping its blocks' 1/16
    channel slices of the affine-gradient and tap sums in shared memory),
    ``"tiled"`` (either dtype: the samples whose group block would need
    more than ``SMEM_LIMIT`` bytes, in passes through device memory with
    per-tile partial moments and sums and the sums over samples in up to 8
    sample groups; :func:`tiled_ok` says which it takes) or ``"groups"``
    (f32 and every other shape: clusters of 8 blocks over at most 16 groups
    of samples, which still refuses a shape whose slices do not fit). The
    persistent route takes HW <= 256, w dividing 32, C a multiple of 64
    whose slice, staged from a 16-byte boundary, is at most 256 channels,
    and the block within shared memory. A pure function of the shapes,
    equal to the library's ``vptr_fused_dw_chain_bwd_route``."""
    if dtype == torch.bfloat16 and 1 <= hw <= 256 and 1 <= w <= 32 and not 32 % w \
            and not hw % w and c >= 4 * P_CLUSTER and not c % (4 * P_CLUSTER):
        cw = c // P_CLUSTER
        if (cw + cw % 8 <= 256 and backward_smem(hw, c) <= B_SMEM_LIMIT
                and hw * (cw // 4) <= P_MAX_QUADS * P_THREADS):
            return "persistent"
    if groups_smem(hw, c) > SMEM_LIMIT and tiled_ok(hw, c, w):
        return "tiled"
    return "groups"


def backward_clusters(hw: int, c: int, w: int = 8) -> int:
    """How many 16-block clusters of #10's persistent route the card holds
    at once for samples of (HW, C) on a grid w wide (0 where the route does
    not take them)."""
    return _lib_bwd().vptr_fused_dw_chain_bwd_persistent_clusters(hw, w, c)


def persistent_clusters(hw: int, c: int, w: int = 8) -> int:
    """How many 16-block clusters of #9's persistent route the card holds
    at once for samples of (HW, C) on a grid w wide (0 where the route does
    not take them)."""
    return _lib().vptr_fused_dw_chain_persistent_clusters(hw, w, c)


def resident_clusters(hw: int, c: int) -> tuple:
    """(forward, backward): how many clusters (a sample each; a group of
    samples in the backward) of the per-sample forward and of the
    backward's group route in bf16 the card holds at once for samples of
    (HW, C)."""
    return (_lib().vptr_fused_dw_chain_clusters(hw, c),
            _lib_bwd().vptr_fused_dw_chain_bwd_clusters(hw, c))


def _operands(x, taps, dwb, s1, b1, s2, b2, w, share=False):
    """Check every operand against what the kernels take (a tensor-parallel
    ``share`` any C); returns (N, HW, C)."""
    _build.dtype_code(_DTYPES, x.dtype, "fused_dw_chain (#9/#10)")
    if x.dim() != 3:
        raise ValueError(f"fused_dw_chain kernel takes x (N, HW, C), got {tuple(x.shape)}")
    n, hw, c = x.shape
    if w < 1 or hw % w:
        raise ValueError(f"fused_dw_chain: HW={hw} is not a multiple of w={w}")
    if c % 32 and not share:
        raise ValueError(f"fused_dw_chain kernel takes C a multiple of 32 (eight "
                         f"blocks of whole channel quads), got C={c}")
    f32 = torch.float32
    for name, t, shape, dtype in (
            ("x", x, (n, hw, c), x.dtype), ("taps", taps, (9, c), f32),
            ("dwb", dwb, (c,), f32), ("s1", s1, (hw, c), f32), ("b1", b1, (hw, c), f32),
            ("s2", s2, (hw, c), f32), ("b2", b2, (hw, c), f32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused_dw_chain: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, wants {shape} {dtype}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"fused_dw_chain: {name} must be contiguous on {x.device}")
    return n, hw, c


def _refuse(what, hw, c, w, smem, x):
    raise ValueError(f"{what}: HW={hw}, w={w}, C={c}, {x.dtype} needs {smem} B of shared "
                     f"memory (> {SMEM_LIMIT}) on the cluster route, and the tiled route "
                     f"takes w <= {T_MAX_W} dividing HW and C a multiple of {T_CH}")


def _check_tiled(what, x, w):
    n, hw, c = x.shape
    if not tiled_ok(hw, c, w) or n > T_MAX_N:
        raise ValueError(f"{what} tiled route: HW={hw}, w={w}, C={c}, N={n} is not a shape "
                         f"it takes (w <= {T_MAX_W} dividing HW, C a multiple of {T_CH}, "
                         f"N <= {T_MAX_N})")


# ---- the tiled route split at its statistics (tensor parallelism)

def split_ok(hw: int, c: int, w: int, n: int = 1) -> bool:
    """Whether the split tiled route (:func:`split_forward`,
    :func:`split_backward`) takes a rank's share of n samples of (HW, C) on
    a grid w wide: w at most 32 dividing HW, any C (its last tile partial
    where 32 does not divide it), at most 65,535 samples. Equal to the
    library's ``t_split_ok``."""
    return hw >= 1 and 1 <= w <= T_MAX_W and hw % w == 0 and c >= 1 and 1 <= n <= T_MAX_N


def _check_split(what, x, w, model):
    _build.dtype_code(_DTYPES, x.dtype, "fused_dw_chain (#9/#10)")
    if x.dim() != 3:
        raise ValueError(f"{what} takes x (N, HW, C), got {tuple(x.shape)}")
    n, hw, c = x.shape
    if not split_ok(hw, c, w, n):
        raise ValueError(
            f"{what} on model rank {model[1]} of {model[0]} runs the tiled route split at its "
            f"statistics, which takes w <= {T_MAX_W} dividing HW and N <= {T_MAX_N}: got "
            f"HW={hw}, w={w}, N={n} (C={c} a rank of {c * model[0]} over "
            f"mesh.model={model[0]})")


def _merge(lib, parts, out, w, c, mode, stream):
    """Every rank's partials ``parts`` (M, N, H, ceil(C / 32), 2) of shares
    of C channels, in rank order, merged into ``out`` (N, 2) in the whole
    call's tile order (a grid row's tiles rank by rank; each tile weighed
    by its count where a share ends in a partial tile): mode 0 moments
    into (mean, rstd), 1 sums into their means."""
    whole = parts.permute(1, 2, 0, 3, 4).contiguous()
    n, tiles = whole.shape[0], whole.shape[1] * whole.shape[2] * whole.shape[3]
    err = lib.vptr_fused_dw_chain_tiled_merge(_build.ptr(whole), _build.ptr(out), n, tiles, w,
                                              c, LN_EPS, mode, stream)
    _build.check(lib, err, "fused_dw_chain tiled merge")


def split_forward(x, taps, dwb, s1, b1, s2, b2, seed, w, rate, model):
    """Kernel #9's tiled route on model rank m's share of the channels
    (``model`` = (M, m); every operand the share's, ``seed`` a tensor or
    None at rate 0), as a generator of its exchanges: it yields each
    statistic's per-tile partials (N, HW / w, ceil(C / 32), 2) and takes
    back every rank's stacked in rank order (M, N, HW / w, ceil(C / 32),
    2); returns the share's output (``ops/_split.py::run_split`` drives
    it). Counted in ``fused_dw_chain.launches`` when it completes."""
    _check_split("fused_dw_chain", x, w, model)
    n, hw, c = _operands(x, taps, dwb, s1, b1, s2, b2, w, share=True)
    lib, p = _lib(), _build.ptr
    stream = torch.cuda.current_stream(x.device).cuda_stream
    f32 = dict(dtype=torch.float32, device=x.device)
    out, z2 = torch.empty_like(x), torch.empty(n, hw, c, **f32)
    part = torch.empty(n, hw // w, -(-c // T_CH), 2, **f32)
    stats = torch.empty(2, n, 2, **f32)
    drop = (*_dropout_args(seed, rate), c * model[0], c * model[1])
    for step in range(3):
        err = lib.vptr_fused_dw_chain_tiled_step(
            step, p(x), p(taps), p(dwb), p(s1), p(b1), p(s2), p(b2), p(out), p(z2), p(part),
            p(stats), n, hw, w, c, *drop, _DTYPES[x.dtype], stream)
        _build.check(lib, err, f"fused_dw_chain (tiled_split, step {step})")
        if step < 2:
            _merge(lib, (yield part), stats[step], w, c, 0, stream)
    fused_dw_chain.launches += 1
    fused_dw_chain.launches_by_route["tiled_split"] += 1
    return out


def split_backward(x, taps, dwb, s1, b1, s2, b2, seed, g, w, rate, model):
    """Kernel #10's tiled route on model rank m's share, as
    :func:`split_forward`: four exchanges (x's and z2's moments, LN2's and
    LN1's backward sums); returns the share's (dx, dtaps, ddwb, ds1, db1,
    ds2, db2). Counted in ``fused_dw_chain.bwd_launches`` when it
    completes."""
    _check_split("fused_dw_chain backward", x, w, model)
    n, hw, c = _operands(x, taps, dwb, s1, b1, s2, b2, w, share=True)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"fused_dw_chain backward: g {tuple(g.shape)} {g.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    lib, fwd_lib, p = _lib_bwd(), _lib(), _build.ptr
    stream = torch.cuda.current_stream(x.device).cuda_stream
    f32 = dict(dtype=torch.float32, device=x.device)
    groups = lib.vptr_fused_dw_chain_bwd_tiled_groups(n)
    dx = torch.empty_like(x)
    dtaps, ddwb = torch.empty(9, c, **f32), torch.empty(c, **f32)
    ds1, db1, ds2, db2 = (torch.empty(hw, c, **f32) for _ in range(4))
    z2, da1 = (torch.empty(n, hw, c, **f32) for _ in range(2))
    part = torch.empty(n, hw // w, -(-c // T_CH), 2, **f32)
    stats = torch.empty(4, n, 2, **f32)
    gpart = torch.empty(groups, 4, hw, c, **f32)
    tpart = torch.empty(groups, hw // w, 10, c, **f32)
    drop = (*_dropout_args(seed, rate), c * model[0], c * model[1])
    for step in range(5):
        err = lib.vptr_fused_dw_chain_bwd_tiled_step(
            step, p(x), p(taps), p(dwb), p(s1), p(b1), p(s2), p(b2), p(g), p(dx), p(dtaps),
            p(ddwb), p(ds1), p(db1), p(ds2), p(db2), p(z2), p(da1), p(part), p(stats),
            p(gpart), p(tpart), n, hw, w, c, *drop, _DTYPES[x.dtype], stream)
        _build.check(lib, err, f"fused_dw_chain backward (tiled_split, step {step})")
        if step < 4:
            _merge(fwd_lib, (yield part), stats[step], w, c, 0 if step < 2 else 1, stream)
    fused_dw_chain.bwd_launches += 1
    fused_dw_chain.bwd_launches_by_route["tiled_split"] += 1
    return dx, dtaps, ddwb, ds1, db1, ds2, db2


def _forward_kernel(x, taps, dwb, s1, b1, s2, b2, seed, w, rate, route=None):
    """Kernel #9 on ``route`` (default: :func:`kernel_route`'s); a shape the
    route does not take raises."""
    n, hw, c = _operands(x, taps, dwb, s1, b1, s2, b2, w)
    lib = _lib()
    route = route or kernel_route(hw, c, x.dtype, w)
    out = torch.empty_like(x)
    p = _build.ptr
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "tiled":
        _check_tiled("fused_dw_chain", x, w)
        f32 = dict(dtype=torch.float32, device=x.device)
        z2 = torch.empty(n, hw, c, **f32)
        part = torch.empty(n, (hw // w) * (c // T_CH), 2, **f32)
        stats = torch.empty(2, n, 2, **f32)
        err = lib.vptr_fused_dw_chain_tiled(
            p(x), p(taps), p(dwb), p(s1), p(b1), p(s2), p(b2), p(out), p(z2), p(part),
            p(stats), n, hw, w, c, LN_EPS, *_dropout_args(seed, rate), _DTYPES[x.dtype], stream)
    else:
        if route == "persistent":
            if kernel_route(hw, c, x.dtype, w) != "persistent":
                raise ValueError(f"fused_dw_chain persistent route: HW={hw}, w={w}, C={c}, "
                                 f"{x.dtype} is not a shape it takes")
            if any(t.data_ptr() % 16 for t in (x, taps, dwb, s1, b1, s2, b2)):
                raise ValueError("fused_dw_chain persistent route: every operand must be "
                                 "16-byte aligned (the slices are copied in 16-byte pieces)")
        elif route == "per_sample":
            smem = lib.vptr_fused_dw_chain_smem(hw, c)
            if smem > SMEM_LIMIT:
                _refuse("fused_dw_chain kernel", hw, c, w, smem, x)
        else:
            raise ValueError(f"fused_dw_chain: unknown route {route!r}")
        err = lib.vptr_fused_dw_chain(
            p(x), p(taps), p(dwb), p(s1), p(b1), p(s2), p(b2), p(out), n, hw, w, c,
            LN_EPS, *_dropout_args(seed, rate), _DTYPES[x.dtype], ROUTES.index(route), stream)
    _build.check(lib, err, f"fused_dw_chain ({route})")
    fused_dw_chain.launches += 1
    fused_dw_chain.launches_by_route[route] += 1
    return out


def _backward_kernel(x, taps, dwb, s1, b1, s2, b2, seed, g, w, rate, route=None):
    """Kernel #10 on ``route`` (default: :func:`backward_route`'s); a shape
    the route does not take raises."""
    n, hw, c = _operands(x, taps, dwb, s1, b1, s2, b2, w)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"fused_dw_chain backward: g {tuple(g.shape)} {g.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    lib = _lib_bwd()
    route = route or backward_route(hw, c, x.dtype, w)
    dev, f32 = x.device, torch.float32
    dx = torch.empty_like(x)
    dtaps, ddwb = torch.empty(9, c, dtype=f32, device=dev), torch.empty(c, dtype=f32, device=dev)
    ds1, db1, ds2, db2 = (torch.empty(hw, c, dtype=f32, device=dev) for _ in range(4))
    p = _build.ptr
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "tiled":
        _check_tiled("fused_dw_chain backward", x, w)
        groups = lib.vptr_fused_dw_chain_bwd_tiled_groups(n)
        z2, da1 = (torch.empty(n, hw, c, dtype=f32, device=dev) for _ in range(2))
        part = torch.empty(n, (hw // w) * (c // T_CH), 2, dtype=f32, device=dev)
        stats = torch.empty(4, n, 2, dtype=f32, device=dev)
        # the sample groups' partial sums (and the tap sums by group and grid
        # row), added in their order by the last pass
        gpart = torch.empty(groups, 4, hw, c, dtype=f32, device=dev)
        tpart = torch.empty(groups, hw // w, 10, c, dtype=f32, device=dev)
        err = lib.vptr_fused_dw_chain_bwd_tiled(
            p(x), p(taps), p(dwb), p(s1), p(b1), p(s2), p(b2), p(g), p(dx), p(dtaps),
            p(ddwb), p(ds1), p(db1), p(ds2), p(db2), p(z2), p(da1), p(part), p(stats),
            p(gpart), p(tpart), n, hw, w, c, LN_EPS, *_dropout_args(seed, rate),
            _DTYPES[x.dtype], stream)
    else:
        if route == "persistent":
            if backward_route(hw, c, x.dtype, w) != "persistent":
                raise ValueError(f"fused_dw_chain backward persistent route: HW={hw}, w={w}, "
                                 f"C={c}, {x.dtype} is not a shape it takes")
            if any(t.data_ptr() % 16 for t in (x, taps, dwb, s1, b1, s2, b2, g)):
                raise ValueError("fused_dw_chain backward persistent route: every operand "
                                 "must be 16-byte aligned (the slices are read in 16-byte "
                                 "pieces)")
            resident = lib.vptr_fused_dw_chain_bwd_persistent_clusters(hw, w, c)
            if resident < 1:
                raise RuntimeError(f"fused_dw_chain backward persistent route: no cluster of "
                                   f"{P_CLUSTER} blocks fits for HW={hw}, C={c}")
            groups = min(n, resident)
        elif route == "groups":
            smem = lib.vptr_fused_dw_chain_bwd_smem(hw, c)
            if smem > SMEM_LIMIT:
                _refuse("fused_dw_chain backward kernel", hw, c, w, smem, x)
            groups = lib.vptr_fused_dw_chain_bwd_groups(n)
        else:
            raise ValueError(f"fused_dw_chain backward: unknown route {route!r}")
        # the groups' (clusters') partial sums, added in their order by the
        # second pass
        part = torch.empty(groups, 4, hw, c, dtype=f32, device=dev)
        tpart = torch.empty(groups, 10, c, dtype=f32, device=dev)
        err = lib.vptr_fused_dw_chain_bwd(
            p(x), p(taps), p(dwb), p(s1), p(b1), p(s2), p(b2), p(g), p(dx), p(dtaps),
            p(ddwb), p(ds1), p(db1), p(ds2), p(db2), p(part), p(tpart), n, hw, w, c,
            LN_EPS, *_dropout_args(seed, rate), _DTYPES[x.dtype], BWD_ROUTES.index(route),
            stream)
    _build.check(lib, err, f"fused_dw_chain backward ({route})")
    fused_dw_chain.bwd_launches += 1
    fused_dw_chain.bwd_launches_by_route[route] += 1
    return dx, dtaps, ddwb, ds1, db1, ds2, db2


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_dw_chain")
    fn = lib.vptr_fused_dw_chain
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 8 + [i] * 4 + [f, p, f, f, i, i, p]
        fn.restype = ctypes.c_int
        lib.vptr_fused_dw_chain_smem.argtypes = [i, i]
        lib.vptr_fused_dw_chain_smem.restype = ctypes.c_long
        lib.vptr_fused_dw_chain_clusters.argtypes = [i, i]
        lib.vptr_fused_dw_chain_clusters.restype = i
        lib.vptr_fused_dw_chain_persistent_clusters.argtypes = [i, i, i]
        lib.vptr_fused_dw_chain_persistent_clusters.restype = i
        lib.vptr_fused_dw_chain_route.argtypes = [i, i, i, i]
        lib.vptr_fused_dw_chain_route.restype = i
        lib.vptr_fused_dw_chain_tiled.argtypes = [p] * 11 + [i] * 4 + [f, p, f, f, i, p]
        lib.vptr_fused_dw_chain_tiled.restype = i
        lib.vptr_fused_dw_chain_tiled_step.argtypes = [i] + [p] * 11 + [i] * 4 + [
            p, f, f, i, i, i, p]
        lib.vptr_fused_dw_chain_tiled_step.restype = i
        lib.vptr_fused_dw_chain_tiled_merge.argtypes = [p, p, i, i, i, i, f, i, p]
        lib.vptr_fused_dw_chain_tiled_merge.restype = i
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("fused_dw_chain_bwd")
    fn = lib.vptr_fused_dw_chain_bwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 17 + [i] * 4 + [f, p, f, f, i, i, p]
        fn.restype = ctypes.c_int
        lib.vptr_fused_dw_chain_bwd_persistent_clusters.argtypes = [i, i, i]
        lib.vptr_fused_dw_chain_bwd_persistent_clusters.restype = i
        lib.vptr_fused_dw_chain_bwd_route.argtypes = [i, i, i, i]
        lib.vptr_fused_dw_chain_bwd_route.restype = i
        lib.vptr_fused_dw_chain_bwd_groups.argtypes = [i]
        lib.vptr_fused_dw_chain_bwd_groups.restype = ctypes.c_int
        lib.vptr_fused_dw_chain_bwd_smem.argtypes = [i, i]
        lib.vptr_fused_dw_chain_bwd_smem.restype = ctypes.c_long
        lib.vptr_fused_dw_chain_bwd_clusters.argtypes = [i, i]
        lib.vptr_fused_dw_chain_bwd_clusters.restype = ctypes.c_int
        lib.vptr_fused_dw_chain_bwd_tiled_groups.argtypes = [i]
        lib.vptr_fused_dw_chain_bwd_tiled_groups.restype = i
        lib.vptr_fused_dw_chain_bwd_tiled.argtypes = [p] * 21 + [i] * 4 + [f, p, f, f, i, p]
        lib.vptr_fused_dw_chain_bwd_tiled.restype = i
        lib.vptr_fused_dw_chain_bwd_tiled_step.argtypes = [i] + [p] * 21 + [i] * 4 + [
            p, f, f, i, i, i, p]
        lib.vptr_fused_dw_chain_bwd_tiled_step.restype = i
    return lib
