"""The fused feed-forward kernels' plain versions against the JAX package's
TPU kernels (Pallas interpret mode), on the CPU.

(m) the A&S GELU and its gradient (``ops/gelu.py``) equal to
    ``fused_conv_ln._gelu`` / ``_gelu_grad``; the hidden-dropout masks
    ``ffn_keep_mask`` / ``dw_keep_mask`` bit-equal to JAX's;
(n) kernel #7/#8's plain versions (``fused_ffn_plain``, and the wrapper
    ``fused_ffn`` on CPU tensors with ``fused_ffn_backward_plain`` as its
    backward) against ``vptr_tpu.ops.fused_ffn.fused_ffn(...,
    interpret=True)``: the forward and all seven gradients, dropout 0 and
    0.3, rows ragged against the JAX row tile;
(o) kernel #9/#10's (``fused_dw_chain_plain``, the wrapper) against
    ``fused_dw_chain(..., interpret=True)``, the same way; and #9's plain
    version at the real width (C = 2112, N = 2, bf16 input, dropout 0 and
    0.1) within one bf16 ulp of each output, of 2^-8 at least (both sum in
    f32 and round to bf16 once: a rounding may fall the other way);
(p) ``kernel_route`` (#9's route: "persistent", "per_sample" or "tiled")
    and ``backward_route`` (#10's: "persistent", "groups" or "tiled") at
    the presets' shapes and at the edges of what the persistent routes
    take, functions of the shapes alone (no library is built on the CPU);
(q) #10's plain version at the real width (C = 2112, N = 2, x and g in
    bf16, dropout 0 and 0.1) against the JAX backward kernel: dx within one
    bf16 ulp (of 2^-8 at least), the f32 gradients within the tolerance
    below.

Inputs are seeded numpy in f32. Tolerance 1e-5 (absolute, plus 1e-5
relative to the largest value of each output or gradient): the same f32
arithmetic in another summation order (C- and H-long dot products, the
whole-sample means over HW C, the gradients summed over all rows or
samples).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.ops import fused_conv_ln as jconv
from vptr_tpu.ops import fused_dw_chain as jdw
from vptr_tpu.ops import fused_ffn as jffn
from vptr_tpu_torch.ops import dropout as tdrop
from vptr_tpu_torch.ops import gelu as tgelu
from vptr_tpu_torch.config import get_preset, list_presets
from vptr_tpu_torch.ops.fused_dw_chain import (
    fused_dw_chain,
    fused_dw_chain_backward_plain,
    backward_route,
    fused_dw_chain_plain,
    kernel_route,
)
from vptr_tpu_torch.ops.fused_ffn import (
    fused_ffn,
    fused_ffn_backward_plain,
    fused_ffn_plain,
)

from _torch_port_util import t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
FFN_NAMES = ("x", "w1", "b1", "w2", "b2", "ls", "lb")
DW_NAMES = ("x", "taps", "dwb", "s1", "b1", "s2", "b2")


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    tol = TOL + TOL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


# ------------------------------------------------------------- (m) helpers

def test_gelu_matches_jax():
    a = np.concatenate([np.linspace(-8, 8, 4001), [0.0, -0.0, 1e-20, -1e-20]])
    a = a.astype(np.float32)
    np.testing.assert_allclose(tgelu.gelu_as(t(a)).numpy(),
                               np.asarray(jconv._gelu(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tgelu.gelu_as_grad(t(a)).numpy(),
                               np.asarray(jconv._gelu_grad(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 321, -5, 2 ** 31 - 2])
def test_ffn_and_dw_masks_bit_equal(seed):
    got = tdrop.ffn_keep_mask(seed, 37, 96, 0.3)
    want = np.asarray(jffn.ffn_keep_mask(seed, 37, 96, 0.3))
    np.testing.assert_array_equal(got.numpy(), want)
    got = tdrop.dw_keep_mask(seed, 5, 64, 40, 0.1)
    want = np.asarray(jdw.dw_keep_mask(seed, 5, 64, 40, 0.1))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------- (n) FFN

def _ffn_args(rng, s, c, h):
    return (rng.standard_normal((s, c)),
            rng.standard_normal((c, h)) * c ** -0.5,
            rng.standard_normal(h) * 0.1,
            rng.standard_normal((h, c)) * h ** -0.5,
            rng.standard_normal(c) * 0.1,
            1 + 0.1 * rng.standard_normal(c),
            0.1 * rng.standard_normal(c))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("route", ["wrapper", "plain"])
def test_fused_ffn_matches_jax(rate, route):
    rng = np.random.default_rng(80)
    s, c, h, seed = 200, 48, 192, 1234
    args = [a.astype(np.float32) for a in _ffn_args(rng, s, c, h)]
    g = rng.standard_normal((s, c)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args]
    want, vjp = jax.vjp(
        lambda *a: jffn.fused_ffn(*a, seed, rate, 64, True, 32), *jargs)
    want_grads = vjp(jnp.asarray(g))

    targs = [t(a).requires_grad_() for a in args]
    fn = fused_ffn if route == "wrapper" else fused_ffn_plain
    got = fn(*targs, seed, rate)
    _close(got.detach().numpy(), want, "y")
    grads = torch.autograd.grad(got, targs, t(g))
    for name, a, b in zip(FFN_NAMES, grads, want_grads):
        _close(a.numpy(), b, name)


def test_fused_ffn_backward_plain_matches_jax_bwd_kernel():
    """The plain backward on its own (what chip_smoke holds kernel #8
    against) equals the JAX backward kernel's outputs."""
    rng = np.random.default_rng(81)
    s, c, h, seed, rate = 136, 32, 128, 77, 0.3
    args = [a.astype(np.float32) for a in _ffn_args(rng, s, c, h)]
    g = rng.standard_normal((s, c)).astype(np.float32)
    want = jffn._backward(*map(jnp.asarray, args), seed, jnp.asarray(g), rate,
                          32, True)
    got = fused_ffn_backward_plain(*map(t, args), seed, t(g), rate)
    for name, a, b in zip(FFN_NAMES, got, want):
        _close(a.numpy(), b, name)


# -------------------------------------------------------------- (o) dw chain

def _dw_args(rng, n, hw, c):
    return (rng.standard_normal((n, hw, c)),
            rng.standard_normal((9, c)) * 0.2,
            rng.standard_normal(c) * 0.05,
            1 + 0.1 * rng.standard_normal((hw, c)),
            0.1 * rng.standard_normal((hw, c)),
            1 + 0.1 * rng.standard_normal((hw, c)),
            0.1 * rng.standard_normal((hw, c)))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("route", ["wrapper", "plain"])
def test_fused_dw_chain_matches_jax(rate, route):
    rng = np.random.default_rng(82)
    n, w, c, seed = 6, 8, 32, 99
    args = [a.astype(np.float32) for a in _dw_args(rng, n, w * w, c)]
    g = rng.standard_normal((n, w * w, c)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args]
    want, vjp = jax.vjp(
        lambda *a: jdw.fused_dw_chain(*a, seed, w, rate, 4, True), *jargs)
    want_grads = vjp(jnp.asarray(g))

    targs = [t(a).requires_grad_() for a in args]
    fn = fused_dw_chain if route == "wrapper" else fused_dw_chain_plain
    got = fn(*targs, seed, w, rate)
    _close(got.detach().numpy(), want, "z3")
    grads = torch.autograd.grad(got, targs, t(g))
    for name, a, b in zip(DW_NAMES, grads, want_grads):
        _close(a.numpy(), b, name)


def test_fused_dw_chain_backward_plain_on_a_wide_grid():
    """A 4 x 16 grid (w != h) against the JAX backward kernel: the row
    masks and the transposed conv at the grid's edges."""
    rng = np.random.default_rng(83)
    n, w, hw, c, seed, rate = 3, 16, 64, 24, 5, 0.1
    args = [a.astype(np.float32) for a in _dw_args(rng, n, hw, c)]
    g = rng.standard_normal((n, hw, c)).astype(np.float32)
    want = jdw._backward(*map(jnp.asarray, args), seed, jnp.asarray(g), w,
                         rate, 2, True)
    got = fused_dw_chain_backward_plain(*map(t, args), seed, t(g), w, rate)
    for name, a, b in zip(DW_NAMES, got, want):
        _close(a.numpy(), b, name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_dw_chain_plain_matches_jax_at_the_real_width(rate):
    """C = 2112 (far_mnist's hidden), an 8 x 8 grid, N = 2, x in bf16 as
    the bf16 route takes it: the output within one bf16 ulp of JAX's."""
    rng = np.random.default_rng(84)
    n, w, c, seed = 2, 8, 2112, 4321
    args = [a.astype(np.float32) for a in _dw_args(rng, n, w * w, c)]
    x = torch.from_numpy(args[0]).to(torch.bfloat16)
    want = jdw.fused_dw_chain(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              *map(jnp.asarray, args[1:]), seed, w, rate, 2, True)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    got = fused_dw_chain_plain(x, *map(t, args[1:]), seed, w, rate)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy().astype(np.float64)
    # one bf16 ulp of the output; near zero (the GELU's far tail, where
    # the f32 roundings are large beside the value) one ulp of 2^-8
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -8))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_dw_chain_backward_plain_matches_jax_at_the_real_width(rate):
    """C = 2112, an 8 x 8 grid, N = 2, x and g in bf16 as #10's bf16 route
    takes them, against the JAX backward kernel: dx within one bf16 ulp of
    JAX's (of 2^-8 near zero), every f32 gradient within TOL."""
    rng = np.random.default_rng(85)
    n, w, c, seed = 2, 8, 2112, 4321
    args = [a.astype(np.float32) for a in _dw_args(rng, n, w * w, c)]
    x = torch.from_numpy(args[0]).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((n, w * w, c)).astype(np.float32))
    g = g.to(torch.bfloat16)
    jx, jg = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (x, g))
    want = jdw._backward(jx, *map(jnp.asarray, args[1:]), seed, jg, w, rate, 2, True)
    got = fused_dw_chain_backward_plain(x, *map(t, args[1:]), seed, g, w, rate)
    dx, dx_want = got[0], np.asarray(want[0].astype(jnp.float32), np.float64)
    assert dx.dtype == torch.bfloat16 and dx.shape == dx_want.shape
    dx = dx.float().numpy().astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(dx_want), 2.0 ** -8))) - 7)
    assert (np.abs(dx - dx_want) <= ulp).all()
    for name, a, b in zip(DW_NAMES[1:], got[1:], want[1:]):
        _close(a.numpy(), b, name)


_BF, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("name", [p for p in list_presets()
                                  if get_preset(p).stage in ("far", "nar")])
def test_kernel_route_at_the_presets(name):
    """bf16 samples of 8 x 8 x 2112 take the persistent route, f32 the
    per-sample one; the 16 x 16 grid of nar_kth_128 (a per-sample slice
    does not fit shared memory) the tiled route in both dtypes."""
    tc = get_preset(name).transformer
    hw, c = tc.enc_h * tc.enc_w, tc.spatial_ffn_hidden_ratio * tc.d_model
    assert kernel_route(hw, c, _BF, tc.enc_w) == ("persistent" if hw <= 64 else "tiled")
    assert kernel_route(hw, c, _F32, tc.enc_w) == ("per_sample" if hw <= 64 else "tiled")


@pytest.mark.parametrize("hw,w,c,dtype,want", [
    (64, 8, 64, _BF, "persistent"),     # the narrowest C: a quad a block
    (64, 8, 32, _BF, "per_sample"),     # under 4 x 16 channels
    (64, 8, 96, _BF, "per_sample"),     # not a multiple of 64
    (64, 8, 2112, _F32, "per_sample"),  # f32 keeps the per-sample kernel
    (64, 8, 2176, _BF, "per_sample"),   # the slice's shared memory over the limit
    (16, 4, 4096, _BF, "persistent"),   # a 256-channel slice: the widest TMA box
    (16, 4, 4160, _BF, "per_sample"),   # 260 channels + 4: wider than a box
    (256, 32, 64, _BF, "persistent"),   # 256 rows: the tallest box
    (264, 33, 64, _BF, "per_sample"),
    (64, 12, 2112, _BF, "per_sample"),  # HW not a multiple of the grid's width
    (16, 16, 2112, _BF, "persistent"),  # 1,056 pair-columns: 544 past 512, by points
    (0, 8, 2112, _BF, "per_sample"),
])
def test_kernel_route_at_the_edges(hw, w, c, dtype, want):
    assert kernel_route(hw, c, dtype, w) == want


@pytest.mark.parametrize("name", [p for p in list_presets()
                                  if get_preset(p).stage in ("far", "nar")])
def test_backward_route_at_the_presets(name):
    """bf16 samples of 8 x 8 x 2112 take #10's persistent route, f32 the
    group route; the 16 x 16 grid of nar_kth_128 (a group block's slices
    do not fit shared memory) the tiled route in both dtypes."""
    tc = get_preset(name).transformer
    hw, c = tc.enc_h * tc.enc_w, tc.spatial_ffn_hidden_ratio * tc.d_model
    assert backward_route(hw, c, _BF, tc.enc_w) == ("persistent" if hw <= 64 else "tiled")
    assert backward_route(hw, c, _F32, tc.enc_w) == ("groups" if hw <= 64 else "tiled")


@pytest.mark.parametrize("hw,w,c,dtype,want", [
    (64, 8, 2112, _BF, "persistent"),   # far_mnist's: 230,848 bytes of 231,448
    (64, 8, 64, _BF, "persistent"),     # the narrowest C: a quad a block
    (64, 8, 32, _BF, "groups"),         # under 4 x 16 channels
    (64, 8, 96, _BF, "groups"),         # not a multiple of 64
    (64, 8, 2112, _F32, "groups"),      # f32 keeps the group kernel
    (64, 8, 2176, _BF, "groups"),       # the block's shared memory over the limit
    (16, 4, 4096, _BF, "persistent"),   # a 256-channel slice: the widest TMA box
    (16, 4, 4160, _BF, "groups"),       # 260 channels + 4: wider than a box
    (256, 32, 64, _BF, "persistent"),   # 256 rows, a grid a warp wide
    (264, 33, 64, _BF, "groups"),
    (40, 5, 192, _BF, "groups"),        # 5 does not divide 32 (#9's persistent route takes it)
    (64, 64, 64, _BF, "groups"),        # a grid wider than a warp
    (64, 12, 2112, _BF, "groups"),      # HW not a multiple of the grid's width
    (16, 16, 2112, _BF, "persistent"),  # 1,056 pair-columns: three rounds of 512 threads
    (0, 8, 2112, _BF, "groups"),
])
def test_backward_route_at_the_edges(hw, w, c, dtype, want):
    assert backward_route(hw, c, dtype, w) == want
