"""Kernels #9-#12 at nar_kth_128's 16 x 16 latent (HW 256, a 16-wide grid),
narrow channels, on the CPU: the plain versions (the references the card's
tiled routes are held to) against the JAX package's TPU kernels in Pallas
interpret mode, and the route functions at the preset's shapes.

(a) ``dw_keep_mask`` at (3, 256, 64) bit-equal to JAX's;
(b) kernel #9/#10's plain versions through the wrapper on CPU tensors
    (``fused_dw_chain``: the plain forward, the plain backward through its
    autograd Function) against ``jax.vjp`` of ``vptr_tpu.ops.
    fused_dw_chain.fused_dw_chain(..., interpret=True)`` over 3 samples of
    256 x 64, dropout 0 and 0.1: the output and all seven gradients; and
    ``fused_dw_chain_backward_plain`` on its own against the JAX backward
    kernel;
(c) kernel #11/#12's (``conv_ln_gelu`` on CPU tensors) against ``jax.vjp``
    of ``fused_conv_ln.conv_ln_gelu(..., interpret=True)`` over 3 samples
    of 256 positions, 24 -> 48 and 48 -> 24 channels, and
    ``conv_ln_gelu_backward_plain`` against the JAX backward kernel;
(d) ``kernel_route`` / ``backward_route`` (#9 / #10) name "tiled" at
    (256, 2112, w 16) in bf16 and f32, and ``conv_ln_gelu.kernel_route``
    names "tiled" at both conv-FFN stages of the 16 x 16 latent and
    "cluster" at far_mnist's 8 x 8 (every shape the older routes took keeps
    its route: ``test_torch_port_ffn_ops.py`` (p) holds #9's and #10's).

Inputs are seeded numpy in f32. Tolerances as ``test_torch_port_ffn_ops.py``
and ``test_torch_port_conv_ops.py``: #9/#10 1e-5 absolute plus 1e-5 of the
largest value of each output or gradient (the same f32 arithmetic in
another summation order: the whole-sample means now over 256 x 64 values);
#11 1e-5 and #12 2e-4 of (1 + the largest magnitude) of each (dW and db sum
3 x 256 rows of products whose f32 error the LayerNorm backward's
cancellation enlarges).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.ops import fused_conv_ln as jconv
from vptr_tpu.ops import fused_dw_chain as jdw
from vptr_tpu_torch.ops import conv_ln_gelu as tcl
from vptr_tpu_torch.ops import dropout as tdrop
from vptr_tpu_torch.ops import fused_dw_chain as tdw

from _torch_port_util import t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

HW, W = 256, 16                 # nar_kth_128's latent: a 16 x 16 grid
DW_NAMES = ("x", "taps", "dwb", "s1", "b1", "s2", "b2")
CONV_NAMES = ("x", "w", "b", "scale", "bias2")


def _close(got, want, name, tol, rel_to_one=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    big = np.abs(want).max()
    bound = tol * (1.0 + big) if rel_to_one else tol + tol * big
    err = np.abs(got - want).max()
    assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


def _dw_args(rng, n, c):
    return [a.astype(np.float32) for a in (
        rng.standard_normal((n, HW, c)), 0.3 * rng.standard_normal((9, c)),
        0.1 * rng.standard_normal(c), 1 + 0.1 * rng.standard_normal((HW, c)),
        0.1 * rng.standard_normal((HW, c)), 1 + 0.1 * rng.standard_normal((HW, c)),
        0.1 * rng.standard_normal((HW, c)))]


def _conv_args(rng, n, cin, cout):
    return [a.astype(np.float32) for a in (
        rng.standard_normal((n, HW, cin)), rng.standard_normal((cin, cout)) * cin ** -0.5,
        rng.standard_normal(cout) * 0.1, 1 + 0.1 * rng.standard_normal((HW, cout)),
        0.1 * rng.standard_normal((HW, cout)))]


# ------------------------------------------------------------------ (a)

def test_dw_mask_bit_equal_at_hw_256():
    got = tdrop.dw_keep_mask(8765, 3, HW, 64, 0.1)
    want = np.asarray(jdw.dw_keep_mask(8765, 3, HW, 64, 0.1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < 1 - want.mean() < 0.15


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_dw_chain_matches_jax_at_hw_256(rate):
    rng = np.random.default_rng(230)
    n, c, seed = 3, 64, 8765
    args = _dw_args(rng, n, c)
    g = rng.standard_normal((n, HW, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jdw.fused_dw_chain(*a, seed, W, rate, 2, True),
                        *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(g))
    targs = [t(a).requires_grad_() for a in args]
    got = tdw.fused_dw_chain(*targs, seed, W, rate)
    _close(got.detach().numpy(), want, "z3", 1e-5)
    grads = torch.autograd.grad(got, targs, t(g))
    for name, a, b in zip(DW_NAMES, grads, want_grads):
        _close(a.numpy(), b, name, 1e-5)
    assert tdw.fused_dw_chain.launches == tdw.fused_dw_chain.bwd_launches == 0


def test_fused_dw_chain_backward_plain_matches_jax_bwd_kernel_at_hw_256():
    rng = np.random.default_rng(231)
    n, c, seed, rate = 2, 96, 17, 0.1
    args = _dw_args(rng, n, c)
    g = rng.standard_normal((n, HW, c)).astype(np.float32)
    want = jdw._backward(*map(jnp.asarray, args), seed, jnp.asarray(g), W, rate, 2, True)
    got = tdw.fused_dw_chain_backward_plain(*map(t, args), seed, t(g), W, rate)
    for name, a, b in zip(DW_NAMES, got, want):
        _close(a.numpy(), b, name, 1e-5)


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("cin,cout", [(24, 48), (48, 24)])
def test_conv_ln_gelu_matches_jax_at_hw_256(cin, cout):
    rng = np.random.default_rng(232 + cin)
    args = _conv_args(rng, 3, cin, cout)
    g = rng.standard_normal((3, HW, cout)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jconv.conv_ln_gelu(*a, 1e-5, True, 2),
                        *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(g))
    targs = [t(a).requires_grad_() for a in args]
    got = tcl.conv_ln_gelu(*targs)
    _close(got.detach().numpy(), want, "y", 1e-5, rel_to_one=True)
    grads = torch.autograd.grad(got, targs, t(g))
    for name, a, b in zip(CONV_NAMES, grads, want_grads):
        _close(a.numpy(), b, name, 2e-4, rel_to_one=True)
    plain = tcl.conv_ln_gelu_backward_plain(*map(t, args), t(g))
    kernel = jconv._backward(*map(jnp.asarray, args), jnp.asarray(g), 1e-5, 2, True)
    for name, a, b in zip(CONV_NAMES, plain, kernel):
        _close(a.numpy(), b, name, 2e-4, rel_to_one=True)
    assert tcl.conv_ln_gelu.launches == tcl.conv_ln_gelu.bwd_launches == 0


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dw_chain_routes_at_nar_kth_128(dtype):
    """256 x 2112 on a 16-wide grid: the per-sample block would take
    540,672 B and the group block 821,568 B of shared memory, the
    persistent routes' 886,048 B and 891,328 B; the tiled routes take it
    in both dtypes."""
    assert tdw.per_sample_smem(HW, 2112) == 540672
    assert tdw.groups_smem(HW, 2112) == 821568
    assert tdw.persistent_smem(HW, 2112) == 886048
    assert tdw.backward_smem(HW, 2112) == 891328
    assert tdw.kernel_route(HW, 2112, dtype, W) == "tiled"
    assert tdw.backward_route(HW, 2112, dtype, W) == "tiled"


@pytest.mark.parametrize("hw,w,c,dtype,fwd,bwd", [
    # 262,144 B for the per-sample block, 398,336 B for the group block
    (256, 16, 1024, torch.float32, "tiled", "tiled"),
    # 196,608 B: the per-sample block fits; the group block's 300,032 B do not
    (192, 16, 1024, torch.float32, "per_sample", "tiled"),
    (128, 16, 1024, torch.float32, "per_sample", "groups"),   # 201,728 B: both fit
    (256, 64, 2112, torch.float32, "per_sample", "groups"),   # a grid past 32 wide
    (256, 16, 2080, torch.bfloat16, "tiled", "tiled"),    # not a multiple of 64
    (256, 16, 2096, torch.float32, "per_sample", "groups"),   # not a multiple of 32
])
def test_dw_chain_tiled_route_at_its_edges(hw, w, c, dtype, fwd, bwd):
    """Past the per-sample (group) block's shared memory the tiled route
    takes the shape, where it takes it; elsewhere the older route keeps
    it (and still refuses what does not fit)."""
    assert tdw.kernel_route(hw, c, dtype, w) == fwd
    assert tdw.backward_route(hw, c, dtype, w) == bwd


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,cin,cout,want", [
    (256, 528, 2112, "tiled"), (256, 2112, 528, "tiled"),     # nar_kth_128's stages
    (64, 528, 2112, "cluster"), (64, 2112, 528, "cluster"),   # far_mnist's
    (16, 48, 96, "cluster"), (80, 80, 368, "tiled"),
    (64, 48, 592, "tiled"),            # 37 column tiles split into no slabs
    (4096, 16, 16, "tiled"), (4112, 16, 16, None), (36, 48, 48, None), (256, 24, 48, None),
])
def test_conv_ln_gelu_routes(dtype, hw, cin, cout, want):
    assert tcl.kernel_route(hw, cin, cout, dtype) == want
