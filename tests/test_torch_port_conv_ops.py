"""Kernel #11/#12's plain versions (``conv_ln_gelu``) against the JAX
package's TPU kernels (Pallas interpret mode), on the CPU.

(s) ``conv_ln_gelu_plain`` against ``vptr_tpu.ops.fused_conv_ln.conv_ln_gelu
    (..., interpret=True)`` over 7 samples (ragged against the JAX sample
    block of 4), HW 64, 24 -> 48 and 48 -> 24 channels: the forward;
(t) ``conv_ln_gelu_backward_plain`` on its own against the JAX backward
    kernel, and the wrapper ``conv_ln_gelu`` on CPU tensors (the plain
    forward, the plain backward through its autograd Function) against
    ``jax.vjp``: every gradient;
(u) bf16: the weight gradient comes back in w's dtype, rounded to bf16 as
    the JAX ``_backward`` returns it, equal to the f32 plain gradient
    rounded once.

Inputs are seeded numpy in f32. Tolerances: the forward 1e-5 (absolute,
plus 1e-5 relative to the largest output: the same f32 arithmetic in
another summation order, Cin-long dot products and the whole-sample means
over HW Cout); the gradients 2e-4 relative to the largest magnitude of each
(dW and db sum 7 x 64 rows, ds and dt 7 samples, of products whose f32
error the LayerNorm backward's cancellation enlarges).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.ops import fused_conv_ln as jconv
from vptr_tpu_torch.ops.conv_ln_gelu import (
    conv_ln_gelu,
    conv_ln_gelu_backward_plain,
    conv_ln_gelu_plain,
)

from _torch_port_util import t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
GRAD_TOL = 2e-4
NAMES = ("x", "w", "b", "scale", "bias2")
SHAPES = [(24, 48), (48, 24)]


def _close(got, want, name, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    bound = tol * (1.0 + np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


def _args(rng, n, hw, cin, cout):
    return [a.astype(np.float32) for a in (
        rng.standard_normal((n, hw, cin)),
        rng.standard_normal((cin, cout)) * cin ** -0.5,
        rng.standard_normal(cout) * 0.1,
        1 + 0.1 * rng.standard_normal((hw, cout)),
        0.1 * rng.standard_normal((hw, cout)))]


def _jax_fn(*a):
    return jconv.conv_ln_gelu(*a, 1e-5, True, 4)


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_conv_ln_gelu_plain_matches_jax(cin, cout):
    args = _args(np.random.default_rng(100 + cin), 7, 64, cin, cout)
    want = _jax_fn(*map(jnp.asarray, args))
    _close(conv_ln_gelu_plain(*map(t, args)).numpy(), want, "y")


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_conv_ln_gelu_backward_plain_matches_jax_bwd_kernel(cin, cout):
    """The plain backward on its own (what chip_smoke holds kernel #12
    against) equals the JAX backward kernel's outputs."""
    rng = np.random.default_rng(110 + cin)
    args = _args(rng, 7, 64, cin, cout)
    g = rng.standard_normal((7, 64, cout)).astype(np.float32)
    want = jconv._backward(*map(jnp.asarray, args), jnp.asarray(g), 1e-5, 4, True)
    got = conv_ln_gelu_backward_plain(*map(t, args), t(g))
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.float32, name
        _close(a.numpy(), b, name, GRAD_TOL)


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_conv_ln_gelu_wrapper_matches_jax_vjp(cin, cout):
    """The wrapper on CPU tensors: the plain forward and, through its
    autograd Function, the plain backward, against ``jax.vjp``."""
    rng = np.random.default_rng(120 + cin)
    args = _args(rng, 7, 64, cin, cout)
    g = rng.standard_normal((7, 64, cout)).astype(np.float32)
    want, vjp = jax.vjp(_jax_fn, *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(g))
    targs = [t(a).requires_grad_() for a in args]
    got = conv_ln_gelu(*targs)
    _close(got.detach().numpy(), want, "y")
    grads = torch.autograd.grad(got, targs, t(g))
    for name, a, b in zip(NAMES, grads, want_grads):
        _close(a.numpy(), b, name, GRAD_TOL)
    assert conv_ln_gelu.launches == conv_ln_gelu.bwd_launches == 0


def test_conv_ln_gelu_bf16_weight_gradient_is_rounded():
    """bf16 operands (the route's ``kernel.astype(bfloat16)``): dW comes back
    in bf16, the f32 sum rounded once, as JAX's ``dw.astype(w.dtype)``; dx
    in bf16; db, d(scale), d(bias2) f32. The JAX kernel's own bf16 outputs
    agree within a bf16 ulp of each gradient's largest magnitude."""
    rng = np.random.default_rng(130)
    args = _args(rng, 7, 64, 24, 48)
    g = rng.standard_normal((7, 64, 48)).astype(np.float32)
    bf = torch.bfloat16
    targs = [t(a) for a in args]
    targs[0], targs[1] = targs[0].to(bf), targs[1].to(bf)
    got = conv_ln_gelu_backward_plain(*targs, t(g).to(bf))
    assert [a.dtype for a in got] == [bf, bf, torch.float32, torch.float32,
                                      torch.float32]
    f32 = conv_ln_gelu_backward_plain(targs[0].float(), targs[1].float(),
                                      *targs[2:], t(g).to(bf).float())
    assert torch.equal(got[1], f32[1].to(bf))
    assert torch.equal(got[1].float(), got[1].float().to(bf).float())
    jargs = [jnp.asarray(a) for a in args]
    jargs[0], jargs[1] = jargs[0].astype(jnp.bfloat16), jargs[1].astype(jnp.bfloat16)
    want = jconv._backward(*jargs, jnp.asarray(g).astype(jnp.bfloat16), 1e-5, 4, True)
    assert want[1].dtype == jnp.bfloat16
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b.astype(jnp.float32))
        assert np.abs(a.float().numpy() - b).max() <= 2 ** -7 * max(1.0, np.abs(b).max()), name
