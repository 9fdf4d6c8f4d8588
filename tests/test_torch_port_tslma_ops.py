"""The TSLMA slice's operations against the JAX package's, on the CPU.

(s) ``temporal_window_partition`` / ``temporal_window_reverse`` bit-equal
    to JAX's, the round trip the identity; ``position_embedding_3d`` equal
    to JAX's to 1e-7, refusing a width that does not divide by 3;
(t) the attention core's plain versions at TSLMA's token counts, (Tq, Tk)
    = (160, 160) (nar_mnist's 10 + 10 frames of 4 x 4 windows) and (160,
    32) (nar_bair's 2 past frames), with and without a bias, dropout 0 and
    0.1 on one seed, against ``vptr_tpu.ops.attention_core`` (Pallas in
    interpret mode) and its ``jax.vjp``: forward 1e-5 absolute, gradients
    1e-5 relative to the largest magnitude (f32, b = 2, h = 2, d = 8);
(u) ``kernel_route`` / ``backward_route`` name the long route at those
    token counts (both dtypes, D = 66), keep the short routes at <= 32
    tokens, and raise past the long route's reach.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.models.position import position_embedding_3d as jpos3d
from vptr_tpu.ops import attention_core as jax_core
from vptr_tpu.ops import window as jwindow
from vptr_tpu_torch.models.position import position_embedding_3d
from vptr_tpu_torch.ops import attention_core as tac
from vptr_tpu_torch.ops.window import temporal_window_partition, temporal_window_reverse

from _torch_port_util import assert_grad_close, core_bias, jax_core_vjp, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("shape,window", [((2, 10, 8, 8, 48), 4),
                                          ((1, 2, 16, 8, 5), 4),
                                          ((3, 3, 4, 6, 7), 2)])
def test_temporal_window_partition_matches_jax(shape, window):
    x = np.random.default_rng(90).standard_normal(shape).astype(np.float32)
    want = np.asarray(jwindow.temporal_window_partition(jnp.asarray(x), window))
    got = temporal_window_partition(t(x), window)
    np.testing.assert_array_equal(got.numpy(), want)
    back = temporal_window_reverse(got, window, shape[1], shape[2:4])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jwindow.temporal_window_reverse(
            jnp.asarray(want), window, shape[1], shape[2:4])))
    np.testing.assert_array_equal(back.numpy(), x)


def test_temporal_window_partition_refuses_a_partial_window():
    with pytest.raises(ValueError, match="multiple of the window"):
        temporal_window_partition(torch.zeros(1, 2, 6, 8, 3), 4)


@pytest.mark.parametrize("shape", [(20, 4, 4, 528), (3, 2, 2, 9)])
def test_position_embedding_3d_matches_jax(shape):
    got = position_embedding_3d(*shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jpos3d(*shape)), rtol=0, atol=1e-7)


def test_position_embedding_3d_refuses_width_not_divisible_by_3():
    with pytest.raises(ValueError, match="divisible by 3"):
        position_embedding_3d(4, 4, 4, 50)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", ["none", "heads"])
@pytest.mark.parametrize("tq,tk", [(160, 160), (160, 32)])
def test_attention_core_plain_long_matches_jax(tq, tk, bias_kind, rate):
    rng = np.random.default_rng(91)
    b, h, d, seed = 2, 2, 8, 2468
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d), (b, h, tq, d)))
    bias = core_bias(bias_kind, rng, h, tq, tk)
    jbias = None if bias is None else jnp.asarray(bias)
    want = np.asarray(jax_core.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              jbias, seed, rate, 128, True))
    tbias = None if bias is None else t(bias)
    got = tac.attention_core_plain(t(q), t(k), t(v), tbias, seed, rate)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    wgrads = jax_core_vjp(q, k, v, bias, g, seed, rate)
    ggrads = tac.attention_core_backward_plain(t(q), t(k), t(v), tbias, seed, t(g), rate,
                                               need_dbias=bias is not None)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), ggrads, wgrads):
        assert_grad_close(a, w, name)
    # the wrapper on CPU tensors takes the plain versions, through autograd too
    ins = [t(x).requires_grad_() for x in (q, k, v)]
    out = tac.attention_core(*ins, tbias, seed, rate)
    np.testing.assert_array_equal(out.detach().numpy(), got.numpy())
    for name, a, w in zip("qkv", torch.autograd.grad(out, ins, t(g)), ggrads):
        torch.testing.assert_close(a, w, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("tq,tk", [(160, 160), (160, 32), (32, 160), (33, 10)])
def test_routes_name_the_long_route(dtype, tq, tk):
    assert tac.kernel_route(dtype, 8, tq, tk, 66) == "long"
    assert tac.backward_route(dtype, 8, tq, tk, 66) == "long"


@pytest.mark.parametrize("dtype,tq,tk,d,fwd,bwd", [
    (BF, 10, 10, 66, "mma", "mma"), (BF, 32, 32, 66, "mma", "mma"),
    (BF, 10, 2, 66, "mma", "mma"), (F32, 32, 32, 66, "fma", "fma"),
    (BF, 32, 32, 128, "mma", "fma"), (BF, 32, 32, 100, "mma", "mma")])
def test_short_routes_unchanged_at_32_tokens(dtype, tq, tk, d, fwd, bwd):
    assert tac.kernel_route(dtype, 8, tq, tk, d) == fwd
    assert tac.backward_route(dtype, 8, tq, tk, d) == bwd


@pytest.mark.parametrize("tq,tk,d", [(161, 160, 66), (160, 161, 66), (160, 160, 81),
                                     (33, 33, 128)])
def test_routes_raise_past_the_long_route(tq, tk, d):
    for route in (tac.kernel_route, tac.backward_route):
        with pytest.raises(ValueError, match="Tq, Tk <= 160 with D <= 80"):
            route(BF, 8, tq, tk, d)
