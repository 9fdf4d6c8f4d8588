"""The port's in-kernel dropout against the JAX package's, on the CPU.

(a) the counter-hash twin (``vptr_tpu_torch.ops.dropout``) is bit-equal to
    ``vptr_tpu.ops.attention_core``'s ``_hash_uniform`` / ``dropout_keep_mask``
    and to the window kernel's ``_keep_mask_head`` with its padded token
    count: square and rectangular shapes, seeds 0, 12345 and 2^31 - 2, an
    index past 2^24;
(b) the forwards with dropout 0.1 under one integer seed: ``attention_core``
    (also on operands in the layer's strided layout) and
    ``fused_attention_ln`` / ``_res`` (their plain versions: the wrappers
    take them for CPU tensors) against the JAX functions in Pallas interpret
    mode, atol 1e-5 (f32 summation order; the masks are equal);
(c) the attention core's backward with dropout 0.1 on q, k, v and g in the
    layer's layout and in mixed layouts, against ``jax.vjp`` of the JAX
    function (relative 1e-5, as ``test_torch_port_backward.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.ops import attention_core as jac
from vptr_tpu.ops import fused_window_attention as jfw
from vptr_tpu_torch.ops import attention_core as tac
from vptr_tpu_torch.ops import dropout as tdrop
from vptr_tpu_torch.ops import fused_window_attention as tfw

from _torch_port_util import check_strided_core_backward, heads_view, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5
SEEDS = [0, 12345, 2 ** 31 - 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(3, 4, 7, 7), (2, 8, 19, 19), (5, 2, 10, 20)])
def test_keep_mask_bit_equal(seed, shape):
    b, h, tq, tk = shape
    want = np.asarray(jac.dropout_keep_mask(seed, b, h, tq, 0.1, tk))
    got = tdrop.dropout_keep_mask(seed, b, h, tq, 0.1, tk).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.85 < got.mean() < 0.95


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_uniform_bit_equal_past_2_24(seed):
    idx = np.concatenate([np.arange(2 ** 24 - 4, 2 ** 24 + 4),
                          [2 ** 31 + 7, 2 ** 32 - 1]]).astype(np.uint32)
    want = np.asarray(jac._hash_uniform(jnp.asarray(idx), jnp.uint32(seed)))
    got = tdrop.hash_uniform(torch.from_numpy(idx.astype(np.int64)), seed)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tokens,dtype", [(16, torch.float32), (16, torch.bfloat16),
                                          (19, torch.float32), (19, torch.bfloat16)])
def test_window_mask_uses_padded_tokens(tokens, dtype):
    """The window kernel builds its mask after padding L to a sublane
    multiple (16 for bf16, 8 for f32): L = 19 indexes over 32 or 24."""
    lp = tdrop.padded_tokens(tokens, dtype)
    assert lp == {16: 16, 19: 32 if dtype == torch.bfloat16 else 24}[tokens]
    seed, bw, heads = 777, 6, 4
    got = tdrop.window_keep_mask(seed, bw, heads, tokens, 0.1, dtype).numpy()
    for h in range(heads):
        want = np.asarray(jfw._keep_mask_head(jnp.uint32(seed), 0, h, bw, lp,
                                              heads, 0.1))[:, :tokens, :tokens]
        np.testing.assert_array_equal(got[:, h], want)


@pytest.mark.parametrize("seed", [3, 2 ** 31 - 2])
@pytest.mark.parametrize("case", ["causal", "per_head_bias", "rectangular"])
def test_attention_core_dropout_matches_jax(seed, case):
    rng = np.random.default_rng(30)
    b, h, tq, tk, d = 6, 4, 7, 7, 12
    if case == "rectangular":
        tk = 5
    bias = (np.triu(np.full((tq, tk), -1e30, np.float32), 1)[None]
            if case == "causal" else
            rng.standard_normal((h if case == "per_head_bias" else 1, tq, tk))
            .astype(np.float32))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
    want = jac.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(bias), seed, 0.1, 128, True)
    got = tac.attention_core(t(q), t(k), t(v), t(bias), seed, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    no_drop = tac.attention_core(t(q), t(k), t(v), t(bias))
    assert not torch.allclose(got, no_drop)          # dropout did act


@pytest.mark.parametrize("seed", [3, 2 ** 31 - 2])
@pytest.mark.parametrize("tq,tk,bias_heads", [(7, 7, 1), (7, 5, 4), (10, 2, 0)])
def test_attention_core_strided_dropout_matches_jax(seed, tq, tk, bias_heads):
    """The layer's strided q, k, v with dropout 0.1: JAX's mask and values."""
    rng = np.random.default_rng(33)
    b, h, d = 6, 4, 12
    bias = None
    if bias_heads:
        bias = rng.standard_normal((bias_heads, tq, tk)).astype(np.float32)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
    want = jac.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if bias is None else jnp.asarray(bias),
                              seed, 0.1, 128, True)
    views = [heads_view(x) for x in (q, k, v)]
    tbias = None if bias is None else t(bias)
    got = tac.attention_core(*views, tbias, seed, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not torch.allclose(got, tac.attention_core(*views, tbias))  # dropout acted


def _ln_inputs(rng, bw, l, c=48):
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    ws = [f(c, c, scale=c ** -0.5) for _ in range(4)]
    bs = [f(c, scale=0.1) for _ in range(4)]
    return [f(bw, l, c), ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
            1.0 + f(c, scale=0.1), f(c, scale=0.1), f(l, c)]


@pytest.mark.parametrize("tokens", [16, 19, 10, 20])
@pytest.mark.parametrize("res", [False, True])
def test_fused_attention_ln_dropout_matches_jax(tokens, res):
    rng = np.random.default_rng(31)
    bw, heads, seed = 5, 4, 99
    args = _ln_inputs(rng, bw, tokens)
    bias = np.triu(np.full((tokens, tokens), -1e30, np.float32), 1)[None]
    scale = np.array([1.0, 0.0, 2.0, 1.0, 0.5], np.float32)
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(bias)]
    targs = [t(a) for a in args] + [t(bias)]
    if res:
        want = jfw.fused_attention_ln_res(*jargs, jnp.asarray(scale), seed,
                                          heads, 0.1, 64, True)
        got = tfw.fused_attention_ln_res(*targs, t(scale), seed,
                                         num_heads=heads, dropout_rate=0.1)
    else:
        want = jfw.fused_attention_ln(*jargs, seed, heads, 0.1, 64, True)
        got = tfw.fused_attention_ln(*targs, seed, num_heads=heads,
                                     dropout_rate=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_seed_as_device_tensor_equals_int_seed():
    """The model passes seeds as int32 tensors drawn on the device; the
    result equals the int seed's."""
    rng = np.random.default_rng(32)
    q, k, v = (t(rng.standard_normal((4, 2, 6, 8))) for _ in range(3))
    a = tac.attention_core(q, k, v, None, 12345, 0.1)
    b = tac.attention_core(q, k, v, None, torch.tensor([12345], dtype=torch.int32),
                           0.1)
    assert torch.equal(a, b)


@pytest.mark.parametrize("layouts", ["strided", "mixed"])
@pytest.mark.parametrize("tq,tk,bias_kind", [
    (19, 19, "causal"), (10, 20, "heads"), (10, 10, "none")])
def test_attention_core_backward_strided_dropout_matches_jax(tq, tk, bias_kind, layouts):
    check_strided_core_backward(tq, tk, bias_kind, layouts, 0.1,
                                np.random.default_rng(34))
