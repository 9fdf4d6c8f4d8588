"""The port's ops against the JAX package's, on the CPU.

(a) ``attention_core`` (its plain version: the wrapper takes it for CPU
    tensors) vs ``vptr_tpu.ops.attention_core.attention_core`` in Pallas
    interpret mode: square causal, per-head bias, rectangular; also with
    q, k, v as the (B, H, T, D) view of a (B, T, H*D) tensor (the layer's
    projections); ``kernel_route``, ``backward_route`` and ``layout``, pure
    functions of the shapes and strides.
(b) ``fused_attention_ln`` / ``_res`` vs the JAX functions (interpret mode),
    with and without the position table.
(c) window ops and position tables, exactly.
Dropout and the backwards: ``test_torch_port_dropout.py``,
``test_torch_port_backward.py``.

Tolerances: f32 everywhere; 1e-5 absolute covers summation-order
differences between XLA's and torch's f32 dot products at these widths
(values O(1), sums of <= 48 products). The CUDA kernels are held against
the same plain versions on the card by ``tests/test_torch_port_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.models import position as jpos
from vptr_tpu.ops import attention_core as jac
from vptr_tpu.ops import fused_window_attention as jfw
from vptr_tpu.ops import window as jwin
from vptr_tpu_torch.models import position as tpos
from vptr_tpu_torch.ops import attention_core as tac
from vptr_tpu_torch.ops import fused_window_attention as tfw
from vptr_tpu_torch.ops import window as twin

from _torch_port_util import heads_view, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5


def _causal(n):
    return np.triu(np.full((n, n), -1e30, np.float32), k=1)[None]


@pytest.mark.parametrize("case", ["square_causal", "per_head_bias",
                                  "rectangular", "no_bias"])
def test_attention_core_matches_jax(case):
    rng = np.random.default_rng(1)
    b, h, tq, tk, d = 6, 4, 7, 7, 12
    bias = None
    if case == "square_causal":
        bias = _causal(tq)
    elif case == "per_head_bias":
        bias = rng.standard_normal((h, tq, tk)).astype(np.float32)
    elif case == "rectangular":
        tk = 5
        bias = rng.standard_normal((1, tq, tk)).astype(np.float32)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    want = jac.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if bias is None else jnp.asarray(bias),
                              0, 0.0, 128, True)
    got = tac.attention_core(t(q), t(k), t(v),
                             None if bias is None else t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("tq,tk,bias_heads", [
    (7, 7, 0), (7, 7, 1), (7, 7, 4), (7, 5, 1), (5, 9, 4), (10, 2, 0)])
def test_attention_core_strided_matches_jax(tq, tk, bias_heads):
    """q, k, v in the projections' layout (the layer passes them so, with
    no copies): the same values as JAX's contiguous operands give."""
    rng = np.random.default_rng(2)
    b, h, d = 6, 4, 12
    bias = (None if bias_heads == 0 else
            rng.standard_normal((bias_heads, tq, tk)).astype(np.float32))
    if bias_heads == 1 and tq == tk:
        bias = _causal(tq)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
    views = [heads_view(x) for x in (q, k, v)]
    assert [tac.layout(x) for x in views] == [1, 1, 1]
    want = jac.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if bias is None else jnp.asarray(bias),
                              0, 0.0, 128, True)
    got = tac.attention_core(*views, None if bias is None else t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,heads,tq,tk,d,want", [
    (BF, 8, 20, 20, 66, "mma"),      # far_rip's temporal attention
    (BF, 8, 19, 19, 66, "mma"),      # the FAR step's
    (BF, 8, 10, 10, 66, "mma"),      # nar_mnist's
    (BF, 8, 10, 2, 66, "mma"),       # nar_bair's cross attention
    (BF, 8, 32, 32, 128, "mma"),     # 196,608 B of q, k, v: fits
    (BF, 8, 20, 20, 33, "mma"),      # odd head width, whole 16-byte slices
    (F32, 8, 20, 20, 66, "fma"),     # f32 takes the FMA kernel
    (BF, 1, 7, 7, 33, "fma"),        # a 231-element slice: not whole vectors
    (BF, 4, 10, 3, 3, "fma"),        # k's 36-element slice: not whole vectors
    (BF, 16, 32, 32, 128, "fma"),    # 393,216 B: over a block's shared memory
])
def test_kernel_route(dtype, heads, tq, tk, d, want):
    assert tac.kernel_route(dtype, heads, tq, tk, d) == want


@pytest.mark.parametrize("tq,tk,d", [(161, 20, 66), (20, 161, 66), (20, 20, 129)])
def test_kernel_route_refuses_what_no_kernel_takes(tq, tk, d):
    with pytest.raises(ValueError, match="Tq, Tk <= 32"):
        tac.kernel_route(BF, 8, tq, tk, d)


@pytest.mark.parametrize("dtype,heads,tq,tk,d,want", [
    (BF, 8, 19, 19, 66, "mma"),      # the FAR step's temporal attention
    (BF, 8, 10, 10, 66, "mma"),      # the NAR step's
    (BF, 8, 10, 20, 66, "mma"),      # rectangular
    (BF, 8, 10, 2, 66, "mma"),       # nar_bair's cross attention
    (BF, 8, 20, 20, 33, "mma"),      # odd head width, whole 16-byte slices
    (BF, 8, 32, 32, 96, "mma"),      # 196,608 B of q, k, v, g: fits
    (BF, 8, 32, 32, 128, "fma"),     # 262,144 B: over a block's shared memory
    (F32, 8, 19, 19, 66, "fma"),     # f32 takes the FMA kernel
    (BF, 1, 7, 7, 33, "fma"),        # a 231-element slice: not whole vectors
    (BF, 4, 10, 3, 3, "fma"),        # k's 36-element slice: not whole vectors
])
def test_backward_route(dtype, heads, tq, tk, d, want):
    assert tac.backward_route(dtype, heads, tq, tk, d) == want


@pytest.mark.parametrize("tq,tk,d", [(161, 19, 66), (19, 161, 66), (19, 19, 129)])
def test_backward_route_refuses_what_no_kernel_takes(tq, tk, d):
    with pytest.raises(ValueError, match="Tq, Tk <= 32"):
        tac.backward_route(BF, 8, tq, tk, d)


def test_layout_of_the_operands():
    x = torch.zeros(2, 3, 5, 4)
    assert tac.layout(x) == 0
    assert tac.layout(x.transpose(1, 2).contiguous().transpose(1, 2)) == 1
    assert tac.layout(x.transpose(2, 3)) is None
    assert tac.layout(torch.zeros(2, 5, 1, 4).transpose(1, 2)) == 0   # H = 1


def _ln_inputs(rng, bw=5, l=16, c=48):
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    ws = [f(c, c, scale=c ** -0.5) for _ in range(4)]
    bs = [f(c, scale=0.1) for _ in range(4)]
    return dict(x=f(bw, l, c), w=ws, b=bs, ls=1.0 + f(c, scale=0.1),
                lb=f(c, scale=0.1), pos=f(l, c))


# tokens 10 and 20: the attention pass's one- and two-tile query counts
# (the NAR and FAR folded temporal sublayers), beside the window's 16
@pytest.mark.parametrize("with_pos,tokens", [
    pytest.param(True, 16, id="True"), pytest.param(False, 16, id="False"),
    pytest.param(True, 10, id="True-10"), pytest.param(False, 10, id="False-10"),
    pytest.param(True, 20, id="True-20"), pytest.param(False, 20, id="False-20")])
@pytest.mark.parametrize("res", [False, True])
def test_fused_attention_ln_matches_jax(with_pos, tokens, res):
    rng = np.random.default_rng(2)
    a = _ln_inputs(rng, l=tokens)
    heads = 4
    bias = _causal(tokens)        # exercise the bias operand too
    scale = np.array([1.0, 0.0, 2.0, 1.0, 0.5], np.float32)
    pos = a["pos"] if with_pos else None
    (wq, wk, wv, wo), (bq, bk, bv, bo) = a["w"], a["b"]
    jargs = [jnp.asarray(z) for z in (a["x"], wq, bq, wk, bk, wv, bv, wo, bo,
                                      a["ls"], a["lb"])]
    targs = [t(z) for z in (a["x"], wq, bq, wk, bk, wv, bv, wo, bo,
                            a["ls"], a["lb"])]
    jp = None if pos is None else jnp.asarray(pos)
    tp = None if pos is None else t(pos)
    if res:
        want = jfw.fused_attention_ln_res(*jargs, jp, jnp.asarray(bias),
                                          jnp.asarray(scale), 0, heads, 0.0,
                                          64, True)
        got = tfw.fused_attention_ln_res(*targs, tp, t(bias), t(scale),
                                         num_heads=heads)
    else:
        want = jfw.fused_attention_ln(*jargs, jp, jnp.asarray(bias), 0, heads,
                                      0.0, 64, True)
        got = tfw.fused_attention_ln(*targs, tp, t(bias), num_heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("hw", [(8, 8), (6, 10)])
def test_window_ops_match_jax(hw):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2,) + hw + (5,)).astype(np.float32)
    jx, offs = jwin.pad_to_window(jnp.asarray(x), 4)
    tx, toffs = twin.pad_to_window(t(x), 4)
    assert toffs == offs
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    jw = jwin.window_partition(jx, 4)
    tw = twin.window_partition(tx, 4)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = twin.window_reverse(tw, 4, tuple(tx.shape[1:3]))
    np.testing.assert_array_equal(
        twin.unpad_from_window(back, hw, toffs).numpy(), x)


@pytest.mark.parametrize("normalize", [False, True])
def test_position_tables_match_jax(normalize):
    np.testing.assert_array_equal(
        tpos.position_embedding_1d(20, 48, normalize=normalize).numpy(),
        np.asarray(jpos.position_embedding_1d(20, 48, normalize=normalize)))
    np.testing.assert_array_equal(
        tpos.position_embedding_2d(4, 4, 528, normalize=normalize).numpy(),
        np.asarray(jpos.position_embedding_2d(4, 4, 528, normalize=normalize)))


def test_library_name_covers_headers(tmp_path, monkeypatch):
    """An edit of a shared csrc/*.cuh header renames (so rebuilds) every
    library, as an edit of the source does."""
    from vptr_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first
    (tmp_path / "h.cuh").write_text("// v1\n")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    assert _build.library_path("k") != first
