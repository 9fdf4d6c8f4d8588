"""Kernels #1/#3, #5/#6 and #2/#4 on a head subset (tensor parallelism),
through their plain versions on the CPU (what the wrappers take for CPU
tensors), against the whole call and the JAX package.

(a) ``attention_core``, ``fused_attention_ln`` and ``fused_attention`` (and
    their backwards) on heads h0 .. h0 + Hl - 1 of 8 (h0 0 and 4 of 4
    heads; 2 heads from 0, an inner width of 2 x 6 = 12), dropout 0.1:
    the subset's dropout masks are the global call's rows of those heads,
    bit for bit (``dropout_keep_mask`` / ``window_keep_mask`` with
    ``mask_heads`` / ``head0``), so #2/#4 on a subset equal the whole
    call's slice of those heads exactly (the heads are independent; the
    bias gradient, a sum over the batch, within 1e-5);
(b) #1's and #5's two halves (4 + 4 heads, bo added once) and their input
    gradients summed equal the whole call, in f32 within 1e-5, and their
    weight gradients are the whole call's slices;
(c) the whole calls against the JAX package's Pallas kernels in interpret
    mode at the same seed (1e-5);
(d) ``kernel_route`` and ``backward_route`` of #1/#3 name a route at the
    inner widths of far_mnist's d_model 528 over model 2 and 4 (Cl 264:
    "wgmma"; Cl 132, not a multiple of 8: "fma" in bf16).
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

from _torch_port_util import t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

H, HD, RATE, SEED = 8, 6, 0.1, 1234
C = H * HD
SUBSETS = [(4, 0), (4, 4), (2, 0)]        # (heads, first head) of 8
ATOL = 1e-5


def _rng(n):
    return np.random.default_rng(n)


def _window_ops(two: bool, rng, bw=6, l=16):
    """(x or x_qk, x_v), wq, bq, wk, bk, wv, bv, wo, bo [, ls, lb, pos] as
    f32 tensors; the RPE-like bias (8, L, L)."""
    n = lambda *s, std=1.0: t((rng.standard_normal(s) * std).astype(np.float32))
    xs = (n(bw, l, C),) + ((n(bw, l, C),) if two else ())
    wb = []
    for _ in range(4):
        wb += [n(C, C, std=C ** -0.5), n(C, std=0.1)]
    extra = () if two else ((1 + n(C, std=0.1)), n(C, std=0.1), n(l, C, std=0.5))
    return xs + tuple(wb) + tuple(extra), n(H, l, l, std=0.5)


def _subset(ops, two, hl, h0):
    """The subset's operands: Wq/Wk/Wv columns and biases, Wo rows, bo 0."""
    n_in = 2 if two else 1
    xs, (wq, bq, wk, bk, wv, bv, wo, bo), rest = ops[:n_in], ops[n_in:n_in + 8], ops[n_in + 8:]
    cols = slice(h0 * HD, (h0 + hl) * HD)
    return xs + (wq[:, cols], bq[cols], wk[:, cols], bk[cols], wv[:, cols], bv[cols],
                 wo[cols], torch.zeros_like(bo)) + rest


@pytest.mark.parametrize("hl,h0", SUBSETS)
def test_subset_masks_are_the_global_calls(hl, h0):
    """(a) the masks: the subset's rows of the global call's, bit for bit,
    in both index spaces (the core's and the window kernels' padded one)."""
    whole = tdrop.dropout_keep_mask(SEED, 5, H, 7, RATE, 9)
    got = tdrop.dropout_keep_mask(SEED, 5, hl, 7, RATE, 9, mask_heads=H, head0=h0)
    assert torch.equal(got, whole[:, h0:h0 + hl])
    for dt in (torch.float32, torch.bfloat16):
        whole = tdrop.window_keep_mask(SEED, 5, H, 13, RATE, dt)
        got = tdrop.window_keep_mask(SEED, 5, hl, 13, RATE, dt, mask_heads=H, head0=h0)
        assert torch.equal(got, whole[:, h0:h0 + hl])
    with pytest.raises(ValueError, match="not heads of"):
        tdrop.dropout_keep_mask(SEED, 5, hl, 7, RATE, mask_heads=H, head0=H - hl + 1)


@pytest.mark.parametrize("hl,h0", SUBSETS)
@pytest.mark.parametrize("bias_kind", ["causal", "heads"])
def test_attention_core_subset_is_the_whole_calls_slice(hl, h0, bias_kind):
    """(a) #2/#4: the subset's output and gradients (dbias of a per-head
    bias too) are the whole call's slices of those heads, exactly."""
    rng = _rng(1)
    b, tq = 6, 7
    q, k, v, g = (t(rng.standard_normal((b, H, tq, HD)).astype(np.float32)) for _ in range(4))
    bias = (t(np.triu(np.full((tq, tq), -1e30, np.float32), 1)[None]) if bias_kind == "causal"
            else t(rng.standard_normal((H, tq, tq)).astype(np.float32)))
    need = bias_kind == "heads"
    whole = tac.attention_core_plain(q, k, v, bias, SEED, RATE)
    wgrads = tac.attention_core_backward_plain(q, k, v, bias, SEED, g, RATE, need)
    sl = slice(h0, h0 + hl)
    sb = bias[sl] if need else bias
    got = tac.attention_core(q[:, sl], k[:, sl], v[:, sl], sb, SEED, RATE, H, h0)
    assert torch.equal(got, whole[:, sl])
    grads = tac.attention_core_backward(q[:, sl], k[:, sl], v[:, sl], sb, SEED, g[:, sl],
                                        RATE, need, H, h0)
    for a, w in zip(grads[:3], wgrads[:3]):
        assert torch.equal(a, w[:, sl])
    if need:    # a sum over the batch, whose order torch picks by the shape
        torch.testing.assert_close(grads[3], wgrads[3][sl], atol=ATOL, rtol=0)


def _ln_fwd(ops, bias, hl=H, h0=0):
    kw = {} if hl == H else dict(mask_heads=H, head0=h0)
    return tfw.fused_attention_ln_plain(*ops, bias, SEED, hl, RATE, **kw)


def _ln_bwd(ops, bias, g, hl=H, h0=0):
    kw = {} if hl == H else dict(mask_heads=H, head0=h0)
    return tfw.fused_attention_ln_backward_plain(*ops, bias, SEED, g, hl, RATE, None, False,
                                                 bias is not None, **kw)


def _two_fwd(ops, bias, hl=H, h0=0):
    kw = {} if hl == H else dict(mask_heads=H, head0=h0)
    return tfw.fused_attention_plain(*ops, bias, SEED, hl, RATE, **kw)


def _two_bwd(ops, bias, g, hl=H, h0=0):
    kw = {} if hl == H else dict(mask_heads=H, head0=h0)
    return tfw.fused_attention_backward_plain(*ops, bias, SEED, g, hl, RATE,
                                              bias is not None, **kw)


@pytest.mark.parametrize("two", [False, True], ids=["ln_1_3", "two_stream_5_6"])
def test_window_halves_sum_to_the_whole_call(two):
    """(b) #1/#3 (LayerNorm folded, pos on q/k, no bias) and #5/#6 (two
    streams, the per-head bias): the two halves' outputs with bo added once
    and their input gradients (and dls, dlb) summed are the whole call's;
    the weight and bias gradients are its slices, dbo and dbias whole."""
    rng = _rng(2 if two else 3)
    ops, rpe = _window_ops(two, rng)
    bias = rpe if two else None
    g = t(rng.standard_normal(ops[0].shape).astype(np.float32))
    fwd, bwd = (_two_fwd, _two_bwd) if two else (_ln_fwd, _ln_bwd)
    whole, wg = fwd(ops, bias), bwd(ops, bias, g)
    n_in = 2 if two else 1
    bo = ops[n_in + 7]
    outs, grads = [], []
    for h0 in (0, 4):
        sub = _subset(ops, two, 4, h0)
        sb = None if bias is None else bias[h0:h0 + 4]
        outs.append(fwd(sub, sb, 4, h0))
        grads.append(bwd(sub, sb, g, 4, h0))
    torch.testing.assert_close(outs[0] + outs[1] + bo, whole, atol=ATOL, rtol=0)
    for i in range(n_in):                       # dx (dx_qk, dx_v)
        torch.testing.assert_close(grads[0][i] + grads[1][i], wg[i], atol=ATOL, rtol=0)
    if not two:                                 # dls, dlb: the halves' shares
        for i in (9, 10):
            torch.testing.assert_close(grads[0][i] + grads[1][i], wg[i], atol=ATOL, rtol=0)
    names = ("dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo")
    for j, name in enumerate(names):
        i = n_in + j
        for half, h0 in zip(grads, (0, 4)):
            cols = slice(h0 * HD, (h0 + 4) * HD)
            want = (wg[i] if name == "dbo" else wg[i][cols] if name in ("dwo", "dbq", "dbk",
                                                                            "dbv")
                    else wg[i][:, cols])
            torch.testing.assert_close(half[i], want, atol=ATOL, rtol=0, msg=name)
    if two:
        for half, h0 in zip(grads, (0, 4)):
            torch.testing.assert_close(half[-1], wg[-1][h0:h0 + 4], atol=ATOL, rtol=0)


@pytest.mark.parametrize("hl,h0", SUBSETS)
@pytest.mark.parametrize("two", [False, True], ids=["ln_1_3", "two_stream_5_6"])
def test_window_subset_wrappers_take_the_plain_versions(hl, h0, two):
    """The wrappers on CPU tensors (what the layer calls) are the plain
    versions on the subset, forward and through autograd."""
    rng = _rng(4)
    ops, rpe = _window_ops(two, rng)
    sub = [o.clone().requires_grad_() for o in _subset(ops, two, hl, h0)]
    bias = rpe[h0:h0 + hl] if two else None
    fn = tfw.fused_attention if two else tfw.fused_attention_ln
    out = fn(*sub, bias, SEED, hl, RATE, H, h0)
    want = (_two_fwd if two else _ln_fwd)(_subset(ops, two, hl, h0), bias, hl, h0)
    assert torch.equal(out, want)
    g = t(rng.standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    pg = (_two_bwd if two else _ln_bwd)(_subset(ops, two, hl, h0), bias, g, hl, h0)
    assert torch.equal(sub[0].grad, pg[0])


def test_whole_calls_match_jax():
    """(c) the whole calls the subsets sum to, against the JAX package's
    Pallas kernels in interpret mode at the same seed (f32)."""
    rng = _rng(5)
    j = lambda x: jnp.asarray(x.numpy())
    b, tq = 6, 7
    q, k, v = (rng.standard_normal((b, H, tq, HD)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, tq, tq)).astype(np.float32)
    want = jac.attention_core(*map(jnp.asarray, (q, k, v, bias)), SEED, RATE, 128, True)
    got = tac.attention_core(t(q), t(k), t(v), t(bias), SEED, RATE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    ops, _ = _window_ops(False, rng)
    want = jfw.fused_attention_ln(*map(j, ops), None, SEED, H, RATE, 4, True, 4)
    np.testing.assert_allclose(_ln_fwd(ops, None).numpy(), np.asarray(want), atol=ATOL)
    ops, rpe = _window_ops(True, rng)
    want = jfw.fused_attention(*map(j, ops), j(rpe), SEED, H, RATE, 4, True, 4)
    np.testing.assert_allclose(_two_fwd(ops, rpe).numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("model,want", [(1, "wgmma"), (2, "wgmma"), (4, "fma")])
def test_routes_at_the_inner_widths(model, want):
    """(d) far_mnist's d_model 528 over 8 heads of 66: Cl = 528 / model."""
    cl = 528 // model
    for tokens in (16, 19):
        assert tfw.kernel_route(tokens, 528, torch.bfloat16, inner=cl) == want
        assert tfw.backward_route(tokens, 528, torch.bfloat16, inner=cl) == want
        assert tfw.backward_route(tokens, 528, torch.bfloat16, False, inner=cl) == want
        assert tfw.kernel_route(tokens, 528, torch.float32, inner=cl) == "fma"
        assert tac.kernel_route(torch.bfloat16, 8 // model, tokens, tokens, 66) in ("mma",
                                                                                     "fma")
