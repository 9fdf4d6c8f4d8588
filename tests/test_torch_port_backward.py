"""The port's kernel backwards against the JAX package's, on the CPU.

(c) ``attention_core`` and ``fused_attention_ln`` / ``_res`` are
    ``torch.autograd.Function``s whose backward on CPU tensors is the plain
    backward (``attention_core_backward_plain``,
    ``fused_attention_ln_backward_plain``). Their gradients are held
    against ``jax.vjp`` of the JAX kernels (Pallas interpret mode): dq, dk,
    dv, dbias and dx, dW, db, dls, dlb, dbias, with dpos and dscale zero;
    with and without pos, per-head and (1, T, T) bias, rectangular
    attention, L = 16 and the padded L = 19, dropout 0 and 0.1 under one
    seed. The plain backward also matches autograd through the plain
    forward. The attention core's backward also on q, k, v and g in the
    attention layer's layout (the (B, H, T, D) view of a (B, T, H*D)
    tensor, ``heads_view``) and in mixed layouts, called alone and through
    autograd; and the gradients of ``MultiHeadAttention`` on its fused
    route (the core on ``heads()``'s views, passed on with no copy).

Tolerance (f32): 1e-5 times the larger of 1 and the largest magnitude of
each gradient. The gradients that sum over windows or the batch (dW, db,
dls, dlb, dbias) add up to 95 rows of products in another order than XLA
does; some of them are zero up to that rounding (dbk: a softmax does not
see a per-row shift of its logits), hence the floor of 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.ops import attention_core as jac
from vptr_tpu.ops import fused_window_attention as jfw
from vptr_tpu_torch.ops import attention_core as tac
from vptr_tpu_torch.ops import fused_window_attention as tfw

from _torch_port_util import (
    assert_grad_close,
    check_strided_core_backward,
    core_bias,
    random_variables,
    t,
)
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)


def _core_case(case, rng):
    b, h, tq, tk, d = 6, 4, 7, 7, 12
    if case == "rectangular":
        tk = 5
    if case == "causal":
        bias = np.triu(np.full((tq, tk), -1e30, np.float32), 1)[None]
    elif case == "no_bias":
        bias = None
    else:
        nb = h if case == "per_head_bias" else 1
        bias = rng.standard_normal((nb, tq, tk)).astype(np.float32)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d), (b, h, tq, d))]
    return arrs, bias


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", ["causal", "per_head_bias", "rectangular",
                                  "no_bias"])
def test_attention_core_backward_matches_jax(case, rate):
    rng = np.random.default_rng(40)
    (q, k, v, g), bias = _core_case(case, rng)
    seed = 4321
    if bias is None:
        f = lambda q, k, v: jac.attention_core(q, k, v, None, seed, rate, 128, True)
        prim = (q, k, v)
    else:
        f = lambda q, k, v, b: jac.attention_core(q, k, v, b, seed, rate, 128, True)
        prim = (q, k, v, bias)
    _, vjp = jax.vjp(f, *map(jnp.asarray, prim))
    want = vjp(jnp.asarray(g))
    tp = [t(a).requires_grad_() for a in prim]
    out = tac.attention_core(*tp[:3], tp[3] if bias is not None else None,
                             seed, rate)
    out.backward(t(g))
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), tp, want):
        assert_grad_close(a.grad, w, name)


def _window_args(rng, bw, l, c=48):
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    ws = [f(c, c, scale=c ** -0.5) for _ in range(4)]
    bs = [f(c, scale=0.1) for _ in range(4)]
    return [f(bw, l, c), ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
            1.0 + f(c, scale=0.1), f(c, scale=0.1)]


NAMES = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo", "dls",
         "dlb")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("case", ["pos_causal_16", "nopos_headbias_16",
                                  "pos_causal_19", "pos_headbias_19"])
def test_fused_attention_ln_backward_matches_jax(case, res, rate):
    rng = np.random.default_rng(41)
    heads, seed = 4, 2024
    l = 19 if case.endswith("19") else 16
    bw = 5
    args = _window_args(rng, bw, l)
    pos = rng.standard_normal((l, 48)).astype(np.float32) if "nopos" not in case else None
    if "causal" in case:
        bias = np.triu(np.full((l, l), -1e30, np.float32), 1)[None]
    else:
        bias = rng.standard_normal((heads, l, l)).astype(np.float32)
    scale = np.array([1.0, 0.0, 2.0, 1.0, 0.5], np.float32)
    g = rng.standard_normal((bw, l, 48)).astype(np.float32)

    diff = args + [bias] + ([pos] if pos is not None else [])

    def jf(*a):
        p = a[12] if pos is not None else None
        common = tuple(a[:11]) + (p, a[11])
        if res:
            return jfw.fused_attention_ln_res(*common, jnp.asarray(scale), seed,
                                              heads, rate, 64, True)
        return jfw.fused_attention_ln(*common, seed, heads, rate, 64, True)

    _, vjp = jax.vjp(jf, *map(jnp.asarray, diff))
    want = vjp(jnp.asarray(g))

    tp = [t(a).requires_grad_() for a in diff]
    tpos = tp[12] if pos is not None else None
    tscale = t(scale).requires_grad_()
    if res:
        out = tfw.fused_attention_ln_res(*tp[:11], tpos, tp[11], tscale, seed,
                                         num_heads=heads, dropout_rate=rate)
    else:
        out = tfw.fused_attention_ln(*tp[:11], tpos, tp[11], seed,
                                     num_heads=heads, dropout_rate=rate)
    out.backward(t(g))
    for name, a, w in zip(NAMES + ("dbias",), tp[:12], want[:12]):
        assert_grad_close(a.grad, w, name)
    if pos is not None:
        assert not tpos.grad.any() and not np.asarray(want[12]).any()   # dpos 0
    if res:
        assert not tscale.grad.any()                                     # dscale 0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("res", [False, True])
def test_window_plain_backward_matches_autograd(res, rate):
    """The explicit plain backward equals autograd through the plain
    forward (the same rounding points, so the same function)."""
    rng = np.random.default_rng(42)
    heads, l, bw = 4, 19, 5
    args = [t(a).requires_grad_() for a in _window_args(rng, bw, l)]
    pos = t(rng.standard_normal((l, 48)))
    bias = t(rng.standard_normal((1, l, l))).requires_grad_()
    scale = t(np.array([1.0, 0.0, 2.0, 1.0, 0.5], np.float32)) if res else None
    g = t(rng.standard_normal((bw, l, 48)))
    out = tfw.fused_attention_ln_plain(*args, pos, bias, 7, heads, rate, scale, res)
    want = torch.autograd.grad(out, args + [bias], g)
    got = tfw.fused_attention_ln_backward_plain(
        *[a.detach() for a in args], pos, bias.detach(), 7, g, heads, rate,
        scale, res)
    for name, a, w in zip(NAMES + ("dbias",), got, want):
        assert_grad_close(a, w.numpy(), name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_core_plain_backward_matches_autograd(rate):
    rng = np.random.default_rng(43)
    (q, k, v, g), bias = _core_case("per_head_bias", rng)
    tp = [t(a).requires_grad_() for a in (q, k, v, bias)]
    out = tac.attention_core_plain(*tp, 11, rate)
    want = torch.autograd.grad(out, tp, t(g))
    got = tac.attention_core_backward_plain(*[a.detach() for a in tp], 11, t(g),
                                            rate)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert_grad_close(a, w.numpy(), name)


@pytest.mark.parametrize("layouts", ["strided", "mixed"])
@pytest.mark.parametrize("tq,tk,bias_kind", [
    (19, 19, "none"), (19, 19, "causal"), (10, 20, "one"), (10, 20, "heads"),
    (10, 10, "heads"), (10, 10, "none")])
def test_attention_core_backward_strided_matches_jax(tq, tk, bias_kind, layouts):
    check_strided_core_backward(tq, tk, bias_kind, layouts, 0.0,
                                np.random.default_rng(44))


@pytest.mark.parametrize("bias_kind", ["none", "heads"])
def test_multi_head_attention_gradients_match_jax(bias_kind, monkeypatch):
    """Gradients through ``MultiHeadAttention(fused=True)`` (input, the four
    projections and the bias) equal JAX's; the core's backward gets q, k,
    v and g in the layer's layout, uncopied."""
    from vptr_tpu.models.layers import MultiHeadAttention as JMultiHeadAttention
    from vptr_tpu_torch.models.layers import MultiHeadAttention
    from vptr_tpu_torch.utils.weights import load_jax_variables

    rng = np.random.default_rng(45)
    c, h, l = 48, 4, 7
    x = rng.standard_normal((2, 3, l, c)).astype(np.float32)
    bias = None if bias_kind == "none" else core_bias("heads", rng, h, l, l)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jm = JMultiHeadAttention(c, h, fused=True)
    jb = None if bias is None else jnp.asarray(bias)
    variables = random_variables(
        lambda key, x: jm.init(key, x, x, x, bias=jb), rng, jnp.asarray(x))

    def f(params, x, *b):
        return jm.apply({"params": params}, x, x, x, bias=b[0] if b else None)

    prim = (variables["params"], jnp.asarray(x)) + (() if jb is None else (jb,))
    _, vjp = jax.vjp(f, *prim)
    want = vjp(jnp.asarray(g))

    seen = []
    real = tac.attention_core_backward

    def spy(q, k, v, bias, seed, g, *args):
        seen.append(tuple(tac.layout(z) for z in (q, k, v, g)))
        return real(q, k, v, bias, seed, g, *args)

    monkeypatch.setattr(tac, "attention_core_backward", spy)
    m = load_jax_variables(MultiHeadAttention(c, h, fused=True), variables)
    tx = t(x).requires_grad_()
    tb = None if bias is None else t(bias).requires_grad_()
    m(tx, tx, tx, bias=tb).backward(t(g))
    assert seen == [(1, 1, 1, 1)]
    assert_grad_close(tx.grad, want[1], "dx")
    if tb is not None:
        assert_grad_close(tb.grad, want[2], "dbias")
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        lin = getattr(m, name)
        assert_grad_close(lin.weight.grad.t(), want[0][name]["kernel"], name + " kernel")
        assert_grad_close(lin.bias.grad, want[0][name]["bias"], name + " bias")
