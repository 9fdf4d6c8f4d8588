"""The NAR slice's operators against the JAX package's, on the CPU.

(h) ``fused_attention`` (kernel #5's wrapper; on CPU tensors its plain
    forward and backward) against ``vptr_tpu.ops.fused_window_attention.
    fused_attention`` in Pallas interpret mode: the forward and every
    gradient of ``jax.vjp`` (dx_qk, dx_v, dW, db, dbias), with no bias, an
    (H, L, L) and a (1, L, L) bias, dropout 0 and 0.1 under one seed
    (masks bit-equal), a ragged window count (5 windows in tiles of 4) and
    the padded L = 19; the plain backward against autograd through the
    plain forward;
(i) ``relative_position_index`` and the RPE window attention (the bias
    gather and the ``rpe_table`` gradient), against ``vptr_tpu.models.
    layers``;
(j) the BatchNorm conv FFN (``MlpDWBN(norm="batch")``) in train mode
    (output, both running statistics after the call, the input and
    parameter gradients) and in eval mode;
(k) ``bi_patch_nce`` and ``l2_normalize_channels``: value and gradients.

Tolerances (f32): forwards 1e-5 absolute (O(1) outputs of 48-long
products); gradients 1e-5 times the larger of 1 and the gradient's largest
magnitude (summation order over 5 windows or the batch); the BatchNorm
FFN 1e-4 absolute (three f32 normalisations of 192 channels over 128
samples; XLA and torch reduce in another order) and its running
statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu import losses as jlosses
from vptr_tpu.models import layers as jlayers
from vptr_tpu.ops import fused_window_attention as jfw
from vptr_tpu_torch import losses as tlosses
from vptr_tpu_torch.models import layers as tlayers
from vptr_tpu_torch.ops import fused_window_attention as tfw
from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

from _torch_port_util import randomize, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

NAMES = ("dx_qk", "dx_v", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo",
         "dbo", "dbias")


def assert_grad_close(got, want, name, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want).max()
    assert err <= bound, f"{name}: max |err| {err:.3e} > {bound:.3e}"


def _two_stream_args(rng, bw, l, c=48):
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    ws = [f(c, c, scale=c ** -0.5) for _ in range(4)]
    bs = [f(c, scale=0.1) for _ in range(4)]
    x_v = f(bw, l, c)
    return [x_v + f(bw, l, c, scale=0.5), x_v, ws[0], bs[0], ws[1], bs[1],
            ws[2], bs[2], ws[3], bs[3]]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", ["head_bias_16", "one_bias_16", "no_bias_16",
                                  "head_bias_19"])
def test_fused_attention_matches_jax(case, rate):
    rng = np.random.default_rng(60)
    heads, seed, bw = 4, 777, 5
    l = 19 if case.endswith("19") else 16
    args = _two_stream_args(rng, bw, l)
    bias = None
    if not case.startswith("no_bias"):
        nb = heads if case.startswith("head") else 1
        bias = rng.standard_normal((nb, l, l)).astype(np.float32)
    g = rng.standard_normal((bw, l, 48)).astype(np.float32)
    diff = args + ([bias] if bias is not None else [])

    def jf(*a):
        b = a[10] if bias is not None else None
        # block_windows 4 over 5 windows: a ragged last tile
        return jfw.fused_attention(*a[:10], b, seed, heads, rate, 4, True, 4)

    want_out, vjp = jax.vjp(jf, *map(jnp.asarray, diff))
    want = vjp(jnp.asarray(g))
    tp = [t(a).requires_grad_() for a in diff]
    out = tfw.fused_attention(*tp[:10], tp[10] if bias is not None else None,
                              seed, heads, rate)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=0)
    out.backward(t(g))
    for name, a, w in zip(NAMES, tp, want):
        assert_grad_close(a.grad, w, name)


def test_fused_attention_dropout_mask_matches_jax():
    """The plain version's keep mask (the kernels' hash, indexed over the
    padded token count) is the Pallas kernel's, bit for bit."""
    seed, bw, heads, rate = 31, 6, 4, 0.25
    for l, dtype in ((16, torch.float32), (19, torch.float32),
                     (16, torch.bfloat16), (19, torch.bfloat16)):
        lp = -(-l // (16 if dtype == torch.bfloat16 else 8)) * (
            16 if dtype == torch.bfloat16 else 8)
        got = tfw.window_keep_mask(seed, bw, heads, l, rate, dtype).numpy()
        for h in range(heads):
            want = np.asarray(jfw._keep_mask_head(
                jnp.uint32(seed), 0, h, bw, lp, heads, rate))[:, :l, :l]
            np.testing.assert_array_equal(got[:, h], want)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_attention_plain_backward_matches_autograd(rate):
    rng = np.random.default_rng(61)
    args = [t(a).requires_grad_() for a in _two_stream_args(rng, 5, 16)]
    bias = t(rng.standard_normal((4, 16, 16))).requires_grad_()
    g = t(rng.standard_normal((5, 16, 48)))
    out = tfw.fused_attention_plain(*args, bias, 9, 4, rate)
    want = torch.autograd.grad(out, args[:2] + args[2:] + [bias], g)
    got = tfw.fused_attention_backward_plain(
        *[a.detach() for a in args], bias.detach(), 9, g, 4, rate)
    for name, a, w in zip(NAMES, got, want):
        assert_grad_close(a, w.numpy(), name)


def test_relative_position_index_matches_jax():
    for w in (2, 3, 4, 7):
        np.testing.assert_array_equal(tlayers.relative_position_index(w),
                                      jlayers.relative_position_index(w))


@pytest.mark.parametrize("fused", [True, False])
def test_rpe_window_attention_matches_jax(fused):
    """The RPE window attention with a separate value (the NAR decoder's
    sublayer): fused -> kernel #5's wrapper; unfused -> projections and the
    plain attention. Output, the gradients of x and value, and the
    ``rpe_table`` gradient (through the one-hot gather)."""
    rng = np.random.default_rng(62)
    x = rng.standard_normal((2, 2, 8, 8, 48)).astype(np.float32)
    value = rng.standard_normal((2, 2, 8, 8, 48)).astype(np.float32)
    g = rng.standard_normal((2, 2, 8, 8, 48)).astype(np.float32)
    pos2d = np.zeros((4, 4, 48), np.float32)     # unused under RPE
    jm = jlayers.WindowAttention(48, 4, 4, rpe=True, fused=fused,
                                 fused_full=fused)
    jv = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), pos2d,
                           value=jnp.asarray(value)), rng)

    def jf(params, x, value):
        return jm.apply({"params": params}, x, pos2d, value=value)

    want_out, vjp = jax.vjp(jf, jv["params"], jnp.asarray(x), jnp.asarray(value))
    want_params, want_dx, want_dv = vjp(jnp.asarray(g))

    tm = tlayers.WindowAttention(48, 4, 4, fused, fused, rpe=True)
    load_jax_variables(tm, jv)
    tx, tv = t(x).requires_grad_(), t(value).requires_grad_()
    out = tm(tx, t(pos2d).reshape(16, 48), value=tv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        tm.rpe_bias().detach().numpy(),
        np.asarray(jv["params"]["rpe_table"])[
            jlayers.relative_position_index(4).reshape(-1)].reshape(
                16, 16, 4).transpose(2, 0, 1))
    out.backward(t(g))
    assert_grad_close(tx.grad, want_dx, "dx")
    assert_grad_close(tv.grad, want_dv, "dvalue")
    got = export_jax_variables(tm, {n: p.grad for n, p in tm.named_parameters()})
    jax.tree_util.tree_map_with_path(
        lambda path, a, w: assert_grad_close(a, w, jax.tree_util.keystr(path)),
        got["params"], want_params)


def test_batchnorm_conv_ffn_matches_jax():
    rng = np.random.default_rng(63)
    x = rng.standard_normal((2, 4, 8, 8, 48)).astype(np.float32)
    g = rng.standard_normal((2, 4, 8, 8, 48)).astype(np.float32)
    jm = jlayers.MlpDWBN(48, 192, norm="batch")
    jv = randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)

    def jtrain(params, x):
        return jm.apply({"params": params, "batch_stats": jv["batch_stats"]}, x,
                        train=True, mutable=["batch_stats"])

    want, vjp = jax.vjp(lambda p, x: jtrain(p, x)[0], jv["params"], jnp.asarray(x))
    _, new_vars = jtrain(jv["params"], jnp.asarray(x))
    want_params, want_dx = vjp(jnp.asarray(g))

    tm = tlayers.MlpDWBN(48, 192, 8, 8, norm="batch")
    load_jax_variables(tm, jv)
    tm.train()
    tx = t(x).requires_grad_()
    out = tm(tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    stats = export_jax_variables(tm)["batch_stats"]
    jax.tree_util.tree_map_with_path(
        lambda path, a, w: np.testing.assert_allclose(
            a, np.asarray(w), atol=1e-5, rtol=0,
            err_msg=jax.tree_util.keystr(path)),
        stats, jax.tree.map(np.asarray, new_vars["batch_stats"]))
    out.backward(t(g))
    assert_grad_close(tx.grad, want_dx, "dx", tol=1e-4)
    got = export_jax_variables(tm, {n: p.grad for n, p in tm.named_parameters()})
    jax.tree_util.tree_map_with_path(
        lambda path, a, w: assert_grad_close(a, w, jax.tree_util.keystr(path),
                                             tol=1e-4),
        got["params"], want_params)

    # eval mode: the running statistics (the updated ones)
    want_eval = jm.apply({"params": jv["params"],
                          "batch_stats": new_vars["batch_stats"]},
                         jnp.asarray(x), train=False)
    with torch.inference_mode():
        got_eval = tm.eval()(t(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("temperature", [1.0, 0.07])
def test_bi_patch_nce_matches_jax(temperature):
    rng = np.random.default_rng(64)
    gt = rng.standard_normal((2, 3, 4, 4, 16)).astype(np.float32)
    pred = rng.standard_normal((2, 3, 4, 4, 16)).astype(np.float32)

    def jloss(gt, pred):
        return jlosses.bi_patch_nce(jlosses.l2_normalize_channels(gt),
                                    jlosses.l2_normalize_channels(pred),
                                    temperature)

    want, (want_dgt, want_dpred) = jax.value_and_grad(jloss, (0, 1))(
        jnp.asarray(gt), jnp.asarray(pred))
    tg, tpr = t(gt).requires_grad_(), t(pred).requires_grad_()
    got = tlosses.bi_patch_nce(tlosses.l2_normalize_channels(tg),
                               tlosses.l2_normalize_channels(tpr), temperature)
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    got.backward()
    assert_grad_close(tg.grad, want_dgt, "dgt")
    assert_grad_close(tpr.grad, want_dpred, "dpred")
