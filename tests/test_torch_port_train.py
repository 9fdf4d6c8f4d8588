"""The port's FAR training step against the JAX package's, on the CPU.

(d) losses (``vptr_tpu_torch.losses`` vs ``vptr_tpu.losses``) and the
    optimizer (``train/optim.py`` vs the ``optax`` chain of
    ``vptr_tpu.losses.build_optimizer``) over 5 steps, for ``mu_dtype``
    float32 and bfloat16, with and without clipping;
(e) DropPath / Dropout: identity in eval, keep ~ 1 - rate with x / keep
    scaling, reproducible from the generator;
(f) one FAR train step against ``vptr_tpu.train.steps.make_far_train_step``
    with dropout = drop_path = 0 (the ``tests/test_train_parity.py``
    protocol), on the fused, fused_residual and unfused routes: the losses,
    every transformer gradient leaf (the JAX side's exact gradients come out
    of a probe optimizer that stores them in its state; the port's
    ``.grad`` is mapped through ``export_jax_variables``) and the parameters
    after one clip -> AdamW update, mu_dtype float32 and bfloat16.

Tolerances (f32, both packages): losses 1e-6 absolute (means of O(1)
values); gradients 1e-5 relative to the largest gradient of the leaf plus
1e-9 absolute (f32 summation-order differences through two layers, the
decoder and the kernels' weight sums); optimizer states and parameters
2e-6 absolute (updates are about lr = 1e-4; for a bf16 first moment a
rounding that flips by one bf16 ulp moves a parameter by less than that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vptr_tpu import losses as jlosses
from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu.train.state import ModuleState, Stage2TrainState
from vptr_tpu.train.steps import make_far_train_step as jmake_far_train_step
from vptr_tpu_torch import losses as tlosses
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.layers import Dropout, DropPath
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_far_train_state
from vptr_tpu_torch.train.steps import make_far_eval_step, make_far_train_step
from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

from _torch_port_util import randomize, small_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)


def _frames(rng, n=2, tt=3):
    return rng.uniform(0, 1, (n, tt, 64, 64, 1)).astype(np.float32)


# ---------------------------------------------------------------- (d) losses

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("alpha", [1.0, 2.0])
def test_losses_match_jax(weighted, alpha):
    rng = np.random.default_rng(20)
    gt = rng.uniform(0, 1, (2, 5, 8, 8, 3)).astype(np.float32)
    pred = rng.uniform(0, 1, (2, 5, 8, 8, 3)).astype(np.float32)
    jw = jlosses.temporal_weight(5) if weighted else None
    tw = tlosses.temporal_weight(5) if weighted else None
    if weighted:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    pairs = [
        (jlosses.mse_loss(gt, pred, jw), tlosses.mse_loss(t(gt), t(pred), tw)),
        (jlosses.l1_loss(gt, pred, jw), tlosses.l1_loss(t(gt), t(pred), tw)),
        (jlosses.mse_loss(gt, pred, jw, norm_axis=-1),
         tlosses.mse_loss(t(gt), t(pred), tw, norm_axis=-1)),
        (jlosses.gdl_loss(gt, pred, alpha, jw),
         tlosses.gdl_loss(t(gt), t(pred), alpha, tw)),
    ]
    for want, got in pairs:
        assert abs(float(got) - float(want)) <= 1e-6


def test_temporal_weight_and_noam_match_jax():
    for n in (1, 2, 19):
        np.testing.assert_array_equal(tlosses.temporal_weight(n).numpy(),
                                      np.asarray(jlosses.temporal_weight(n)))
    js = jlosses.noam_schedule(528, 2.0, 4000)
    ts = tlosses.noam_schedule(528, 2.0, 4000)
    for count in (0, 1, 7, 3999, 4000, 12345):
        assert float(ts(count)) == pytest.approx(float(js(count)), rel=1e-6)


# ------------------------------------------------------------- (d) optimizer

def _opt_cfgs(mu_dtype, max_grad_norm, schedule="constant", optimizer="adamw"):
    jc, tc = small_cfgs()
    over = {"optim": {"mu_dtype": mu_dtype, "max_grad_norm": max_grad_norm,
                      "schedule": schedule, "optimizer": optimizer}}
    return jc.override(over).optim, tc.override(over).optim


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["clip", "no_clip", "noam_adam"])
def test_optimizer_matches_optax(mu_dtype, case):
    jcfg, tcfg = _opt_cfgs(mu_dtype, None if case == "no_clip" else 1.0,
                           "noam" if case == "noam_adam" else "constant",
                           "adam" if case == "noam_adam" else "adamw")
    rng = np.random.default_rng(21)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    jopt = jlosses.build_optimizer(jcfg, 48)
    topt = build_optimizer(tcfg, 48)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = {"a": t(params["a"]), "b.c": t(params["b"]["c"])}
    tstate = topt.init(tp)
    for i in range(5):
        # grads of global norm ~0.3 and ~3 alternate: clipping on and off
        s = 0.1 if i % 2 == 0 else 1.0
        g = {"a": s * rng.standard_normal((6, 5)).astype(np.float32),
             "b": {"c": s * rng.standard_normal((7,)).astype(np.float32)}}
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate, norm = topt.update(
            {"a": t(g["a"]), "b.c": t(g["b"]["c"])}, tstate, tp)
        for k in tupd:
            tp[k] = tp[k] + tupd[k]
        want_norm = float(optax.global_norm(g))
        assert float(norm) == pytest.approx(want_norm, rel=1e-6)
        np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                                   atol=2e-6, rtol=0)
        np.testing.assert_allclose(tp["b.c"].numpy(), np.asarray(jp["b"]["c"]),
                                   atol=2e-6, rtol=0)
    adam_state = jstate[-1][0] if case != "no_clip" else jstate[0]
    mu = adam_state.mu
    assert tstate.mu["a"].dtype == getattr(torch, mu_dtype)
    np.testing.assert_allclose(tstate.mu["a"].float().numpy(),
                               np.asarray(mu["a"]).astype(np.float32),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(tstate.nu["b.c"].numpy(),
                               np.asarray(adam_state.nu["b"]["c"]),
                               rtol=1e-6, atol=0)


# ----------------------------------------------------------- (e) regularisers

@pytest.mark.parametrize("module", ["droppath", "dropout"])
def test_regularisers(module):
    rate = 0.25
    m = DropPath(rate) if module == "droppath" else Dropout(rate)
    x = torch.ones(4000, 3, 5)
    assert m.eval()(x) is x                  # identity in eval
    m.train()
    y1 = m(x, torch.Generator().manual_seed(9))
    y2 = m(x, torch.Generator().manual_seed(9))
    assert torch.equal(y1, y2)               # reproducible from the generator
    kept = y1 != 0
    assert set(torch.unique(y1).tolist()) == {0.0, float(np.float32(1) / np.float32(1 - rate))}
    if module == "droppath":                 # whole samples
        assert bool((kept == kept[:, :1, :1]).all())
    assert abs(kept.float().mean().item() - (1.0 - rate)) < 0.02
    with pytest.raises(ValueError, match="generator"):
        m(x)


# -------------------------------------------------------- (f) one FAR step

ROUTES = {"fused": dict(fused_attention=True, fused_full=True),
          "fused_residual": dict(fused_attention=True, fused_full=True,
                                 fused_residual=True),
          "unfused": dict(fused_attention=False, fused_full=False)}


def _grad_probe():
    """optax transformation whose state becomes the gradients it is given
    (and whose updates are zero): the JAX step's exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _leaf_errors(got, want):
    bad = []

    def check(path, g, w):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        tol = 1e-5 * np.abs(w).max() + 1e-9
        err = np.abs(g - w).max()
        if not err <= tol:
            bad.append(f"{jax.tree_util.keystr(path)}: {err:.3e} > {tol:.3e}")
    jax.tree_util.tree_map_with_path(check, got, want)
    return bad


@pytest.mark.parametrize("route", list(ROUTES))
def test_far_train_step_matches_jax(route):
    check_far_train_step(ROUTES[route], weighted=route == "fused")


def check_far_train_step(flags, weighted):
    """One FAR step of both packages on the transformer route ``flags``
    (``temporal_weight`` on when ``weighted``): losses, every gradient
    leaf, the parameters after clip -> AdamW for both moment dtypes."""
    over = {"transformer": dict(dropout=0.0, drop_path=0.0, **flags),
            "loss": {"temporal_weight": weighted}}
    jc, tc = small_cfgs()
    jc, tc = jc.override(over), tc.override(over)
    rng = np.random.default_rng(22)
    frames = _frames(rng, 2, 6)
    past, future = frames[:, :3], frames[:, 3:]

    jenc, jdec = jbuild_ae(jc.ae)
    ev = randomize(jenc.init(jax.random.PRNGKey(0), jnp.asarray(frames)), rng)
    feats = jenc.apply(ev, jnp.asarray(frames[:, :5]))
    dv = randomize(jdec.init(jax.random.PRNGKey(1), feats), rng)
    jtr = jbuild_tr(jc.transformer)
    tv = randomize(jtr.init(jax.random.PRNGKey(2), feats), rng)
    jstate = Stage2TrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
        transformer=ModuleState.from_variables(tv),
        t_opt=_grad_probe().init(tv["params"]),
        enc=ModuleState.from_variables(ev), dec=ModuleState.from_variables(dv),
        disc=None, d_opt=None)
    jstep = jax.jit(jmake_far_train_step(jenc, jdec, jtr, None, _grad_probe(),
                                         None, jc.loss))
    jnew, jm = jstep(jstate, jnp.asarray(past), jnp.asarray(future))
    jgrads = jnew.t_opt

    enc, dec = build_autoencoder(tc.ae, device="cpu")
    load_jax_variables(enc, ev)
    load_jax_variables(dec, dv)
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"), tv)
    results = {}
    for mu_dtype in ("float32", "bfloat16"):
        ocfg = tc.override({"optim": {"mu_dtype": mu_dtype}}).optim
        opt = build_optimizer(ocfg, tc.transformer.d_model)
        state = create_far_train_state(enc, dec, tr, opt, seed=0).clone()
        step = make_far_train_step(enc, dec, state.transformer, opt, tc.loss)
        state, m = step(state, t(past), t(future))
        results[mu_dtype] = (state, m)
        # the JAX optimizer on the JAX gradients
        jopt = jlosses.build_optimizer(
            jc.override({"optim": {"mu_dtype": mu_dtype}}).optim, 48)
        upd, _ = jopt.update(jgrads, jopt.init(tv["params"]), tv["params"])
        want = optax.apply_updates(tv["params"], upd)
        got = export_jax_variables(state.transformer)["params"]
        jax.tree_util.tree_map_with_path(
            lambda p, g, w: np.testing.assert_allclose(
                g, np.asarray(w), atol=2e-6, rtol=0,
                err_msg=jax.tree_util.keystr(p)), got, want)

    state, m = results["float32"]
    for k in ("T_MSE", "T_GDL", "T_total"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-6, k
    assert float(m["T_gan"]) == 0.0 == float(jm["T_gan"])
    tgrads = export_jax_variables(
        state.transformer,
        {n: p.grad for n, p in state.transformer.named_parameters()})["params"]
    assert jax.tree.structure(tgrads) == jax.tree.structure(jgrads)
    assert _leaf_errors(tgrads, jgrads) == []
    assert float(m["grad_norm"]) == pytest.approx(
        float(optax.global_norm(jgrads)), rel=1e-5)


def test_far_train_step_with_dropout_runs_and_repeats():
    """Train mode at the preset's rates (attention dropout, block dropout,
    DropPath 0.1): finite losses, and a cloned state replays the same step
    exactly (every draw comes from the state's generator)."""
    _, tc = small_cfgs()
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    tr = build_transformer(tc.transformer, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    state = create_far_train_state(enc, dec, tr, opt, seed=5)
    twin = state.clone()
    step = make_far_train_step(enc, dec, tr, opt, tc.loss)
    frames = t(_frames(np.random.default_rng(23), 2, 6))
    s1, m1 = step(state, frames[:, :3], frames[:, 3:])
    s2, m2 = step(twin, frames[:, :3], frames[:, 3:])
    assert s1.step == s2.step == 1
    assert all(bool(torch.isfinite(v)) for v in m1.values())
    assert float(m1["T_total"]) == float(m2["T_total"])
    for (n, a), b in zip(s1.transformer.named_parameters(),
                         s2.transformer.parameters()):
        assert torch.equal(a, b), n
    metrics, pred = make_far_eval_step(enc, dec, tr, tc.loss)(
        s1, frames[:, :3], frames[:, 3:])
    assert pred.shape == (2, 5, 64, 64, 1)
    assert set(metrics) == {"T_MSE", "T_GDL", "T_total"}


def test_far_train_step_refuses_later_slices():
    """No route of a later slice is left: sequence_parallel, refused until
    it was ported, builds, and in one process (no model axis) its forward
    is the one without it, bit for bit (its mesh steps:
    test_torch_port_tp.py); remat, refused until it was ported, builds and
    trains (its step against remat off: test_torch_port_remat.py)."""
    _, tc = small_cfgs()
    sp = build_transformer(tc.override({"transformer": {"sequence_parallel": True}})
                           .transformer, device="cpu")
    feats = t(np.random.default_rng(29).standard_normal((2, 3, 8, 8, 48)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(sp(feats), build_transformer(tc.transformer, device="cpu")(feats))
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    tr = build_transformer(tc.override({"transformer": {"remat": True}}).transformer,
                           device="cpu")
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    state = create_far_train_state(enc, dec, tr, opt, seed=5)
    frames = t(_frames(np.random.default_rng(23), 2, 6))
    state, m = make_far_train_step(enc, dec, tr, opt, tc.loss, remat_decoder=True)(
        state, frames[:, :3], frames[:, 3:])
    assert tr.remat and state.step == 1
    assert all(bool(torch.isfinite(v)) for v in m.values())
