"""The port's NAR training and eval steps against the JAX package's, on the
CPU.

(o) one NAR train step against ``vptr_tpu.train.steps.make_nar_train_step``
    at dropout = drop_path = 0 (the ``tests/test_train_parity.py``
    protocol) with the preset's loss (MSE + GDL + 0.1 BiPatchNCE at
    temperature 1.0), on the fused route with the temporal weight: the
    losses (``T_MSE``, ``T_GDL``, ``T_bpc``, ``T_total``), every
    transformer gradient leaf (``rpe_table``, ``frame_queries`` and
    ``nce_fc*`` included; the JAX side's exact gradients come out of a
    probe optimizer that stores them in its state), the parameters after
    one clip -> AdamW update and the BatchNorm running statistics after the
    step (the unfused route, Tp != Tf and the eval step:
    ``test_torch_port_nar_train_routes.py``);
(p) a train step at the preset's dropout rates runs, and a cloned state
    (BatchNorm statistics included) replays it exactly.

nar_mnist cut to d 48, 4 heads, 2 + 2 layers, Tp = Tf = 3, AE ngf 8; f32.
Tolerances: losses 1e-6 absolute as the FAR step tests (2e-6 for the
total, a sum of three); gradients 1e-5 relative to the largest gradient of
the leaf plus 1e-8 absolute -- the FAR tests' floor is 1e-9, but here the
first encoder block's conv-FFN leaves sit behind a train-mode BatchNorm
that cancels most of their gradient (largest magnitudes ~1e-4), so they
carry the f32 error of the larger gradients upstream (~5e-9 measured);
parameters 2e-6 absolute (2 lr where the exact gradient is 0, see
``check_train_step``); batch statistics 1e-5 absolute (means over
2 x 3 x 64 rows of O(1) values).
"""

from functools import partial

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
from vptr_tpu.train.steps import make_nar_train_step as jmake_nar_train_step
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_nar_train_state
from vptr_tpu_torch.train.steps import make_nar_train_step
from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

from _torch_port_util import random_variables, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ROUTES = {"fused": dict(fused_attention=True, fused_full=True),
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
        tol = 1e-5 * np.abs(w).max() + 1e-8
        err = np.abs(g - w).max()
        if not err <= tol:
            bad.append(f"{jax.tree_util.keystr(path)}: {err:.3e} > {tol:.3e}")
    jax.tree_util.tree_map_with_path(check, got, want)
    return bad


def _setup(route, past, seed=80, weighted=False, preset="nar_mnist"):
    """``route``: a name of ROUTES or a dict of transformer flags;
    ``preset``: the NAR preset whose geometry (frame size, latent grid)
    the SMALL widths keep."""
    flags = ROUTES[route] if isinstance(route, str) else route
    over = dict(dropout=0.0, drop_path=0.0, **flags)
    jc, tc = small_nar_cfgs(past, 3, preset, **over)
    jc = jc.override({"loss": {"temporal_weight": weighted}})
    tc = tc.override({"loss": {"temporal_weight": weighted}})
    rng = np.random.default_rng(seed)
    size, h, w = tc.data.img_size, tc.transformer.enc_h, tc.transformer.enc_w
    frames = rng.uniform(0, 1, (2, past + 3, size, size, 1)).astype(np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    feats = np.zeros((2, past, h, w, 48), np.float32)
    ev = random_variables(jenc.init, rng, frames)
    dv = random_variables(jdec.init, rng, feats)
    jtr = jbuild_tr(jc.transformer)
    tv = random_variables(partial(jtr.init, method="init_all"), rng, feats)
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    load_jax_variables(enc, ev)
    load_jax_variables(dec, dv)
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"), tv)
    return dict(jc=jc, tc=tc, jmods=(jenc, jdec, jtr), jvars=(ev, dv, tv),
                port=(enc, dec, tr), past=frames[:, :past],
                future=frames[:, past:])


def _jax_state(jvars, opt):
    ev, dv, tv = jvars
    return Stage2TrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
        transformer=ModuleState.from_variables(tv),
        t_opt=jax.jit(opt.init)(tv["params"]),
        enc=ModuleState.from_variables(ev), dec=ModuleState.from_variables(dv),
        disc=None, d_opt=None)


def _min_neighbour_gap(pred: torch.Tensor) -> float:
    """Smallest |difference| of neighbouring pixels of the frames."""
    return min(float((pred[..., 1:, :, :] - pred[..., :-1, :, :]).abs().min()),
               float((pred[..., :, 1:, :] - pred[..., :, :-1, :]).abs().min()))


def _vector_errors(got, want, tol):
    """The gradient tree as one vector: its relative L2 error, and every
    leaf's largest error against ``tol`` times the tree's largest
    gradient."""
    g, w = ([np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]
            for tree in (got, want))
    flat_g, flat_w = np.concatenate([a.ravel() for a in g]), np.concatenate([a.ravel() for a in w])
    rel = np.linalg.norm(flat_g - flat_w) / np.linalg.norm(flat_w)
    bad = [] if rel <= tol else [f"relative L2 error {rel:.3e} > {tol:.1e}"]
    bound = tol * np.abs(flat_w).max()
    return bad + [f"leaf {i}: {np.abs(a - b).max():.3e} > {bound:.3e}"
                  for i, (a, b) in enumerate(zip(g, w)) if np.abs(a - b).max() > bound]


def check_train_step(route, past, weighted, seed=80, remat_decoder=False,
                     preset="nar_mnist", grad_tol=None, stats_atol=1e-5):
    """One step of both packages from one set of weights (the module
    notes); ``seed`` draws the weights and frames; ``remat_decoder``
    checkpoints both steps' decoder; ``preset`` as :func:`_setup`;
    ``grad_tol``: hold the gradients as one vector (:func:`_vector_errors`,
    and the gradient norm within that relative tolerance) instead of leaf
    by leaf; ``stats_atol``: the BatchNorm statistics' tolerance."""
    s = _setup(route, past, seed=seed, weighted=weighted, preset=preset)
    jc, tc = s["jc"], s["tc"]
    (jenc, jdec, jtr), tv = s["jmods"], s["jvars"][2]
    jstep = jax.jit(jmake_nar_train_step(jenc, jdec, jtr, None, _grad_probe(),
                                         None, jc.loss, remat_decoder=remat_decoder))
    jnew, jm = jstep(_jax_state(s["jvars"], _grad_probe()),
                     jnp.asarray(s["past"]), jnp.asarray(s["future"]))
    jgrads = jnew.t_opt

    enc, dec, tr = s["port"]
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    state = create_nar_train_state(enc, dec, tr, opt, seed=0).clone()
    # GDL takes |differences| of neighbouring predicted pixels; |x| has no
    # derivative at 0, so where two neighbours tie (within the packages'
    # ~1e-7 forward difference) their gradients differ by a whole 1/N.
    # Random-init predictions are nearly flat (about 0.49 to 0.56, an f32
    # spacing of 6e-8) and tie often: the seed is one where they do not
    probe = state.clone().transformer.train()
    with torch.no_grad():
        gap = _min_neighbour_gap(dec(probe(enc(t(s["past"])))))
    assert gap >= 1e-7, f"seed {seed}: neighbouring predicted pixels tie ({gap})"
    step = make_nar_train_step(enc, dec, state.transformer, opt, tc.loss,
                               remat_decoder=remat_decoder)
    state, m = step(state, t(s["past"]), t(s["future"]))

    for k in ("T_MSE", "T_GDL", "T_bpc"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-6, k
    assert abs(float(m["T_total"]) - float(jm["T_total"])) <= 2e-6
    assert float(m["T_gan"]) == 0.0 == float(jm["T_gan"])
    tgrads = export_jax_variables(
        state.transformer,
        {n: p.grad for n, p in state.transformer.named_parameters()})["params"]
    assert jax.tree.structure(tgrads) == jax.tree.structure(jgrads)
    bad = (_leaf_errors(tgrads, jgrads) if grad_tol is None
           else _vector_errors(tgrads, jgrads, grad_tol))
    assert not bad, "\n".join(bad)
    assert float(m["grad_norm"]) == pytest.approx(
        float(jax.jit(optax.global_norm)(jgrads)), rel=grad_tol or 1e-5)

    # the JAX optimizer on the JAX gradients, against the port's update
    # (jitted: eager, each of the hundreds of leaves compiles its own ops)
    jopt = jlosses.build_optimizer(jc.optim, 48)

    @jax.jit
    def jax_update(grads, params):
        upd, _ = jopt.update(grads, jopt.init(params), params)
        return optax.apply_updates(params, upd)

    want = jax_update(jgrads, tv["params"])
    got = export_jax_variables(state.transformer)
    lr = jc.optim.lr

    def check_param(path, g, w, grad):
        # Adam divides each gradient element by its own magnitude: where
        # the exact gradient is 0 -- a direction a train-mode BatchNorm
        # cancels (the biases before it, norm2's shift) -- both packages
        # step by up to lr on f32 noise, so there the bound is 2 lr
        err = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        tol = np.where(np.abs(np.asarray(grad)) < 1e-6, 2 * lr, 2e-6)
        assert (err <= tol).all(), (jax.tree_util.keystr(path), err.max())
    jax.tree_util.tree_map_with_path(check_param, got["params"], want, jgrads)
    jax.tree_util.tree_map_with_path(
        lambda p, g, w: np.testing.assert_allclose(
            g, np.asarray(w), atol=stats_atol, rtol=0,
            err_msg=jax.tree_util.keystr(p)),
        got["batch_stats"], jnew.transformer.stats)
    # the statistics moved: the step ran the BatchNorms in train mode
    assert not np.allclose(got["batch_stats"]["enc_block0"]["spatial_ffn"]
                           ["norm1"]["mean"],
                           tv["batch_stats"]["enc_block0"]["spatial_ffn"]
                           ["norm1"]["mean"])


def test_nar_train_step_matches_jax():
    check_train_step("fused", 3, weighted=True)


def test_nar_train_step_with_dropout_runs_and_repeats():
    """Train mode at the preset's rates (attention dropout, block dropout,
    DropPath 0.1) on seeded random weights: finite losses and gradient
    norm, and a cloned state replays the same step exactly, parameters and
    BatchNorm statistics alike."""
    s = _setup("fused", 3, seed=82)
    enc, dec, _ = s["port"]
    _, tc = small_nar_cfgs()                  # the preset's dropout rates
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"),
                            s["jvars"][2])
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    state = create_nar_train_state(enc, dec, tr, opt, seed=5)
    twin = state.clone()
    step = make_nar_train_step(enc, dec, tr, opt, tc.loss)
    frames = t(np.concatenate([s["past"], s["future"]], axis=1))
    s1, m1 = step(state, frames[:, :3], frames[:, 3:])
    s2, m2 = step(twin, frames[:, :3], frames[:, 3:])
    assert s1.step == s2.step == 1
    assert all(bool(torch.isfinite(v)) for v in m1.values())
    assert float(m1["T_bpc"]) > 0.0
    assert float(m1["T_total"]) == float(m2["T_total"])
    b1, b2 = s1.transformer.state_dict(), s2.transformer.state_dict()
    for n in b1:
        assert torch.equal(b1[n], b2[n]), n
    assert not torch.equal(b1["enc_block0.spatial_ffn.norm1.running_mean"],
                           torch.zeros_like(b1["enc_block0.spatial_ffn.norm1.running_mean"]))
