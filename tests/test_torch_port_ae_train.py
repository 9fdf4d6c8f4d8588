"""The port's stage-1 (AE/GAN) path against the JAX package's, on the CPU.

(q) ``gan_loss`` in its three modes;
(r) the autoencoder's norm -> ReLU (``_NormAct``) and the whole encoder and
    decoder in train and eval mode for norm batch, group, instance and none
    (GroupNorm at 528 channels: 33 groups), the running statistics after
    a train-mode forward; the PatchGAN discriminator; the weights' round
    trip (load -> export) for each;
(s) one AE train step against ``vptr_tpu.train.steps.make_ae_train_step``
    with the GAN term (ae_mnist's geometry, and ae_bair's 3 channels, zero
    padding and tanh; the first moment in f32 and bf16; and a group-norm
    AE with an instance-norm discriminator under lsgan): the seven
    losses, every G and D gradient leaf (the JAX side's come out of
    optimizers that record them, ``_torch_port_util.recording``), the
    parameters of the encoder, decoder and discriminator after one Adam
    step, and the running statistics of all three; the discriminator's
    statistics recomputed by hand through its three train-mode passes
    (fake, real, then the generator's with the updated parameters), as
    ``tests/test_gan_step.py`` does for the JAX step; the eval step;
(t) the residual blocks' dropout: the identity in eval mode, half kept
    and doubled in train mode, repeatable from the generator (the masks
    cannot match ``jax.random``'s).

ae_mnist cut as ``tests/test_gan_step.py::_tiny_gan_cfg`` (feat_dim 8,
one residual block, 32 x 32, batch 2, 2 + 2 frames), with ngf 8 and ndf 8;
f32. Tolerances: losses 2e-6 absolute; eval-mode outputs 1e-5 relative to
their largest magnitude; train-mode outputs 1e-4 relative, gradients 1e-4
relative to the leaf's largest plus 1e-8 absolute (a conv bias before a
GroupNorm has an exact gradient of 0, and both packages give it f32 noise
of the gradients upstream, ~1e-9), running statistics 1e-5 absolute. Train-mode BatchNorm takes the variance as E[x^2] - E[x]^2
(flax's arithmetic, which the port keeps), so the two packages' f32
summation orders differ by up to ~1e-5 at each BatchNorm's output, and the
gradients behind a train-mode BatchNorm are small differences of larger
terms (measured: up to 4.4e-5 relative). Parameters after Adam: within
the gradient tolerance carried through Adam's first step
(``_torch_port_util.adam_param_errors``: 2 lr where the gradient is
within its tolerance of 0, 2e-6 absolute plus Adam's derivative times it
elsewhere). Every ReLU and every |.| of the
GDL is a kink: where a value lies within the packages' ~1e-5 difference
of one, the two take different sides and a whole gradient term moves, so
the step tests first assert that the packages' ReLU masks and GDL signs
agree everywhere (:func:`_kink_flips`; the seeds are ones where they do).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vptr_tpu.config as jcfg
import vptr_tpu_torch.config as tcfg
from vptr_tpu import losses as jlosses
from vptr_tpu.models.autoencoder import _NormAct as JNormAct
from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.discriminator import build_discriminator as jbuild_disc
from vptr_tpu.train.state import AETrainState, ModuleState
from vptr_tpu.train.steps import make_ae_eval_step as jmake_ae_eval_step
from vptr_tpu.train.steps import make_ae_train_step as jmake_ae_train_step
from vptr_tpu_torch import losses as tlosses
from vptr_tpu_torch.models.autoencoder import _NormAct, build_autoencoder
from vptr_tpu_torch.models.discriminator import build_discriminator
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.steps import make_ae_eval_step, make_ae_train_step
from vptr_tpu_torch.utils.weights import (
    ae_train_state_from_jax,
    export_jax_variables,
    load_jax_variables,
)

from _torch_port_util import (
    adam_param_errors,
    leaf_errors,
    random_variables,
    randomize,
    recording,
    t,
)
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TINY = {"dtype": "float32", "ae": {"ngf": 8, "feat_dim": 8, "n_res_blocks": 1},
        "disc": {"ndf": 8},
        "data": {"batch_size": 2, "img_size": 32, "num_past_frames": 2,
                 "num_future_frames": 2}}
NORMS = ["batch", "group", "instance", "none"]


def tiny_cfgs(preset="ae_mnist", **over):
    """(JAX config, port config) of an ae_* preset cut to TINY; ``over``
    overrides more sections."""
    d = {**TINY, **{k: {**TINY.get(k, {}), **v} for k, v in over.items()}}
    return jcfg.get_preset(preset).override(d), tcfg.get_preset(preset).override(d)


def _frames(rng, cfg, n=2, tt=4):
    lo = -1.0 if cfg.ae.out_layer == "tanh" else 0.0
    return rng.uniform(lo, 1.0, (n, tt, 32, 32, cfg.ae.img_channels)).astype(np.float32)


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |err| {err:.3e} > {tol:.3e}"


def _assert_tree_close(got, want, atol):
    jax.tree_util.tree_map_with_path(
        lambda p, g, w: np.testing.assert_allclose(
            g, np.asarray(w), atol=atol, rtol=0, err_msg=jax.tree_util.keystr(p)),
        got, want)


# ------------------------------------------------------------ (q) gan_loss

@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "wgangp"])
def test_gan_loss_matches_jax(mode, real):
    logits = np.random.default_rng(30).standard_normal((6, 3, 3, 1)).astype(np.float32) * 3
    want = float(jlosses.gan_loss(jnp.asarray(logits), real, mode))
    got = tlosses.gan_loss(t(logits), real, mode)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6
    # bf16 logits are cast to f32 first
    half = t(logits).to(torch.bfloat16)
    assert float(tlosses.gan_loss(half, real, mode)) == float(
        tlosses.gan_loss(half.float(), real, mode))
    with pytest.raises(ValueError, match="gan mode"):
        tlosses.gan_loss(t(logits), real, "hinge")


# -------------------------------------------------- (r) norms, AE, D, weights

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("channels", [64, 528])
@pytest.mark.parametrize("norm", NORMS)
def test_norm_act_matches_jax(norm, channels, train):
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((4, 6, 6, channels)) * rng.uniform(0.1, 2, channels)
         + rng.uniform(-1, 1, channels)).astype(np.float32)
    jm = JNormAct(norm, jnp.float32)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    m = load_jax_variables(_NormAct(channels, norm, torch.float32), v).train(train)
    if norm == "group":        # groups of max(1, C // 32) channels
        assert m.GroupNorm_0.groups == {64: 32, 528: 33}[channels]
    if norm == "instance":
        assert m.GroupNorm_0.groups == channels
    want = jm.apply(v, jnp.asarray(x), train=train,
                    mutable=["batch_stats"] if train else False)
    want, stats = want if train else (want, None)
    got = m(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, 1e-5, "output")
    if train and norm == "batch":
        _assert_tree_close(export_jax_variables(m)["batch_stats"], stats["batch_stats"], 1e-5)


def _ae_pair(norm, rng, preset="ae_mnist"):
    jc, tc = tiny_cfgs(preset, ae={"norm": norm})
    x = _frames(rng, jc)
    jenc, jdec = jbuild_ae(jc.ae)
    ev = random_variables(jenc.init, rng, x)
    dv = random_variables(jdec.init, rng, np.zeros((2, 4, 4, 4, 8), np.float32))
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    return (jenc, jdec, ev, dv), (load_jax_variables(enc, ev), load_jax_variables(dec, dv)), x


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("norm", NORMS)
def test_autoencoder_matches_jax(norm, train):
    rng = np.random.default_rng(32)
    (jenc, jdec, ev, dv), (enc, dec), x = _ae_pair(norm, rng)
    mut = ["batch_stats"] if train and norm == "batch" else False
    jfeats = jenc.apply(ev, jnp.asarray(x), train=train, mutable=mut)
    jfeats, estats = jfeats if mut else (jfeats, None)
    jrec = jdec.apply(dv, jfeats, train=train, mutable=mut)
    jrec, dstats = jrec if mut else (jrec, None)
    enc.train(train), dec.train(train)
    with torch.no_grad():
        feats = enc(t(x))
        rec = dec(feats)
    rel = 1e-4 if train else 1e-5
    _close(feats, jfeats, rel, "features")
    _close(rec, jrec, rel, "frames")
    if mut:
        _assert_tree_close(export_jax_variables(enc)["batch_stats"],
                           estats["batch_stats"], 1e-5)
        _assert_tree_close(export_jax_variables(dec)["batch_stats"],
                           dstats["batch_stats"], 1e-5)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("norm", ["batch", "group", "instance"])
def test_discriminator_matches_jax(norm, train):
    jc, tc = tiny_cfgs(disc={"norm": norm, "ndf": 16})
    rng = np.random.default_rng(33)
    x = rng.uniform(0, 1, (6, 32, 32, 1)).astype(np.float32)
    jdisc = jbuild_disc(jc.disc)
    v = random_variables(jdisc.init, rng, x)
    disc = load_jax_variables(build_discriminator(tc.disc, device="cpu"), v).train(train)
    mut = ["batch_stats"] if train and norm == "batch" else False
    want = jdisc.apply(v, jnp.asarray(x), train=train, mutable=mut)
    want, stats = want if mut else (want, None)
    with torch.no_grad():
        got = disc(t(x))
    assert tuple(got.shape) == want.shape == (6, 2, 2, 1)
    _close(got, want, 1e-4 if train else 1e-5, "logits")
    if mut:
        _assert_tree_close(export_jax_variables(disc)["batch_stats"],
                           stats["batch_stats"], 1e-5)


@pytest.mark.parametrize("module", [f"ae-{n}" for n in NORMS]
                         + [f"disc-{n}" for n in ("batch", "group", "instance")])
def test_weights_round_trip(module):
    """load -> export gives the JAX tree back, leaf for leaf, for every norm
    (the AE's flax wrappers BatchNorm_0 / GroupNorm_0, the discriminator's
    norm{n} without one)."""
    kind, norm = module.split("-")
    jc, tc = tiny_cfgs(ae={"norm": norm}, **({"disc": {"norm": norm}} if kind == "disc" else {}))
    rng = np.random.default_rng(34)
    x = _frames(rng, jc)
    if kind == "ae":
        jenc, jdec = jbuild_ae(jc.ae)
        trees = [random_variables(jenc.init, rng, x),
                 random_variables(jdec.init, rng, np.zeros((2, 4, 4, 4, 8), np.float32))]
        mods = build_autoencoder(tc.ae, device="cpu")
    else:
        trees = [random_variables(jbuild_disc(jc.disc).init, rng, x[:, 0])]
        mods = (build_discriminator(tc.disc, device="cpu"),)
    for m, tree in zip(mods, trees):
        back = export_jax_variables(load_jax_variables(m, tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        jax.tree.map(np.testing.assert_array_equal, back, tree)


# ---------------------------------------------------------- (s) the AE step

def _ae_setup(preset, seed, **over):
    jc, tc = tiny_cfgs(preset, **over)
    rng = np.random.default_rng(seed)
    x = _frames(rng, jc)
    jenc, jdec = jbuild_ae(jc.ae)
    jdisc = jbuild_disc(jc.disc)
    ev = random_variables(jenc.init, rng, x)
    dv = random_variables(jdec.init, rng, np.zeros((2, 4, 4, 4, 8), np.float32))
    sv = random_variables(jdisc.init, rng, x[:, 0])
    return dict(jc=jc, tc=tc, x=x, jmods=(jenc, jdec, jdisc),
                jvars={"enc": ev, "dec": dv, "disc": sv})


def _port_state(s, mu_dtype="float32"):
    tc = s["tc"].override({"optim": {"mu_dtype": mu_dtype},
                           "optim_d": {"mu_dtype": mu_dtype}})
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    disc = build_discriminator(tc.disc, device="cpu")
    g_opt, d_opt = build_optimizer(tc.optim), build_optimizer(tc.optim_d)
    state = ae_train_state_from_jax(s["jvars"], enc, dec, disc, g_opt, d_opt)
    step = make_ae_train_step(enc, dec, disc, g_opt, d_opt, tc.loss)
    return state, step, tc


def _kink_flips(s, state) -> dict:
    """Where the packages' train-mode forwards take different sides of a
    kink: ReLU masks at every norm -> ReLU of the encoder and decoder, and
    the signs of the GDL's neighbour differences of the reconstruction
    (and of their distance to the input's)."""
    jenc, jdec, _ = s["jmods"]
    x = jnp.asarray(s["x"])
    feats, ei = jenc.apply(s["jvars"]["enc"], x, train=True, capture_intermediates=True,
                           mutable=["intermediates", "batch_stats"])
    jrec, di = jdec.apply(s["jvars"]["dec"], feats, train=True, capture_intermediates=True,
                          mutable=["intermediates", "batch_stats"])
    acts, hooks = {}, []
    enc, dec = copy.deepcopy(state.enc), copy.deepcopy(state.dec)
    for root, m, inter in (("enc", enc, ei), ("dec", dec, di)):
        for name, mod in m.named_modules():
            if isinstance(mod, _NormAct) and mod.act:
                hooks.append(mod.register_forward_hook(
                    lambda _m, _i, out, key=(root, name), inter=inter: acts.__setitem__(
                        key, (out.permute(0, 2, 3, 1).numpy(), inter, key[1]))))
    with torch.no_grad():
        rec = dec.train()(enc.train()(t(s["x"]))).numpy()
    flips = {}
    for (root, name), (out, inter, path) in acts.items():
        node = inter["intermediates"]
        for p in path.split("."):
            node = node[p]
        want = np.asarray(node["__call__"][0]).reshape(out.shape)
        flips[f"{root}.{name}"] = int(((out > 0) != (want > 0)).sum())

    def diffs(a):
        return (a[..., 1:, :, :] - a[..., :-1, :, :], a[..., :, 1:, :] - a[..., :, :-1, :])
    jrec = np.asarray(jrec)
    for axis, (g, p, w) in enumerate(zip(diffs(s["x"]), diffs(rec), diffs(jrec))):
        flips[f"gdl sign {axis}"] = int((np.sign(p) != np.sign(w)).sum())
        flips[f"gdl distance {axis}"] = int(
            (np.sign(np.abs(g) - np.abs(p)) != np.sign(np.abs(g) - np.abs(w))).sum())
    return flips


# (preset, first-moment dtype, seed, more overrides)
AE_CASES = {"mnist-f32": ("ae_mnist", "float32", 4, {}),
            "mnist-bf16": ("ae_mnist", "bfloat16", 4, {}),
            "bair-f32": ("ae_bair", "float32", 9, {}),
            "bair-bf16": ("ae_bair", "bfloat16", 9, {}),
            "mnist-group-lsgan": ("ae_mnist", "float32", 4,
                                  {"ae": {"norm": "group"}, "disc": {"norm": "instance"},
                                   "loss": {"gan_mode": "lsgan"}})}


@pytest.mark.parametrize("case", list(AE_CASES))
def test_ae_train_step_matches_jax(case):
    preset, mu_dtype, seed, over = AE_CASES[case]
    s = _ae_setup(preset, seed, **over)
    jc = s["jc"].override({"optim": {"mu_dtype": mu_dtype}, "optim_d": {"mu_dtype": mu_dtype}})
    jenc, jdec, jdisc = s["jmods"]
    v = s["jvars"]
    g_opt, d_opt = recording(jlosses.build_optimizer(jc.optim)), recording(
        jlosses.build_optimizer(jc.optim_d))
    jstate = AETrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
        enc=ModuleState.from_variables(v["enc"]), dec=ModuleState.from_variables(v["dec"]),
        disc=ModuleState.from_variables(v["disc"]),
        g_opt=g_opt.init((v["enc"]["params"], v["dec"]["params"])),
        d_opt=d_opt.init(v["disc"]["params"]))
    jstep = jax.jit(jmake_ae_train_step(jenc, jdec, jdisc, g_opt, d_opt, jc.loss))
    x = s["x"]
    jnew, jm = jstep(jstate, jnp.asarray(x[:, :2]), jnp.asarray(x[:, 2:]))

    state, step, tc = _port_state(s, mu_dtype)
    flips = _kink_flips(s, state)
    assert not any(flips.values()), f"seed {seed}: the packages cross a kink apart: {flips}"
    state, m = step(state, t(x[:, :2]), t(x[:, 2:]))
    assert state.step == 1
    for k in ("AE_MSE", "AE_GDL", "AEgan", "AE_total", "Dtotal", "Dfake", "Dreal"):
        assert abs(float(m[k]) - float(jm[k])) <= 2e-6, (k, float(m[k]), float(jm[k]))
    assert float(m["Dtotal"]) > 0

    (jeg, jdg), jsg = jnew.g_opt[1], jnew.d_opt[1]
    lrs = {"enc": tc.optim.lr, "dec": tc.optim.lr, "disc": tc.optim_d.lr}
    for name, module, grads, params, stats in (
            ("enc", state.enc, jeg, jnew.enc.params, jnew.enc.stats),
            ("dec", state.dec, jdg, jnew.dec.params, jnew.dec.stats),
            ("disc", state.disc, jsg, jnew.disc.params, jnew.disc.stats)):
        got = export_jax_variables(module, {n: p.grad for n, p in module.named_parameters()})
        assert jax.tree.structure(got["params"]) == jax.tree.structure(grads)
        assert leaf_errors(got["params"], grads, 1e-4, 1e-8) == [], name
        after = export_jax_variables(module)
        assert adam_param_errors(after["params"], params, grads, lrs[name], 1e-4,
                                 1e-8) == [], name
        _assert_tree_close(after.get("batch_stats", {}), stats, 1e-5)
        # the step moved every parameter and statistic
        assert all(not np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(after), jax.tree.leaves(s["jvars"][name]))), name


def _bn_stats_after(disc, frames):
    with torch.no_grad():
        disc.train()(frames)
    return export_jax_variables(disc)["batch_stats"]


def test_ae_step_disc_stats_update_three_times_sequentially():
    """The port's step leaves D's running statistics as three train-mode
    passes in turn leave them: fake with the old parameters, real from the
    statistics that pass left, then fake again with the updated parameters;
    skipping the middle pass gives other statistics."""
    s = _ae_setup("ae_mnist", 4)
    state, step, _ = _port_state(s)
    before = state.clone()
    x = t(s["x"])
    state, m = step(state, x[:, :2], x[:, 2:])
    with torch.no_grad():
        fake = before.dec.train()(before.enc.train()(x)).reshape(-1, 32, 32, 1)
    d0 = before.disc
    d1 = copy.deepcopy(state.disc)
    s1 = _bn_stats_after(copy.deepcopy(d0), fake)
    d_mid = copy.deepcopy(d0)
    _bn_stats_after(d_mid, fake)
    s2 = _bn_stats_after(d_mid, x.reshape(-1, 32, 32, 1))
    load_jax_variables(d1, {"params": export_jax_variables(state.disc)["params"],
                            "batch_stats": s2})
    s3 = _bn_stats_after(d1, fake)
    _assert_tree_close(export_jax_variables(state.disc)["batch_stats"], s3, 1e-6)
    d_wrong = copy.deepcopy(d1)
    load_jax_variables(d_wrong, {"params": export_jax_variables(state.disc)["params"],
                                 "batch_stats": s1})
    wrong = _bn_stats_after(d_wrong, fake)
    assert max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(wrong), jax.tree.leaves(export_jax_variables(state.disc)["batch_stats"]))) > 0


def test_ae_eval_step_matches_jax():
    """The eval step against JAX's (with the GAN term) on modules left in
    train mode: it sets eval mode itself, and changes no statistic."""
    s = _ae_setup("ae_mnist", 4)
    jenc, jdec, jdisc = s["jmods"]
    v = s["jvars"]
    jstate = AETrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
        enc=ModuleState.from_variables(v["enc"]), dec=ModuleState.from_variables(v["dec"]),
        disc=ModuleState.from_variables(v["disc"]), g_opt=None, d_opt=None)
    x = s["x"]
    jm, jrec = jmake_ae_eval_step(jenc, jdec, jdisc, s["jc"].loss)(
        jstate, jnp.asarray(x[:, :2]), jnp.asarray(x[:, 2:]))
    state, _, tc = _port_state(s)
    assert state.enc.training and state.disc.training
    stats = export_jax_variables(state.enc)["batch_stats"]
    m, rec = make_ae_eval_step(state.enc, state.dec, state.disc, tc.loss)(
        state, t(x[:, :2]), t(x[:, 2:]))
    assert set(m) == set(jm) == {"AE_MSE", "AE_GDL", "AEgan", "AE_total"}
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) <= 2e-6, k
    _close(rec, jrec, 1e-5, "frames")
    assert not (state.enc.training or state.dec.training or state.disc.training)
    jax.tree.map(np.testing.assert_array_equal, export_jax_variables(state.enc)["batch_stats"],
                 stats)


# ------------------------------------------------------------- (t) dropout

def test_ae_dropout():
    _, tc = tiny_cfgs(ae={"use_dropout": True})
    enc, _ = build_autoencoder(tc.ae, device="cpu", generator=torch.Generator().manual_seed(5))
    plain, _ = build_autoencoder(tc.override({"ae": {"use_dropout": False}}).ae, device="cpu",
                                 generator=torch.Generator().manual_seed(5))
    x = t(_frames(np.random.default_rng(35), tc))
    with torch.no_grad():
        assert torch.equal(enc.eval()(x), plain.eval()(x))    # identity in eval
        enc.train(), plain.train()
        y1 = enc(x, generator=torch.Generator().manual_seed(7))
        y2 = enc(x, generator=torch.Generator().manual_seed(7))
        y3 = enc(x, generator=torch.Generator().manual_seed(8))
        assert torch.equal(y1, y2) and not torch.equal(y1, y3)
        assert not torch.equal(y1, plain(x))
        drop = enc.encoder.res0.drop
        ones = torch.ones(200, 100)
        kept = drop(ones, torch.Generator().manual_seed(9))
        assert set(torch.unique(kept).tolist()) == {0.0, 2.0}
        assert abs((kept != 0).float().mean().item() - 0.5) < 0.02
        with pytest.raises(ValueError, match="generator"):
            enc(x)
