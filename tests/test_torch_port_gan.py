"""The GAN term of the port's FAR and NAR training steps against the JAX
package's, on the CPU.

One FAR step and one NAR step with ``loss.lam_gan = 0.01`` and the
PatchGAN discriminator (``disc=``, ``d_optimizer=``) against
``vptr_tpu.train.steps.make_far_train_step`` / ``make_nar_train_step`` with
their discriminator, dropout and DropPath 0, on the default route (the
kernels' plain versions on the CPU; the JAX side's Pallas kernels in
interpret mode): the losses (``T_gan`` and the D metrics included), every
transformer and discriminator gradient leaf (the JAX side's come out of
optimizers that record them), the parameters after the clip -> AdamW and
the discriminator's Adam step, and the discriminator's running statistics
after its three train-mode passes (fake: the whole prediction, real: the
future frames, then the generator's pass). The state's ``clone`` carries
the discriminator and its optimizer state.

far_mnist / nar_mnist cut as ``_torch_port_util.SMALL`` (NAR 2 + 2
layers), the discriminator at ndf 8; f32. Tolerances as the FAR and NAR
step tests: losses 2e-6 absolute; transformer gradients 1e-5 relative to
the leaf's largest plus 1e-8 absolute; the discriminator's 1e-4 relative
(train-mode BatchNorm, see ``test_torch_port_ae_train.py``); parameters
within the gradient tolerance carried through Adam's first step
(``_torch_port_util.adam_param_errors``: 2 lr where a gradient is within
its tolerance of 0, 2e-6 absolute plus Adam's derivative times it
elsewhere); statistics 1e-5 absolute.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu import losses as jlosses
from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.discriminator import build_discriminator as jbuild_disc
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu.train.state import ModuleState, Stage2TrainState
from vptr_tpu.train.steps import make_far_train_step as jmake_far_train_step
from vptr_tpu.train.steps import make_nar_train_step as jmake_nar_train_step
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.discriminator import build_discriminator
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_far_train_state
from vptr_tpu_torch.train.steps import make_far_train_step, make_nar_train_step
from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

from _torch_port_util import (
    adam_param_errors,
    leaf_errors,
    random_variables,
    recording,
    small_cfgs,
    small_nar_cfgs,
    t,
)
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

GAN = {"transformer": {"dropout": 0.0, "drop_path": 0.0},
       "loss": {"lam_gan": 0.01}, "disc": {"ndf": 8}}
STEPS = {"far": (jmake_far_train_step, make_far_train_step),
         "nar": (jmake_nar_train_step, make_nar_train_step)}


def _cfgs(kind):
    jc, tc = small_cfgs() if kind == "far" else small_nar_cfgs()
    over = {**GAN, "transformer": {**GAN["transformer"]}}
    return jc.override(over), tc.override(over)


@pytest.mark.parametrize("kind,seed", [("far", 40), ("nar", 41)])
def test_gan_step_matches_jax(kind, seed):
    jc, tc = _cfgs(kind)
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 1, (2, 6, 64, 64, 1)).astype(np.float32)
    past, future = frames[:, :3], frames[:, 3:]
    t_in = 5 if kind == "far" else 3                # the transformer's frames
    feats = np.zeros((2, t_in, 8, 8, 48), np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    jtr, jdisc = jbuild_tr(jc.transformer), jbuild_disc(jc.disc)
    ev = random_variables(jenc.init, rng, frames)
    dv = random_variables(jdec.init, rng, feats)
    init = jtr.init if kind == "far" else partial(jtr.init, method="init_all")
    tv = random_variables(init, rng, feats)
    sv = random_variables(jdisc.init, rng, frames[:, 0])
    t_opt = recording(jlosses.build_optimizer(jc.optim, 48))
    d_opt = recording(jlosses.build_optimizer(jc.optim_d))
    jstate = Stage2TrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
        transformer=ModuleState.from_variables(tv),
        t_opt=jax.jit(t_opt.init)(tv["params"]),
        enc=ModuleState.from_variables(ev), dec=ModuleState.from_variables(dv),
        disc=ModuleState.from_variables(sv), d_opt=d_opt.init(sv["params"]))
    jmake, make = STEPS[kind]
    jstep = jax.jit(jmake(jenc, jdec, jtr, jdisc, t_opt, d_opt, jc.loss))
    jnew, jm = jstep(jstate, jnp.asarray(past), jnp.asarray(future))

    enc, dec = build_autoencoder(tc.ae, device="cpu")
    load_jax_variables(enc, ev)
    load_jax_variables(dec, dv)
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"), tv)
    disc = load_jax_variables(build_discriminator(tc.disc, device="cpu"), sv)
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    d_optimizer = build_optimizer(tc.optim_d)
    state = create_far_train_state(enc, dec, tr, opt, seed=0, disc=disc,
                                   d_optimizer=d_optimizer)
    assert disc.training and not enc.training
    assert all(p.requires_grad for p in disc.parameters())
    assert not any(p.requires_grad for p in enc.parameters())
    state = state.clone()
    assert state.disc is not disc and state.d_opt_state is not None
    step = make(enc, dec, state.transformer, opt, tc.loss, disc=state.disc,
                d_optimizer=d_optimizer)
    state, m = step(state, t(past), t(future))

    for k in ("T_MSE", "T_GDL", "T_gan", "T_total", "Dtotal", "Dfake", "Dreal"):
        assert abs(float(m[k]) - float(jm[k])) <= 2e-6, (k, float(m[k]), float(jm[k]))
    assert float(m["T_gan"]) > 0 and float(m["Dtotal"]) > 0
    for name, module, grads, params, rel, lr in (
            ("transformer", state.transformer, jnew.t_opt[1], jnew.transformer.params,
             1e-5, tc.optim.lr),
            ("disc", state.disc, jnew.d_opt[1], jnew.disc.params, 1e-4, tc.optim_d.lr)):
        got = export_jax_variables(module, {n: p.grad for n, p in module.named_parameters()})
        assert jax.tree.structure(got["params"]) == jax.tree.structure(grads)
        bad = leaf_errors(got["params"], grads, rel, 1e-8)
        assert not bad, (name, bad)
        after = export_jax_variables(module)["params"]
        assert adam_param_errors(after, params, grads, lr, rel, 1e-8) == [], name
    jax.tree_util.tree_map_with_path(
        lambda p, g, w: np.testing.assert_allclose(
            g, np.asarray(w), atol=1e-5, rtol=0, err_msg=jax.tree_util.keystr(p)),
        export_jax_variables(state.disc)["batch_stats"], jnew.disc.stats)
    # the frozen AE took no gradient and kept its statistics
    assert all(p.grad is None for p in enc.parameters())
    jax.tree.map(np.testing.assert_array_equal,
                 export_jax_variables(enc)["batch_stats"], ev["batch_stats"])


def test_gan_needs_the_discriminator_optimizer():
    _, tc = _cfgs("far")
    disc = build_discriminator(tc.disc, device="cpu")
    with pytest.raises(ValueError, match="d_optimizer"):
        make_far_train_step(None, None, None, None, tc.loss, disc=disc)
    tr = build_transformer(tc.transformer, device="cpu")
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    with pytest.raises(ValueError, match="d_optimizer"):
        create_far_train_state(enc, dec, tr, build_optimizer(tc.optim, 48), disc=disc)
    # without a discriminator the GAN term is off, as in the JAX package
    step = make_far_train_step(enc, dec, tr, build_optimizer(tc.optim, 48), tc.loss)
    state = create_far_train_state(enc, dec, tr, build_optimizer(tc.optim, 48))
    frames = torch.rand(2, 6, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    _, m = step(state, frames[:, :3], frames[:, 3:])
    assert float(m["T_gan"]) == 0.0 == float(m["Dtotal"])
