"""The NAR prediction path as a whole on the CPU, against the JAX package's
on the same converted weights.

(m) ``nar_rollout`` and ``make_predict_fn(mode="nar")`` for num_pred = Tf
    (one block) and 2.5 blocks (7 frames from blocks of 3, the context
    being the last Tp latents of past + predictions);
(n) the weight round trip: ``export_jax_variables`` of a model loaded with
    ``load_jax_variables`` gives back the JAX tree (params and batch
    statistics), leaf for leaf, with the bare ``frame_queries`` and
    ``rpe_table`` leaves and the setup-style names.

nar_mnist cut to d 48, 4 heads, 2 + 2 layers, Tp = Tf = 3, AE ngf 8;
random weights (seeded numpy), f32, the JAX attention kernels in Pallas
interpret mode. Tolerance 1e-3 absolute on [0, 1] sigmoid frames: up to
three NAR blocks chained through the transformer, then one decode, so the
~1e-5 per-module f32 differences compound.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.eval.rollout import nar_rollout as jnar_rollout
from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu_torch.eval.harness import make_predict_fn
from vptr_tpu_torch.eval.rollout import nar_rollout
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

from _torch_port_util import random_variables, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def nar_models():
    jc, tc = small_nar_cfgs()
    rng = np.random.default_rng(73)
    frames = rng.uniform(0, 1, (2, 3, 64, 64, 1)).astype(np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    feats = np.zeros((2, 3, 8, 8, 48), np.float32)
    ev = random_variables(jenc.init, rng, frames)
    dv = random_variables(jdec.init, rng, feats)
    jtr = jbuild_tr(jc.transformer)
    tv = random_variables(partial(jtr.init, method="init_all"), rng, feats)
    jfns = (partial(jenc.apply, ev, train=False),
            partial(jdec.apply, dv, train=False),
            partial(jtr.apply, tv, train=False))
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    tr = build_transformer(tc.transformer, device="cpu")
    for m, v in ((enc, ev), (dec, dv), (tr, tv)):
        load_jax_variables(m, v)
    return dict(cfg=tc, jfns=jfns, port=(enc, dec, tr), past=frames, tv=tv)


@pytest.mark.parametrize("num_pred", [3, 7])
def test_nar_rollout_matches_jax(nar_models, num_pred):
    past = nar_models["past"]
    want = np.asarray(jnar_rollout(*nar_models["jfns"], jnp.asarray(past),
                                   num_pred, 3))
    with torch.inference_mode():
        got = nar_rollout(*nar_models["port"], t(past), num_pred, 3)
    assert got.shape == (2, num_pred, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    predict = make_predict_fn(nar_models["cfg"], *nar_models["port"], "nar",
                              num_pred, device="cpu")
    np.testing.assert_allclose(predict(past).numpy(), want, atol=1e-3)


def test_nar_weights_round_trip(nar_models):
    tv = nar_models["tv"]
    got = export_jax_variables(nar_models["port"][2])
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, tv))
    jax.tree_util.tree_map_with_path(
        lambda path, a, w: np.testing.assert_array_equal(
            a, np.asarray(w), err_msg=jax.tree_util.keystr(path)), got, tv)
    leaves = {jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_leaves_with_path(got)}
    for name in ("['params']['frame_queries']",
                 "['params']['enc_block0']['slmhsa']['rpe_table']",
                 "['params']['dec_block1']['slmhsa']['rpe_table']",
                 "['params']['nce_fc2']['kernel']", "['params']['enc_norm']['scale']",
                 "['batch_stats']['enc_block1']['spatial_ffn']['norm3']['var']"):
        assert name in leaves, name
