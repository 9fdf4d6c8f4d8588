"""The slice as a whole on the CPU: the port's FAR prediction path against
the JAX package's on the same converted weights.

(e) ``far_rollout_pixel`` (far_rip) and ``far_rollout_latent`` (far_ril),
    num_pred 4 from Tp = 3 past frames on a 6-slot ring buffer, so the
    buffer fills and then slides; plus ``make_predict_fn`` in all three
    modes against the JAX rollouts / one-shot forward.

Weights and frames are seeded numpy, shared by both packages; f32; the JAX
attention kernels run in Pallas interpret mode. Tolerance 1e-3 absolute on
[0, 1] sigmoid frames: each step decodes, re-encodes (RIP) and re-runs the
whole transformer, so the ~1e-5 per-module f32 differences compound over
four autoregressive steps.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.eval.rollout import far_rollout_latent as jfar_ril
from vptr_tpu.eval.rollout import far_rollout_pixel as jfar_rip
from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu_torch.eval.harness import make_predict_fn
from vptr_tpu_torch.eval.rollout import far_rollout_latent, far_rollout_pixel
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.utils.weights import load_jax_variables

from _torch_port_util import randomize, small_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-3
NUM_PRED = 4
CONTEXT = 6


@pytest.fixture(scope="module")
def models():
    """Both packages' enc/dec/transformer on one set of random weights,
    plus seeded past (2, 3, 64, 64, 1) and future (2, 3, ...) frames."""
    jc, tc = small_cfgs()
    rng = np.random.default_rng(20)
    frames = rng.uniform(0, 1, (2, 6, 64, 64, 1)).astype(np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    jtr = jbuild_tr(jc.transformer)
    x = jnp.asarray(frames[:, :3])
    ev = randomize(jenc.init(jax.random.PRNGKey(0), x), rng)
    feats = jenc.apply(ev, x)
    dv = randomize(jdec.init(jax.random.PRNGKey(1), feats), rng)
    tv = randomize(jtr.init(jax.random.PRNGKey(2), feats), rng)
    jfns = (partial(jenc.apply, ev, train=False),
            partial(jdec.apply, dv, train=False),
            partial(jtr.apply, tv, train=False))
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    tr = build_transformer(tc.transformer, device="cpu")
    for m, v in ((enc, ev), (dec, dv), (tr, tv)):
        load_jax_variables(m, v)
    return dict(cfg=tc, jfns=jfns, port=(enc, dec, tr), frames=frames)


@pytest.mark.parametrize("mode", ["far_rip", "far_ril"])
def test_far_rollout_matches_jax(models, mode):
    past = models["frames"][:, :3]
    jroll, roll = ((jfar_rip, far_rollout_pixel) if mode == "far_rip"
                   else (jfar_ril, far_rollout_latent))
    want = np.asarray(jroll(*models["jfns"], jnp.asarray(past), NUM_PRED,
                            CONTEXT))
    with torch.inference_mode():
        got = roll(*models["port"], t(past), NUM_PRED, CONTEXT)
    assert got.shape == (2, NUM_PRED, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)

    predict = make_predict_fn(models["cfg"], *models["port"], mode, NUM_PRED,
                              device="cpu")
    np.testing.assert_allclose(predict(past).numpy(), want, atol=ATOL)


def test_predict_far_teacher_forced_matches_jax(models):
    enc_fn, dec_fn, tr_fn = models["jfns"]
    frames = models["frames"]
    want = np.asarray(dec_fn(tr_fn(enc_fn(jnp.asarray(frames[:, :5])))))[:, -3:]
    predict = make_predict_fn(models["cfg"], *models["port"], "far", 3,
                              device="cpu")
    got = predict(frames[:, :3], frames[:, 3:])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
