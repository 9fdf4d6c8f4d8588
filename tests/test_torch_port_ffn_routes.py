"""The fused feed-forward route (``transformer.fused_ffn`` and ``fused_dw``)
of the port against the JAX package's, on the CPU.

(p) the route's JAX variables have the default route's tree and load into
    the port's modules; the NAR encoder's BatchNorm conv FFN ignores
    ``fused_dw`` while the decoder's LayerNorm ones take it;
(q) a small far_mnist (2 layers, d 48, 4 heads, Tp = Tf = 3) with both
    flags: the transformer forward (kernels="cuda", the wrappers' plain
    versions on CPU tensors, and kernels="plain"), the far_rip predict and
    the teacher-forced far predict against the JAX model with the same
    flags (the JAX kernels #7/#9 in Pallas interpret mode);
(r) a small nar_mnist (1 + 1 layers) with both flags: the forward.

Weights are random (seeded numpy), f32. Tolerances: modules 1e-4 absolute,
the rollout 1e-3 on [0, 1] frames (as ``test_torch_port_models.py`` and
``test_torch_port_rollout.py``: f32 summation order over the stack, and
over four autoregressive steps).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.eval.rollout import far_rollout_pixel as jfar_rip
from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu_torch.eval.harness import make_predict_fn
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.layers import Mlp, MlpDWBN, use_kernels
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.utils.weights import load_jax_variables

from _torch_port_util import random_variables, small_cfgs, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

FLAGS = {"fused_ffn": True, "fused_dw": True}
ATOL = 1e-4


def _far_cfgs():
    jc, tc = small_cfgs()
    over = {"transformer": FLAGS}
    return jc.override(over), tc.override(over)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def test_route_tree_matches_default_and_loads():
    jc, tc = _far_cfgs()
    feats = jnp.zeros((2, 3, 8, 8, 48), jnp.float32)
    fused = jax.eval_shape(jbuild_tr(jc.transformer).init, jax.random.PRNGKey(0),
                           feats)
    default = jax.eval_shape(jbuild_tr(small_cfgs()[0].transformer).init,
                             jax.random.PRNGKey(0), feats)
    assert _shapes(fused) == _shapes(default)
    tr = build_transformer(tc.transformer, device="cpu")
    plain_tr = build_transformer(small_cfgs()[1].transformer, device="cpu")
    assert ({k: v.shape for k, v in tr.state_dict().items()}
            == {k: v.shape for k, v in plain_tr.state_dict().items()})
    rng = np.random.default_rng(90)
    load_jax_variables(tr, random_variables(jbuild_tr(jc.transformer).init, rng,
                                            feats))
    assert all(m.fused for m in tr.modules() if isinstance(m, Mlp))
    assert all(m.fused_dw for m in tr.modules() if isinstance(m, MlpDWBN))


@pytest.mark.parametrize("kernels", ["cuda", "plain"])
def test_far_route_transformer_matches_jax(kernels):
    jc, tc = _far_cfgs()
    rng = np.random.default_rng(91)
    feats = rng.standard_normal((2, 6, 8, 8, 48)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer)
    tv = random_variables(jtr.init, rng, jnp.asarray(feats))
    want = jtr.apply(tv, jnp.asarray(feats), train=False)
    tr = use_kernels(load_jax_variables(
        build_transformer(tc.transformer, device="cpu"), tv), kernels)
    with torch.inference_mode():
        got = tr(t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_far_route_predict_matches_jax():
    """far_rip for 4 frames from 3 past ones on a 6-slot buffer (the buffer
    fills, then slides), and the teacher-forced far mode."""
    jc, tc = _far_cfgs()
    rng = np.random.default_rng(92)
    frames = rng.uniform(0, 1, (2, 6, 64, 64, 1)).astype(np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    jtr = jbuild_tr(jc.transformer)
    x = jnp.asarray(frames[:, :3])
    ev = random_variables(jenc.init, rng, x)
    feats = jenc.apply(ev, x)
    dv = random_variables(jdec.init, rng, feats)
    tv = random_variables(jtr.init, rng, feats)
    jfns = (partial(jenc.apply, ev, train=False), partial(jdec.apply, dv, train=False),
            partial(jtr.apply, tv, train=False))
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    tr = build_transformer(tc.transformer, device="cpu")
    for m, v in ((enc, ev), (dec, dv), (tr, tv)):
        load_jax_variables(m, v)

    want = np.asarray(jfar_rip(*jfns, x, 4, 6))
    got = make_predict_fn(tc, enc, dec, tr, "far_rip", 4, device="cpu")(frames[:, :3])
    assert got.shape == (2, 4, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)

    enc_fn, dec_fn, tr_fn = jfns
    want = np.asarray(dec_fn(tr_fn(enc_fn(jnp.asarray(frames[:, :5])))))[:, -3:]
    got = make_predict_fn(tc, enc, dec, tr, "far", 3, device="cpu")(
        frames[:, :3], frames[:, 3:])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_nar_route_matches_jax():
    jc, tc = small_nar_cfgs(**FLAGS)
    over = {"transformer": {"num_encoder_layers": 1, "num_decoder_layers": 1}}
    jc, tc = jc.override(over), tc.override(over)
    rng = np.random.default_rng(93)
    feats = rng.standard_normal((2, 3, 8, 8, 48)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer)
    tv = random_variables(partial(jtr.init, method="init_all"), rng,
                          jnp.asarray(feats))
    want = jtr.apply(tv, jnp.asarray(feats), train=False)
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"), tv)
    assert not tr.enc_block0.spatial_ffn.fused_dw          # BatchNorm flavour
    assert tr.dec_block0.spatial_ffn.fused_dw and tr.dec_block0.spatial_ffn2.fused_dw
    assert tr.enc_block0.ffn.fused and tr.dec_block0.ffn.fused
    with torch.inference_mode():
        got = tr(t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
