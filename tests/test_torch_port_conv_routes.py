"""The conv-FFN kernel route (``transformer.fused_conv_ffn``) and the folded
temporal sublayer (``transformer.fused_full_temporal``) of the port's
models against the JAX package's, on the CPU (the modules and blocks:
``test_torch_port_conv_blocks.py``).

(x) a small far_mnist (2 layers, d 48, 4 heads, Tp = Tf = 3) and nar_mnist
    (2 + 2 layers) with both flags: the transformer forward
    (kernels="cuda", the wrappers' plain versions on CPU tensors, and
    kernels="plain"), and the far_rip predict against the JAX model with
    the same flags (the JAX kernels in Pallas interpret mode);
(y) one set of JAX variables loads into the default route and the new one,
    which then take the new routes' modules.

Weights are random (seeded numpy), f32. Tolerances: models 1e-4 absolute,
the rollout 1e-3 on [0, 1] frames (as ``test_torch_port_models.py`` and
``test_torch_port_rollout.py``: f32 summation order over the stack, and
over four autoregressive steps).
"""

import functools
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
from vptr_tpu_torch.models.layers import MlpDWBN, use_kernels
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.utils.weights import load_jax_variables

from _torch_port_util import random_variables, small_cfgs, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

FLAGS = {"fused_conv_ffn": True, "fused_full_temporal": True}
ATOL = 1e-4
D, HEADS = 48, 4


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


# -------------------------------------------------------------- (x) models

def _far_cfgs():
    jc, tc = small_cfgs()
    over = {"transformer": FLAGS}
    return jc.override(over), tc.override(over)


@functools.cache
def _model_case(variant):
    """(port config, JAX variables, features, JAX output) of the small
    model with both flags, computed once for both kernel modes."""
    jc, tc = _far_cfgs() if variant == "far" else small_nar_cfgs(**FLAGS)
    rng = np.random.default_rng(143 if variant == "far" else 144)
    tp = 6 if variant == "far" else 3
    feats = rng.standard_normal((2, tp, 8, 8, D)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer)
    init = jtr.init if variant == "far" else partial(jtr.init, method="init_all")
    tv = random_variables(init, rng, jnp.asarray(feats))
    return tc, tv, feats, np.asarray(jtr.apply(tv, jnp.asarray(feats), train=False))


@pytest.mark.parametrize("kernels", ["cuda", "plain"])
@pytest.mark.parametrize("variant", ["far", "nar"])
def test_route_transformer_matches_jax(variant, kernels):
    tc, tv, feats, want = _model_case(variant)
    tr = use_kernels(load_jax_variables(
        build_transformer(tc.transformer, device="cpu"), tv), kernels)
    if variant == "nar":
        assert not tr.enc_block0.spatial_ffn.fused_ln      # BatchNorm flavour
        assert tr.dec_block0.spatial_ffn.fused_ln and tr.dec_block1.spatial_ffn2.fused_ln
        assert tr.enc_block0.temporal.attn.fused_full
        assert tr.dec_block0.temporal.attn.fused_full
    with torch.inference_mode():
        _close(tr(t(feats)), want)


def test_far_route_rollout_matches_jax():
    """far_rip for 4 frames from 3 past ones on a 6-slot buffer (the buffer
    fills, then slides)."""
    jc, tc = _far_cfgs()
    rng = np.random.default_rng(145)
    frames = rng.uniform(0, 1, (2, 3, 64, 64, 1)).astype(np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    jtr = jbuild_tr(jc.transformer)
    x = jnp.asarray(frames)
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
    got = make_predict_fn(tc, enc, dec, tr, "far_rip", 4, device="cpu")(frames)
    assert got.shape == (2, 4, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


# -------------------------------------------------------------- (y) loading

@pytest.mark.parametrize("variant", ["far", "nar"])
def test_one_set_of_variables_loads_into_both_routes(variant):
    """The JAX tree is the same on every route (``_ConvParams`` and
    ``_LnHwcParams`` mirror ``nn.Conv`` and ``LayerNormHWC``;
    ``_LnScaleBias`` the temporal ``nn.LayerNorm``): variables of the
    default-route JAX model load into the port's default route and into the
    new one, and both then compute the same function as the JAX model."""
    jc, tc = small_cfgs() if variant == "far" else small_nar_cfgs()
    rng = np.random.default_rng(146)
    feats = rng.standard_normal((2, 3, 8, 8, D)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer)
    init = jtr.init if variant == "far" else partial(jtr.init, method="init_all")
    tv = random_variables(init, rng, jnp.asarray(feats))
    want = jtr.apply(tv, jnp.asarray(feats), train=False)
    jnew = jbuild_tr(jc.override({"transformer": FLAGS}).transformer)
    new_init = jnew.init if variant == "far" else partial(jnew.init, method="init_all")
    shapes = lambda tree: jax.tree.map(np.shape, tree)
    assert shapes(jax.eval_shape(new_init, jax.random.PRNGKey(0),
                                 jnp.asarray(feats))) == shapes(tv)
    for over in ({}, FLAGS):
        tr = load_jax_variables(build_transformer(
            tc.override({"transformer": over}).transformer, device="cpu"), tv)
        assert any(isinstance(m, MlpDWBN) and m.fused_ln for m in tr.modules()) == bool(over)
        with torch.inference_mode():
            # the new route differs from the default only by the A&S erf
            # (|error| <= 1.5e-7) in the conv FFNs' GELUs
            _close(tr(t(feats)), want)
