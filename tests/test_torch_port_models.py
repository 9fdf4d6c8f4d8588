"""The port's modules against the JAX package's, through the weights
converter (``vptr_tpu_torch.utils.weights.load_jax_variables``), on the CPU.

(d) ``VPTREnc``/``VPTRDec`` with random BatchNorm running statistics
    (also at nar_bair's and nar_kth_128's geometries),
    ``EncoderBlock`` and ``VPTRFormerFAR``, all weights random (seeded
    numpy), both packages in f32, the JAX attention kernels in Pallas
    interpret mode (its own CPU default).

Tolerance 1e-4 absolute: outputs are O(1) after a stack of convs /
LayerNorms / four attention sublayers per block; f32 summation-order
differences between XLA and torch accumulate to ~1e-5 over that depth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vptr_tpu.config as jcfg
import vptr_tpu_torch.config as tcfg
from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.transformer import EncoderBlock as JEncoderBlock
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.layers import use_kernels
from vptr_tpu_torch.models.position import (
    position_embedding_1d,
    position_embedding_2d,
)
from vptr_tpu_torch.models.transformer import EncoderBlock, build_transformer
from vptr_tpu_torch.utils.weights import load_jax_variables

from _torch_port_util import SMALL, randomize, small_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4


def test_autoencoder_matches_jax():
    jc, tc = small_cfgs()
    rng = np.random.default_rng(10)
    frames = rng.uniform(0, 1, (2, 3, 64, 64, 1)).astype(np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    ev = randomize(jenc.init(jax.random.PRNGKey(0), jnp.asarray(frames)), rng)
    jfeat = jenc.apply(ev, jnp.asarray(frames))
    dv = randomize(jdec.init(jax.random.PRNGKey(1), jfeat), rng)
    jout = jdec.apply(dv, jfeat)

    enc, dec = build_autoencoder(tc.ae, device="cpu")
    load_jax_variables(enc, ev)
    load_jax_variables(dec, dv)
    with torch.inference_mode():
        feat = enc(t(frames))
        out = dec(t(np.asarray(jfeat)))
    assert feat.shape == (2, 3, 8, 8, 48)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)


@pytest.mark.parametrize("preset,size,channels", [("nar_bair", 64, 3),
                                                  ("nar_kth_128", 128, 1)])
def test_autoencoder_preset_geometry_matches_jax(preset, size, channels):
    """The AE at two more presets' geometries (SMALL widths): nar_bair's
    three channels, zero padding and tanh head; nar_kth_128's 128 x 128
    frames (16 x 16 latents)."""
    over = {"dtype": "float32", "ae": SMALL["ae"]}
    jc = jcfg.get_preset(preset).override(over)
    tc = tcfg.get_preset(preset).override(over)
    assert (tc.ae.img_channels, tc.data.img_size) == (channels, size)
    rng = np.random.default_rng(11)
    frames = rng.uniform(0, 1, (2, 2, size, size, channels)).astype(np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    ev = randomize(jenc.init(jax.random.PRNGKey(0), jnp.asarray(frames)), rng)
    jfeat = jenc.apply(ev, jnp.asarray(frames))
    dv = randomize(jdec.init(jax.random.PRNGKey(1), jfeat), rng)
    jout = jdec.apply(dv, jfeat)

    enc, dec = build_autoencoder(tc.ae, device="cpu")
    load_jax_variables(enc, ev)
    load_jax_variables(dec, dv)
    with torch.inference_mode():
        feat = enc(t(frames))
        out = dec(t(np.asarray(jfeat)))
    assert feat.shape == (2, 2, size // 8, size // 8, 48)
    assert out.shape == (2, 2, size, size, channels)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)


@pytest.mark.parametrize("route", ["fused", "fused_residual", "unfused"])
def test_encoder_block_matches_jax(route):
    """fused: the LN-folded window kernel + attention core (the preset
    route); fused_residual: the window sublayer's residual folded into the
    kernel (``fused_attention_ln_res``); unfused: LayerNorm, projections and
    plain attention."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 8, 8, 48)).astype(np.float32)
    fused = route != "unfused"
    flags = dict(fused_attention=fused, fused_full=fused,
                 fused_residual=route == "fused_residual")
    jblock = JEncoderBlock(48, 4, 4, dropout=0.0, drop_path=0.0,
                           dim_feedforward=192, far=True, **flags)
    pos2d = position_embedding_2d(4, 4, 48).numpy()
    pos_t = position_embedding_1d(4, 48).numpy()
    jargs = (jnp.asarray(x), jnp.asarray(pos2d), jnp.asarray(pos_t))
    jv = randomize(jblock.init(jax.random.PRNGKey(2), *jargs), rng)
    want = jblock.apply(jv, *jargs)

    block = EncoderBlock(48, 4, 8, 8, dim_feedforward=192, **flags).eval()
    load_jax_variables(block, jv)
    with torch.inference_mode():
        got = block(t(x), t(pos2d).reshape(16, 48), t(pos_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kernels", ["cuda", "plain"])
def test_far_transformer_matches_jax(kernels):
    jc, tc = small_cfgs()
    rng = np.random.default_rng(12)
    feats = rng.standard_normal((2, 6, 8, 8, 48)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer)
    tv = randomize(jtr.init(jax.random.PRNGKey(3), jnp.asarray(feats)), rng)
    want = jtr.apply(tv, jnp.asarray(feats), train=False)

    tr = build_transformer(tc.transformer, device="cpu")
    use_kernels(load_jax_variables(tr, tv), kernels)
    with torch.inference_mode():
        got = tr(t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_weights_converter_refuses_mismatches():
    _, tc = small_cfgs()
    tr = build_transformer(tc.transformer, device="cpu")
    with pytest.raises(KeyError, match="no JAX leaf"):
        load_jax_variables(tr, {"params": {}})
    with pytest.raises((KeyError, AttributeError)):
        load_jax_variables(tr, {"params": {"nope": {"kernel": np.zeros(2)}}})
