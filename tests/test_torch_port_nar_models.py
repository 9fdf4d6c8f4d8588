"""The NAR slice's modules and prediction path against the JAX package's,
through the weights converter, on the CPU.

(l) ``EncoderBlock(far=False)`` (RPE window attention with the LN folded
    in, BatchNorm conv FFN with random running statistics, non-causal
    temporal attention) and ``DecoderBlockNAR`` (two-stream window
    attention, temporal self-attention, enc-dec attention, also with
    Tp = 2 != Tf = 3) on the fused and unfused routes; ``VPTRFormerNAR``
    in eval mode for Tp = Tf = 3 and Tp = 2, Tf = 3 with kernels="cuda"
    (the wrappers; plain versions on CPU tensors) and kernels="plain", and
    at nar_kth_128's 16 x 16 latent and nar_bair's Tp = 2 -> Tf = 3 in both
    modes;
(the rollout and the weight round trip: ``test_torch_port_nar_rollout.py``).

Weights are random (seeded numpy), f32, the JAX attention kernels in
Pallas interpret mode. Tolerances: 1e-4 absolute (as the FAR module tests:
f32 summation order over a stack of convs, norms and attention
sublayers).
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vptr_tpu.config as jcfg
import vptr_tpu_torch.config as tcfg
from vptr_tpu.models.transformer import DecoderBlockNAR as JDecoderBlockNAR
from vptr_tpu.models.transformer import EncoderBlock as JEncoderBlock
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu_torch.models.layers import use_kernels
from vptr_tpu_torch.models.position import (
    position_embedding_1d,
    position_embedding_2d,
)
from vptr_tpu_torch.models.transformer import (
    DecoderBlockNAR,
    EncoderBlock,
    build_transformer,
)
from vptr_tpu_torch.utils.weights import load_jax_variables

from _torch_port_util import SMALL, random_variables, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
ROUTES = {"fused": dict(fused_attention=True, fused_full=True),
          "unfused": dict(fused_attention=False, fused_full=False)}


def _pos(tp, tf):
    pos2d = position_embedding_2d(4, 4, 48).numpy()
    pos_t = position_embedding_1d(tp + tf, 48).numpy()
    return pos2d, pos_t[:tp], pos_t[tp:]


@pytest.mark.parametrize("route", list(ROUTES))
def test_nar_encoder_block_matches_jax(route):
    rng = np.random.default_rng(70)
    x = rng.standard_normal((2, 3, 8, 8, 48)).astype(np.float32)
    jblock = JEncoderBlock(48, 4, 4, dropout=0.0, drop_path=0.0,
                           dim_feedforward=192, far=False, rpe=True,
                           **ROUTES[route])
    pos2d, pos_t, _ = _pos(3, 0)
    jargs = (jnp.asarray(x), jnp.asarray(pos2d), jnp.asarray(pos_t))
    jv = random_variables(jblock.init, rng, *jargs)
    assert "batch_stats" in jv
    want = jblock.apply(jv, *jargs)

    block = EncoderBlock(48, 4, 8, 8, dim_feedforward=192, far=False, rpe=True,
                         **ROUTES[route]).eval()
    load_jax_variables(block, jv)
    with torch.inference_mode():
        got = block(t(x), t(pos2d).reshape(16, 48), t(pos_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("route,tp", [("fused", 3), ("unfused", 3),
                                      ("fused", 2)])
def test_nar_decoder_block_matches_jax(route, tp):
    rng = np.random.default_rng(71)
    tf = 3
    tgt = rng.standard_normal((2, tf, 8, 8, 48)).astype(np.float32)
    qpos = rng.standard_normal((2, tf, 8, 8, 48)).astype(np.float32)
    memory = rng.standard_normal((2, tp, 8, 8, 48)).astype(np.float32)
    pos2d, pos_past, pos_future = _pos(tp, tf)
    jblock = JDecoderBlockNAR(48, 4, 4, dropout=0.0, drop_path=0.0,
                              dim_feedforward=192, rpe=True, **ROUTES[route])
    jargs = tuple(map(jnp.asarray, (tgt, qpos, memory, pos2d, pos_future,
                                    pos_past))) + (None,)
    jv = random_variables(jblock.init, rng, *jargs)
    want = jblock.apply(jv, *jargs)

    block = DecoderBlockNAR(48, 4, 8, 8, dim_feedforward=192, rpe=True,
                            **ROUTES[route]).eval()
    load_jax_variables(block, jv)
    with torch.inference_mode():
        got = block(t(tgt), t(qpos), t(memory), t(pos2d).reshape(16, 48),
                    t(pos_future), t(pos_past))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _nar_pair(rng, past=3, future=3):
    """(JAX transformer, its random variables, port transformer with them)."""
    jc, tc = small_nar_cfgs(past, future)
    feats = jnp.asarray(rng.standard_normal((2, past, 8, 8, 48)), jnp.float32)
    jtr = jbuild_tr(jc.transformer)
    tv = random_variables(partial(jtr.init, method="init_all"), rng, feats)
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"), tv)
    return jtr, tv, tr


@pytest.mark.parametrize("kernels,past", [("cuda", 3), ("plain", 3),
                                          ("cuda", 2)])
def test_nar_transformer_matches_jax(kernels, past):
    rng = np.random.default_rng(72)
    jtr, tv, tr = _nar_pair(rng, past)
    feats = rng.standard_normal((2, past, 8, 8, 48)).astype(np.float32)
    want = jtr.apply(tv, jnp.asarray(feats), train=False)
    want_proj = jtr.apply(tv, want, method=jtr.nce_project)
    use_kernels(tr, kernels)
    with torch.inference_mode():
        got = tr(t(feats))
        proj = tr.nce_project(got)
    assert got.shape == (2, 3, 8, 8, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(proj.numpy(), np.asarray(want_proj), atol=ATOL)


@lru_cache(maxsize=None)
def _preset_case(preset, past, future):
    """The JAX NAR transformer of ``preset`` at SMALL widths (2 + 2 layers,
    Tp = past, Tf = future) on seeded features: (port config, its random
    variables, the features, JAX's prediction and NCE projection), computed
    once for both kernel modes."""
    over = {**SMALL,
            "transformer": {**SMALL["transformer"], "num_decoder_layers": 2,
                            "num_past_frames": past, "num_future_frames": future},
            "data": {**SMALL["data"], "num_past_frames": past,
                     "num_future_frames": future}}
    jc = jcfg.get_preset(preset).override(over)
    tc = tcfg.get_preset(preset).override(over)
    h, w = tc.transformer.enc_h, tc.transformer.enc_w
    rng = np.random.default_rng(73)
    feats = rng.standard_normal((2, past, h, w, 48)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer)
    tv = random_variables(partial(jtr.init, method="init_all"), rng, jnp.asarray(feats))
    want = jtr.apply(tv, jnp.asarray(feats), train=False)
    want_proj = jtr.apply(tv, want, method=jtr.nce_project)
    return tc, tv, feats, np.asarray(want), np.asarray(want_proj)


@pytest.mark.parametrize("kernels", ["cuda", "plain"])
@pytest.mark.parametrize("preset,past,future,latent", [("nar_kth_128", 3, 3, 16),
                                                       ("nar_bair", 2, 3, 8)])
def test_nar_transformer_preset_geometry_matches_jax(preset, past, future, latent,
                                                     kernels):
    """The NAR transformer at nar_kth_128's 16 x 16 latent (16 windows a
    frame) and at nar_bair's Tp = 2 -> Tf = 3, SMALL widths, both kernel
    modes (the wrappers' plain versions on CPU tensors, and plain)."""
    tc, tv, feats, want, want_proj = _preset_case(preset, past, future)
    assert (tc.transformer.enc_h, tc.transformer.enc_w) == (latent, latent)
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"), tv)
    use_kernels(tr, kernels)
    with torch.inference_mode():
        got = tr(t(feats))
        proj = tr.nce_project(got)
    assert got.shape == (2, future, latent, latent, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(proj.numpy(), want_proj, atol=ATOL)
