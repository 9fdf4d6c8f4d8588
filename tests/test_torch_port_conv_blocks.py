"""The modules of the conv-FFN kernel route (``transformer.fused_conv_ffn``)
and of the folded temporal sublayer (``transformer.fused_full_temporal``)
against the JAX package's, on the CPU (the models:
``test_torch_port_conv_routes.py``).

(v) ``MlpDWBN`` with ``fused_ln`` (fc1 and fc2 through ``conv_ln_gelu``)
    against the JAX module: the wrappers' plain versions on CPU tensors and
    kernels="plain"; the routes' precedence;
(w) ``EncoderBlock`` (FAR: causal, LayerNorm conv FFN) and
    ``DecoderBlockNAR`` (RPE) with each flag alone and both, on the fused
    attention route: the temporal sublayer's norm folded into
    ``fused_attention_ln`` at T = 5 (encoder) and 3 (decoder) tokens (the
    JAX kernel pads them to 8), the enc-dec attention unchanged.

Weights are random (seeded numpy), f32. Tolerance 1e-4 absolute (as
``test_torch_port_models.py``: f32 summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.models import layers as jlayers
from vptr_tpu.models import transformer as jtransformer
from vptr_tpu_torch.models.layers import MlpDWBN, TemporalAttention, use_kernels
from vptr_tpu_torch.models.transformer import DecoderBlockNAR, EncoderBlock
from vptr_tpu_torch.utils.weights import load_jax_variables

from _torch_port_util import random_variables, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

FLAGS = {"fused_conv_ffn": True, "fused_full_temporal": True}
ATOL = 1e-4
D, HEADS = 48, 4
ONE_FLAG = [{"fused_conv_ffn": True}, {"fused_full_temporal": True}, FLAGS]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


# ------------------------------------------------------------- (v) MlpDWBN

@pytest.mark.parametrize("kernels", ["cuda", "plain"])
def test_mlpdwbn_conv_ln_route_matches_jax(kernels):
    rng = np.random.default_rng(140)
    x = rng.standard_normal((2, 3, 8, 8, D)).astype(np.float32)
    jm = jlayers.MlpDWBN(D, 4 * D, norm="layer", fused_ln=True)
    v = random_variables(jm.init, rng, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    m = MlpDWBN(D, 4 * D, 8, 8, "layer", fused_ln=True)
    assert m.fused_ln and not m.fused_dw
    use_kernels(load_jax_variables(m, v).eval(), kernels)
    with torch.inference_mode():
        _close(m(t(x)), want)


def test_mlpdwbn_route_precedence():
    """``fused_dw`` before ``fused_ln`` (``layers.py:632/660``); BatchNorm
    takes neither."""
    both = MlpDWBN(D, 4 * D, 8, 8, "layer", fused_dw=True, fused_ln=True)
    assert both.fused_dw and not both.fused_ln
    bn = MlpDWBN(D, 4 * D, 8, 8, "batch", fused_dw=True, fused_ln=True)
    assert not bn.fused_dw and not bn.fused_ln


# -------------------------------------------------------------- (w) blocks

def _block_inputs(rng, t_len=5):
    return (rng.standard_normal((2, t_len, 8, 8, D)).astype(np.float32),
            (0.3 * rng.standard_normal((16, D))).astype(np.float32),
            (0.3 * rng.standard_normal((t_len, D))).astype(np.float32))


@pytest.mark.parametrize("flags", ONE_FLAG, ids=lambda f: "+".join(f))
def test_encoder_block_matches_jax(flags):
    rng = np.random.default_rng(141)
    x, pos2d, pos_t = _block_inputs(rng)
    jb = jtransformer.EncoderBlock(D, HEADS, dim_feedforward=4 * D, far=True,
                                   fused_attention=True, fused_full=True, **flags)
    jin = tuple(map(jnp.asarray, (x, pos2d, pos_t)))
    v = random_variables(jb.init, rng, *jin)
    want = jb.apply(v, *jin)
    blk = EncoderBlock(D, HEADS, 8, 8, dim_feedforward=4 * D, far=True,
                       fused_attention=True, fused_full=True, **flags)
    load_jax_variables(blk, v).eval()
    assert blk.spatial_ffn.fused_ln == flags.get("fused_conv_ffn", False)
    assert blk.temporal.attn.fused_full == flags.get("fused_full_temporal", False)
    with torch.inference_mode():
        _close(blk(t(x), t(pos2d), t(pos_t)), want)


@pytest.mark.parametrize("flags", ONE_FLAG, ids=lambda f: "+".join(f))
def test_decoder_block_nar_matches_jax(flags):
    rng = np.random.default_rng(142)
    tgt, pos2d, pos_f = _block_inputs(rng, 3)
    query_pos = (0.3 * rng.standard_normal(tgt.shape)).astype(np.float32)
    memory = rng.standard_normal((2, 4, 8, 8, D)).astype(np.float32)
    pos_p = (0.3 * rng.standard_normal((4, D))).astype(np.float32)
    jb = jtransformer.DecoderBlockNAR(D, HEADS, dim_feedforward=4 * D, rpe=True,
                                      fused_attention=True, fused_full=True, **flags)
    jin = tuple(map(jnp.asarray, (tgt, query_pos, memory, pos2d, pos_f, pos_p)))
    v = random_variables(jb.init, rng, *jin, None)
    want = jb.apply(v, *jin, None)
    blk = DecoderBlockNAR(D, HEADS, 8, 8, dim_feedforward=4 * D, rpe=True,
                          fused_attention=True, fused_full=True, **flags)
    load_jax_variables(blk, v).eval()
    conv = flags.get("fused_conv_ffn", False)
    assert blk.spatial_ffn.fused_ln == conv and blk.spatial_ffn2.fused_ln == conv
    assert blk.temporal.attn.fused_full == flags.get("fused_full_temporal", False)
    assert not blk.enc_dec.attn.fused_full
    with torch.inference_mode():
        _close(blk(*map(t, (tgt, query_pos, memory, pos2d, pos_f, pos_p))), want)


def test_temporal_ln_needs_self_attention():
    ta = TemporalAttention(D, HEADS, fused=True, fused_full=True)
    x = torch.zeros(1, 3, 2, 2, D)
    ln = (torch.ones(D), torch.zeros(D))
    with pytest.raises(ValueError, match="self-attention"):
        ta(x, torch.zeros(3, D), kv=x, pos_k=torch.zeros(3, D), ln=ln)
