"""The TSLMA slice's modules against the JAX package's, through the weights
converter, on the CPU.

(v) ``TSLMA`` (the enc-dec attention over space-time windows, the 3D
    position table on its queries and keys), ``DecoderBlockNAR(tslma=True)``
    and a whole ``VPTRFormerNAR`` with ``tslma`` (2 + 2 layers, RPE, the
    NCE projector too) at Tp = Tf = 10 (160 query tokens over 160 keys a
    window) and at nar_bair's Tp = 2 -> Tf = 10 (160 over 32), the fused
    route (the attention-core wrapper, its plain versions on CPU tensors)
    and kernels="plain"; the JAX side runs its Pallas kernels in
    interpret mode;
(w) the parameter tree: ``dec_block{i}.tslma.attn.{q,k,v,out}_proj`` in
    place of ``enc_dec`` (as flax creates only the module it calls), loaded
    from and exported back to the JAX tree leaf for leaf; ``build_transformer``
    takes ``tslma`` and the model carries the 3D table as a buffer.

d_model 48 over 4 heads (head width 12), window 4, 8 x 8 latents, f32.
Tolerance: 1e-5 absolute throughout (f32; the whole model's largest
difference was 3.1e-6 on outputs of magnitude up to 4.2).
"""

from functools import lru_cache, partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.models.position import position_embedding_3d as jpos3d
from vptr_tpu.models.transformer import TSLMA as JTSLMA
from vptr_tpu.models.transformer import DecoderBlockNAR as JDecoderBlockNAR
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu_torch.models.layers import use_kernels
from vptr_tpu_torch.models.position import (
    position_embedding_1d,
    position_embedding_2d,
    position_embedding_3d,
)
from vptr_tpu_torch.models.transformer import TSLMA, DecoderBlockNAR, build_transformer
from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

from _torch_port_util import random_variables, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

D, HEADS, WIN = 48, 4, 4
GEOMETRY = {"nar_mnist": (10, 10), "nar_bair": (2, 10)}   # (Tp, Tf)


@pytest.mark.parametrize("geometry", list(GEOMETRY))
@pytest.mark.parametrize("fused", [True, False])
def test_tslma_matches_jax(geometry, fused):
    tp, tf = GEOMETRY[geometry]
    rng = np.random.default_rng(100)
    memory = rng.standard_normal((2, tp, 8, 8, D)).astype(np.float32)
    query = rng.standard_normal((2, tf, 8, 8, D)).astype(np.float32)
    pos3d = np.asarray(jpos3d(tp + tf, WIN, WIN, D))
    jm = JTSLMA(D, HEADS, WIN, 0.1, fused=fused)
    jargs = tuple(map(jnp.asarray, (memory, query, pos3d)))
    jv = random_variables(jm.init, rng, *jargs)
    want = np.asarray(jm.apply(jv, *jargs))
    m = TSLMA(D, HEADS, WIN, 0.1, fused).eval()
    load_jax_variables(m, jv)
    with torch.inference_mode():
        got = m(t(memory), t(query), position_embedding_3d(tp + tf, WIN, WIN, D))
    assert got.shape == (2, tf, 8, 8, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("geometry", list(GEOMETRY))
def test_decoder_block_tslma_matches_jax(geometry):
    tp, tf = GEOMETRY[geometry]
    rng = np.random.default_rng(101)
    tgt = rng.standard_normal((2, tf, 8, 8, D)).astype(np.float32)
    qpos = rng.standard_normal((2, tf, 8, 8, D)).astype(np.float32)
    memory = rng.standard_normal((2, tp, 8, 8, D)).astype(np.float32)
    pos2d = position_embedding_2d(WIN, WIN, D).numpy()
    pos_t = position_embedding_1d(tp + tf, D).numpy()
    pos3d = position_embedding_3d(tp + tf, WIN, WIN, D).numpy()
    flags = dict(fused_attention=True, fused_full=True, rpe=True, tslma=True)
    jb = JDecoderBlockNAR(D, HEADS, WIN, dropout=0.0, drop_path=0.0,
                          dim_feedforward=4 * D, **flags)
    jargs = tuple(map(jnp.asarray, (tgt, qpos, memory, pos2d, pos_t[tp:], pos_t[:tp],
                                    pos3d)))
    jv = random_variables(jb.init, rng, *jargs)
    assert "enc_dec" not in jv["params"] and "tslma" in jv["params"]
    want = np.asarray(jb.apply(jv, *jargs))
    blk = DecoderBlockNAR(D, HEADS, 8, 8, WIN, dim_feedforward=4 * D, **flags).eval()
    assert not hasattr(blk, "enc_dec") and not blk.tslma.attn.fused_full
    load_jax_variables(blk, jv)
    with torch.inference_mode():
        got = blk(*map(t, (tgt, qpos, memory)), t(pos2d).reshape(WIN * WIN, D),
                  t(pos_t[tp:]), t(pos_t[:tp]), t(pos3d))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@lru_cache(maxsize=None)
def _model_case(geometry):
    """(port config, the JAX variables, features, JAX's prediction and NCE
    projection) of the 2 + 2 layer NAR transformer with tslma."""
    tp, tf = GEOMETRY[geometry]
    jc, tc = small_nar_cfgs(tp, tf, tslma=True)
    rng = np.random.default_rng(102)
    feats = rng.standard_normal((2, tp, 8, 8, D)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer)
    tv = random_variables(partial(jtr.init, method="init_all"), rng, jnp.asarray(feats))
    want = jtr.apply(tv, jnp.asarray(feats), train=False)
    want_proj = jtr.apply(tv, want, method=jtr.nce_project)
    return tc, tv, feats, np.asarray(want), np.asarray(want_proj)


@pytest.mark.parametrize("kernels", ["cuda", "plain"])
@pytest.mark.parametrize("geometry", list(GEOMETRY))
def test_nar_transformer_tslma_matches_jax(geometry, kernels):
    tc, tv, feats, want, want_proj = _model_case(geometry)
    assert tc.transformer.tslma and tc.transformer.fused_attention
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"), tv)
    use_kernels(tr, kernels)
    with torch.inference_mode():
        got = tr(t(feats))
        proj = tr.nce_project(got)
    assert got.shape == (2, GEOMETRY[geometry][1], 8, 8, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(proj.numpy(), want_proj, rtol=0, atol=1e-5)


def test_tslma_parameter_tree_round_trips():
    tc, tv, *_ = _model_case("nar_mnist")
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"), tv)
    names = {n for n, _ in tr.named_parameters()}
    for i in range(tc.transformer.num_decoder_layers):
        assert not any(n.startswith(f"dec_block{i}.enc_dec.") for n in names)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            assert f"dec_block{i}.tslma.attn.{proj}.weight" in names
    want = tc.transformer
    np.testing.assert_array_equal(
        tr.pos3d.numpy(), position_embedding_3d(want.num_past_frames + want.num_future_frames,
                                                want.window_size, want.window_size, D).numpy())
    back = export_jax_variables(tr)
    for col in ("params", "batch_stats"):
        flat = lambda tree, p=(): [x for k, v in tree.items() for x in (
            flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)])]
        got, exp = dict(flat(back[col])), dict(flat(tv[col]))
        assert got.keys() == exp.keys()
        for path in exp:
            np.testing.assert_array_equal(got[path], exp[path], err_msg="/".join(path))
    assert "tslma" in back["params"]["dec_block0"]


def test_build_transformer_takes_tslma_and_needs_a_width_divisible_by_3():
    _, tc = small_nar_cfgs(3, 3, tslma=True)
    tr = build_transformer(tc.transformer, device="cpu")
    assert tr.dec_block1.use_tslma and tuple(tr.pos3d.shape) == (6, 4, 4, 48)
    _, tc = small_nar_cfgs(3, 3, tslma=True, d_model=44)
    with pytest.raises(ValueError, match="divisible by 3"):
        build_transformer(tc.transformer, device="cpu")
