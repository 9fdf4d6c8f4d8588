"""The port's loader of the reference's ``epoch_N.tar`` checkpoints
(``vptr_tpu_torch.utils.torch_import``) against the JAX package's
(``vptr_tpu.utils.torch_import``), on the CPU.

The reference modules are the torch re-derivations of
``tests/_torch_port_upstream.py``, seeded, with random BatchNorm
statistics; every file is written there in the whole ``save_ckpt``
envelope (a ``loss_dict`` whose class cannot be imported, a real optimizer
state, the ``code`` bytes, DataParallel's ``module.`` prefix).

(a) each mapping of the port's copy gives, leaf for leaf and bit for bit,
    what the JAX package's gives: the encoder (reflect and zero padding),
    the decoder, the PatchGAN, FAR with and without RPE, NAR with RPE and
    with TSLMA;
(b) a ``.tar`` loads through both packages' ``import_reference_checkpoint``
    to equal trees;
(c) the port's forward (f32, eval mode, the kernels' plain versions) on the
    loaded weights against the JAX package's and the re-derivation's;
(d) the geometry detection at other downsampling and residual-block
    counts, reflect and zero padding;
(e) ``state_with_reference_weights`` on a stage-2 and a stage-1 state:
    the file's modules loaded into a new state, the others and the given
    state as they were, a geometry that does not fit raises.

Tolerances: port vs JAX 1e-4 absolute (``test_torch_port_models.py``'s:
f32 summation order over a few layers); port vs the re-derivation 2e-4
absolute (its attention is ``nn.MultiheadAttention``'s arithmetic, and
its LayerNorms torch's own).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu.utils import torch_import as jimport
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.discriminator import build_discriminator
from vptr_tpu_torch.models.position import position_embedding_1d, position_embedding_2d
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_ae_train_state, create_far_train_state
from vptr_tpu_torch.utils import torch_import as timport
from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

from _torch_port_upstream import (
    TorchFAR,
    TorchNAR,
    TorchSLMHSA,
    TorchVPTRDec,
    TorchVPTRDisc,
    TorchVPTREnc,
    decode_clips,
    encode_clips,
    randomize_bn,
    state_numpy,
    write_reference_tar,
)
from _torch_port_util import small_cfgs, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

DIM, HEADS, WIN = 48, 4, 4
JAX_ATOL, TORCH_ATOL = 1e-4, 2e-4
# the attention in plain arithmetic on both sides (the JAX package's
# Pallas kernels in interpret mode cost seconds a call; the kernel routes
# are held against JAX in test_torch_port_models.py and the train tests)
UNFUSED = {"transformer": {"fused_attention": False, "fused_full": False}}


def _seeded(cls, seed, *args, **kw):
    torch.manual_seed(seed)
    m = cls(*args, **kw).eval()
    randomize_bn(m, torch.Generator().manual_seed(seed))
    return m


def _far(seed, layers=2, rpe=False):
    m = _seeded(TorchFAR, seed, layers, DIM, HEADS, WIN, 8, 8)
    if rpe:
        for layer in m.transformer.encoder.layers:
            layer.SLMHSA = TorchSLMHSA(DIM, HEADS, WIN, True)
    return m


def _tslma_keys(sd):
    """A NAR state_dict renamed to the TSLMA decoder's keys."""
    return {k.replace(".EncDecAttn.", ".TSLMA.attn."): v for k, v in sd.items()}


def _assert_trees_equal(got, want, where=""):
    assert set(got) == set(want), (where, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
        else:
            assert np.array_equal(got[k], want[k]), f"{where}/{k}"


# --------------------------------------------------------------- (a) mappings

MAPPINGS = {
    "enc_reflect": lambda: (state_numpy(_seeded(TorchVPTREnc, 1, ngf=8, feat_dim=DIM,
                                                n_res=2)),
                            "import_vptr_enc", dict(n_res_blocks=2)),
    "enc_zero": lambda: (state_numpy(_seeded(TorchVPTREnc, 2, ngf=8, feat_dim=DIM, nd=2,
                                             n_res=3, padding_type="zero")),
                         "import_vptr_enc", dict(n_downsampling=2, n_res_blocks=3,
                                                 padding_type="zero")),
    "dec": lambda: (state_numpy(_seeded(TorchVPTRDec, 3, ngf=8, feat_dim=DIM)),
                    "import_vptr_dec", {}),
    "disc": lambda: (state_numpy(_seeded(TorchVPTRDisc, 4, ndf=8)), "import_vptr_disc", {}),
    "far": lambda: (state_numpy(_far(5)), "import_far_transformer", dict(num_layers=2)),
    "far_rpe": lambda: (state_numpy(_far(6, rpe=True)), "import_far_transformer",
                        dict(num_layers=2, rpe=True)),
    "nar_rpe": lambda: (state_numpy(_seeded(TorchNAR, 7, 2, 2, DIM, HEADS, WIN, 8, 8, 3)),
                        "import_nar_transformer", dict(num_encoder_layers=2,
                                                       num_decoder_layers=2)),
    "nar_tslma": lambda: (_tslma_keys(state_numpy(_seeded(TorchNAR, 8, 2, 2, DIM, HEADS,
                                                           WIN, 8, 8, 3))),
                          "import_nar_transformer", dict(num_encoder_layers=2,
                                                         num_decoder_layers=2,
                                                         tslma=True)),
}


@pytest.mark.parametrize("kind", list(MAPPINGS))
def test_mapping_matches_jax(kind):
    sd, fn, kw = MAPPINGS[kind]()
    got = getattr(timport, fn)(sd, **kw)
    _assert_trees_equal(got, getattr(jimport, fn)(sd, **kw))
    assert "batch_stats" in got or kind.startswith("far")


# ------------------------------------------------------------ (b) the file

def test_tar_loads_through_both_packages(tmp_path):
    path = tmp_path / "epoch_3.tar"
    write_reference_tar(path, {
        "VPTR_Enc": _seeded(TorchVPTREnc, 11, ngf=8, feat_dim=DIM, n_res=2),
        "VPTR_Dec": _seeded(TorchVPTRDec, 12, ngf=8, feat_dim=DIM),
        "VPTR_Transformer": _seeded(TorchNAR, 13, 2, 2, DIM, HEADS, WIN, 8, 8, 3),
        "VPTR_Disc": _seeded(TorchVPTRDisc, 14, ndf=8)})
    got = timport.import_reference_checkpoint(str(path))
    want = jimport.import_reference_checkpoint(str(path))
    assert set(got) == {"VPTR_Enc", "VPTR_Dec", "VPTR_Transformer", "VPTR_Disc"}
    _assert_trees_equal(got, want)


# --------------------------------------------------------- (c) the forwards

def _far_models(tmp_path):
    """A FAR .tar's weights in the port's and the JAX package's modules, and
    the re-derivations: (port enc, dec, transformer), (JAX modules and
    variables), (torch enc, dec, transformer)."""
    jc, tc = (c.override(UNFUSED) for c in small_cfgs())
    tenc = _seeded(TorchVPTREnc, 21, ngf=8, feat_dim=DIM, n_res=1)
    tdec = _seeded(TorchVPTRDec, 22, ngf=8, feat_dim=DIM)
    tfar = _far(23)
    path = tmp_path / "epoch_5.tar"
    write_reference_tar(path, {"VPTR_Enc": tenc, "VPTR_Dec": tdec,
                               "VPTR_Transformer": tfar}, epoch=5)
    conv = timport.import_reference_checkpoint(str(path))
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    tr = build_transformer(tc.transformer, device="cpu", kernels="plain")
    for m, name in ((enc, "VPTR_Enc"), (dec, "VPTR_Dec"), (tr, "VPTR_Transformer")):
        load_jax_variables(m, conv[name])
    jenc, jdec = jbuild_ae(jc.ae)
    jv = jax.tree.map(jnp.asarray, conv)
    return (enc, dec, tr), (jenc, jdec, jbuild_tr(jc.transformer), jv), (tenc, tdec, tfar)


def test_far_forward_matches_jax_and_torch(tmp_path):
    (enc, dec, tr), (jenc, jdec, jtr, jv), (tenc, tdec, tfar) = _far_models(tmp_path)
    rng = np.random.default_rng(24)
    frames = rng.uniform(0, 1, (2, 5, 64, 64, 1)).astype(np.float32)
    lw = position_embedding_2d(WIN, WIN, DIM)
    tpos = position_embedding_1d(6, DIM)[:5]
    with torch.inference_mode():
        got_feat = enc(t(frames))
        got_lat = tr(got_feat)
        got = dec(got_lat)
        want_feat = encode_clips(tenc, t(frames))
        want_lat = tfar(want_feat, lw, tpos)
        want = decode_clips(tdec, want_lat)
    j_feat = jax.jit(jenc.apply)(jv["VPTR_Enc"], jnp.asarray(frames))
    j_lat = jax.jit(jtr.apply)(jv["VPTR_Transformer"], j_feat)
    j_out = jax.jit(jdec.apply)(jv["VPTR_Dec"], j_lat)
    for g, j, w in ((got_feat, j_feat, want_feat), (got_lat, j_lat, want_lat),
                    (got, j_out, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=JAX_ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TORCH_ATOL, rtol=0)


@pytest.mark.parametrize("tslma", [False, True])
def test_nar_forward_matches_jax_and_torch(tmp_path, tslma):
    """NAR with RPE (the re-derivation's enc-dec) or with TSLMA (the JAX
    package's only: the re-derivation has no TSLMA)."""
    jc, tc = small_nar_cfgs(3, 3, tslma=tslma, **UNFUSED["transformer"])
    tnar = _seeded(TorchNAR, 31, 2, 2, DIM, HEADS, WIN, 8, 8, 3)
    sd = state_numpy(tnar)
    if tslma:
        sd = _tslma_keys(sd)
        tnar = None
    path = tmp_path / "epoch_1.tar"
    write_reference_tar(path, {"VPTR_Transformer": _Keys(sd)}, epoch=1)
    conv = timport.import_reference_checkpoint(str(path))["VPTR_Transformer"]
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu",
                                              kernels="plain"), conv)
    jtr = jbuild_tr(jc.transformer)
    rng = np.random.default_rng(32)
    feats = rng.standard_normal((2, 3, 8, 8, DIM)).astype(np.float32) * 0.5
    with torch.inference_mode():
        got = tr(t(feats))
        got_nce = tr.nce_project(got)
    jv = jax.tree.map(jnp.asarray, conv)
    want_j = jax.jit(jtr.apply)(jv, jnp.asarray(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j), atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(got_nce.numpy(), np.asarray(jax.jit(partial(
        jtr.apply, method=jtr.nce_project))(jv, want_j)), atol=JAX_ATOL, rtol=0)
    if tnar is not None:
        with torch.inference_mode():
            want_t = tnar(t(feats), position_embedding_2d(WIN, WIN, DIM),
                          position_embedding_1d(6, DIM))
        np.testing.assert_allclose(got.numpy(), want_t.numpy(), atol=TORCH_ATOL, rtol=0)


class _Keys(torch.nn.Module):
    """A module whose state_dict is the given {key: array} as it stands."""

    def __init__(self, sd):
        super().__init__()
        self.sd = sd

    def state_dict(self, *a, **kw):
        return {k: torch.from_numpy(v) for k, v in self.sd.items()}


# ------------------------------------------------------- (d) the geometry

@pytest.mark.parametrize("nd,n_res,padding", [(2, 3, "zero"), (3, 1, "reflect"),
                                              (2, 2, "reflect")])
def test_geometry_detected(tmp_path, nd, n_res, padding):
    tenc = _seeded(TorchVPTREnc, 41, ngf=8, feat_dim=DIM, nd=nd, n_res=n_res,
                   padding_type=padding)
    tdec = _seeded(TorchVPTRDec, 42, ngf=8, feat_dim=DIM, nd=nd)
    tdisc = _seeded(TorchVPTRDisc, 43, ndf=8, n_layers=nd)
    path = tmp_path / "epoch_2.tar"
    write_reference_tar(path, {"VPTR_Enc": tenc, "VPTR_Dec": tdec, "VPTR_Disc": tdisc},
                        data_parallel=nd == 2)
    conv = timport.import_reference_checkpoint(str(path))
    _, tc = small_cfgs()
    tc = tc.override({"ae": {"n_downsampling": nd, "n_res_blocks": n_res,
                             "padding_type": padding}, "disc": {"ndf": 8, "n_layers": nd}})
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    load_jax_variables(enc, conv["VPTR_Enc"])
    load_jax_variables(dec, conv["VPTR_Dec"])
    disc = load_jax_variables(build_discriminator(tc.disc, device="cpu"), conv["VPTR_Disc"])
    frames = t(np.random.default_rng(44).uniform(0, 1, (2, 2, 64, 64, 1)))
    with torch.inference_mode():
        got, want = enc(frames), encode_clips(tenc, frames)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TORCH_ATOL, rtol=0)
        np.testing.assert_allclose(dec(got).numpy(), decode_clips(tdec, want).numpy(),
                                   atol=TORCH_ATOL, rtol=0)
        d_got = disc(frames[:, 0])
        d_want = tdisc(frames[:, 0].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(d_got.numpy(), d_want.numpy(), atol=TORCH_ATOL, rtol=0)


# ------------------------------------------------------- (e) train states

def test_state_with_reference_weights_far(tmp_path):
    (enc, dec, tr), _, (tenc, _, tfar) = _far_models(tmp_path)
    _, tc = small_cfgs()
    opt = build_optimizer(tc.optim, DIM)
    e0, d0 = build_autoencoder(tc.ae, device="cpu")
    state = create_far_train_state(e0, d0, build_transformer(tc.transformer, device="cpu"),
                                   opt, seed=0)
    before = {k: export_jax_variables(getattr(state, k)) for k in ("enc", "dec",
                                                                    "transformer")}
    path = tmp_path / "epoch_9.tar"
    write_reference_tar(path, {"VPTR_Enc": tenc, "VPTR_Transformer": tfar}, epoch=9)
    conv = timport.import_reference_checkpoint(str(path))
    new = timport.state_with_reference_weights(state, conv)
    for field, module in (("enc", enc), ("transformer", tr)):
        _assert_trees_equal(export_jax_variables(getattr(new, field)),
                            export_jax_variables(module), field)
    # the file has no decoder: it keeps its weights; the given state is as it was
    _assert_trees_equal(export_jax_variables(new.dec), before["dec"], "dec")
    for field, tree in before.items():
        _assert_trees_equal(export_jax_variables(getattr(state, field)), tree, field)
    assert new.transformer is not state.transformer and new.enc is not state.enc
    assert new.dec is state.dec
    assert new.step == state.step and new.generator is not state.generator
    # a geometry that does not fit raises
    wide = _seeded(TorchFAR, 25, 2, 2 * DIM, HEADS, WIN, 8, 8)
    write_reference_tar(path, {"VPTR_Transformer": wide}, epoch=9)
    with pytest.raises(ValueError, match="does not fit"):
        timport.state_with_reference_weights(
            state, timport.import_reference_checkpoint(str(path)))
    deep = _far(26, layers=3)
    write_reference_tar(path, {"VPTR_Transformer": deep}, epoch=9)
    with pytest.raises((KeyError, AttributeError), match="block2"):
        timport.state_with_reference_weights(
            state, timport.import_reference_checkpoint(str(path)))


def test_state_with_reference_weights_ae(tmp_path):
    _, tc = small_cfgs()
    tc = tc.override({"ae": {"n_res_blocks": 2}, "disc": {"ndf": 8}})
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    disc = build_discriminator(tc.disc, device="cpu")
    state = create_ae_train_state(enc, dec, disc, build_optimizer(tc.optim),
                                  build_optimizer(tc.optim_d), seed=0)
    disc_before = export_jax_variables(state.disc)
    tenc = _seeded(TorchVPTREnc, 51, ngf=8, feat_dim=DIM, n_res=2)
    tdec = _seeded(TorchVPTRDec, 52, ngf=8, feat_dim=DIM)
    path = tmp_path / "epoch_4.tar"
    write_reference_tar(path, {"VPTR_Enc": tenc, "VPTR_Dec": tdec,
                               "VPTR_Disc": _seeded(TorchVPTRDisc, 53, ndf=8)})
    conv = timport.import_reference_checkpoint(str(path))
    new = timport.state_with_reference_weights(state, conv)
    frames = t(np.random.default_rng(54).uniform(0, 1, (1, 2, 64, 64, 1)))
    with torch.inference_mode():
        got = new.dec.eval()(new.enc.eval()(frames))
        want = decode_clips(tdec, encode_clips(tenc, frames))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TORCH_ATOL, rtol=0)
    # the discriminator is never mapped
    _assert_trees_equal(export_jax_variables(new.disc), disc_before, "disc")
    assert new.g_opt_state is not state.g_opt_state
