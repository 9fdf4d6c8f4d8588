"""Load the reference VPTR checkpoints (``epoch_N.tar``) into the port.

Counterpart of ``vptr_tpu/utils/torch_import.py``; this module keeps its
own copy of the mappings. They turn a reference ``state_dict`` (the
reference's module naming) into the JAX package's variable trees, and the
port loads those with :func:`vptr_tpu_torch.utils.weights.load_jax_variables`
(its module names are the JAX tree's), so the upstream layout is mapped in
one place:

* ``import_vptr_enc`` / ``import_vptr_dec`` -- the conv autoencoder
  (reference: model/ResNetAutoEncoder.py:8-101, nn.Sequential index layout)
* ``import_vptr_disc`` -- the PatchGAN discriminator
  (reference: model/VPTR_modules.py:68-92)
* ``import_far_transformer`` / ``import_nar_transformer`` -- VidHRFormer
  (reference: model/VidHRFormer_modules.py:30-211; both the packed
  nn.MultiheadAttention in_proj layout and the RPE variant's split
  q/k/v projections, MultiHeadAttentionRPE.py:50-53)
* :func:`import_reference_checkpoint` -- a whole ``epoch_N.tar`` written by
  the reference's save_ckpt (utils/train_summary.py:130-160), its geometry
  detected from the keys;
* :func:`state_with_reference_weights` -- a port train state with those
  weights in its encoder, decoder and transformer.

The mappings take ``{name: np.ndarray}`` dicts and return ``{"params": ...,
"batch_stats": ...}`` trees of numpy arrays (batch_stats only where the
architecture has BatchNorm).

Layout conventions (reference -> JAX tree):
    Linear  w (out, in)          -> kernel (in, out):        w.T
    Conv2d  w (out, in, kh, kw)  -> kernel (kh, kw, in, out): transpose(2,3,1,0)
    depthwise Conv2d (C,1,k,k)   -> kernel (k, k, 1, C):      transpose(2,3,1,0)
    ConvT2d w (in, out, kh, kw)  -> kernel (kh, kw, in, out): transpose(2,3,0,1)
    LayerNorm((C,H,W)) w (C,H,W) -> scale (H, W, C):          transpose(1,2,0)
    packed MHA in_proj (3C, C)   -> three (C, C) kernels, transposed

A checkpoint file is a pickle: loading one runs code from it
(``torch.load(..., weights_only=False)``, which the envelope's pickled
classes need). Load only files you trust.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np

Array = np.ndarray
StateDict = Dict[str, Array]

# the reference's module-dict names -> the fields of the port's train states
# (the JAX package maps no discriminator here, and neither does the port)
STATE_FIELDS = {"VPTR_Enc": "enc", "VPTR_Dec": "dec",
                "VPTR_Transformer": "transformer"}


def _linear(sd: StateDict, key: str) -> dict:
    out = {"kernel": np.ascontiguousarray(sd[f"{key}.weight"].T)}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def _conv(sd: StateDict, key: str) -> dict:
    out = {"kernel": np.ascontiguousarray(
        sd[f"{key}.weight"].transpose(2, 3, 1, 0))}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def _conv_t(sd: StateDict, key: str) -> dict:
    out = {"kernel": np.ascontiguousarray(
        sd[f"{key}.weight"].transpose(2, 3, 0, 1))}
    if f"{key}.bias" in sd:
        out["bias"] = sd[f"{key}.bias"]
    return out


def _ln(sd: StateDict, key: str) -> dict:
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _ln_hwc(sd: StateDict, key: str) -> dict:
    """torch LayerNorm((C, H, W)) -> LayerNormHWC (H, W, C)."""
    return {"scale": np.ascontiguousarray(sd[f"{key}.weight"].transpose(1, 2, 0)),
            "bias": np.ascontiguousarray(sd[f"{key}.bias"].transpose(1, 2, 0))}


def _bn_params(sd: StateDict, key: str) -> dict:
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _bn_stats(sd: StateDict, key: str) -> dict:
    return {"mean": sd[f"{key}.running_mean"],
            "var": sd[f"{key}.running_var"]}


def _packed_mha(sd: StateDict, key: str) -> dict:
    """nn.MultiheadAttention (packed in_proj) -> separate q/k/v/out Dense."""
    w = sd[f"{key}.in_proj_weight"]          # (3C, C)
    b = sd[f"{key}.in_proj_bias"]
    c = w.shape[1]
    names = ("q_proj", "k_proj", "v_proj")
    out = {n: {"kernel": np.ascontiguousarray(w[i * c:(i + 1) * c].T),
               "bias": b[i * c:(i + 1) * c]} for i, n in enumerate(names)}
    out["out_proj"] = _linear(sd, f"{key}.out_proj")
    return out


def _split_mha(sd: StateDict, key: str) -> dict:
    """MultiheadAttentionRPE's separate projections
    (reference: MultiHeadAttentionRPE.py:50-53)."""
    return {n: _linear(sd, f"{key}.{n}")
            for n in ("q_proj", "k_proj", "v_proj", "out_proj")}


# ---------------------------------------------------------------------------
# Autoencoder (nn.Sequential index layout, ResNetAutoEncoder.py:26-48, 70-101)
# ---------------------------------------------------------------------------

def _res_block(sd: StateDict, key: str, padding_type: str,
               use_dropout: bool):
    """ResnetBlock conv_block indices (ResNetAutoEncoder.py:117-158):
    [pad?] conv norm relu [dropout?] [pad?] conv norm."""
    pad = 0 if padding_type == "zero" else 1
    i1 = pad                     # conv1
    n1 = i1 + 1
    i2 = n1 + 2 + (1 if use_dropout else 0) + pad   # relu(+dropout)(+pad)
    n2 = i2 + 1
    params = {"conv1": _conv(sd, f"{key}.conv_block.{i1}"),
              "na1": {"BatchNorm_0": _bn_params(sd, f"{key}.conv_block.{n1}")},
              "conv2": _conv(sd, f"{key}.conv_block.{i2}"),
              "na2": {"BatchNorm_0": _bn_params(sd, f"{key}.conv_block.{n2}")}}
    stats = {"na1": {"BatchNorm_0": _bn_stats(sd, f"{key}.conv_block.{n1}")},
             "na2": {"BatchNorm_0": _bn_stats(sd, f"{key}.conv_block.{n2}")}}
    return params, stats


def import_vptr_enc(sd: StateDict, n_downsampling: int = 3,
                    n_res_blocks: int = 9, padding_type: str = "reflect",
                    use_dropout: bool = False) -> dict:
    """VPTREnc state_dict (keys ``encoder.model.*``) -> variables of the
    port's ``VPTREnc``.

    ``padding_type`` shifts only the residual blocks' inner indices: the
    stem's ReflectionPad2d(3) is unconditional (ResNetAutoEncoder.py:26),
    so the stem conv sits at index 1 for every padding mode."""
    base = "encoder.model"
    stem = 1                        # conv right after the stem reflect pad
    params = {"stem": _conv(sd, f"{base}.{stem}"),
              "stem_na": {"BatchNorm_0": _bn_params(sd, f"{base}.{stem + 1}")}}
    stats = {"stem_na": {"BatchNorm_0": _bn_stats(sd, f"{base}.{stem + 1}")}}
    idx = stem + 3
    for i in range(n_downsampling - 1):
        params[f"down{i}"] = _conv(sd, f"{base}.{idx}")
        params[f"down{i}_na"] = {"BatchNorm_0": _bn_params(sd, f"{base}.{idx + 1}")}
        stats[f"down{i}_na"] = {"BatchNorm_0": _bn_stats(sd, f"{base}.{idx + 1}")}
        idx += 3
    params["down_last"] = _conv(sd, f"{base}.{idx}")
    params["down_last_na"] = {"BatchNorm_0": _bn_params(sd, f"{base}.{idx + 1}")}
    stats["down_last_na"] = {"BatchNorm_0": _bn_stats(sd, f"{base}.{idx + 1}")}
    idx += 3
    for i in range(n_res_blocks):
        p, s = _res_block(sd, f"{base}.{idx + i}", padding_type, use_dropout)
        params[f"res{i}"] = p
        stats[f"res{i}"] = s
    return {"params": {"encoder": params},
            "batch_stats": {"encoder": stats}}


def import_vptr_dec(sd: StateDict, n_downsampling: int = 3) -> dict:
    """VPTRDec state_dict (keys ``decoder.model.*``) -> variables of the
    port's ``VPTRDec``."""
    base = "decoder.model"
    params, stats = {}, {}
    for i in range(n_downsampling):
        params[f"up{i}"] = _conv_t(sd, f"{base}.{3 * i}")
        params[f"up{i}_na"] = {"BatchNorm_0": _bn_params(sd, f"{base}.{3 * i + 1}")}
        stats[f"up{i}_na"] = {"BatchNorm_0": _bn_stats(sd, f"{base}.{3 * i + 1}")}
    params["head"] = _conv(sd, f"{base}.{3 * n_downsampling + 1}")
    return {"params": {"decoder": params},
            "batch_stats": {"decoder": stats}}


def import_vptr_disc(sd: StateDict, n_layers: int = 3) -> dict:
    """VPTRDisc (PatchGAN) state_dict -> variables of the port's
    ``PatchDiscriminator``.

    The reference's Sequential layout (reference: model/VPTR_modules.py:68-92,
    batch-norm case): index 0 = stem conv (bias), then per growth step
    n=1..n_layers-1 a (conv, BN, LeakyReLU) triple at 3n-1..3n+1, the
    stride-1 conv/BN at 3*n_layers-1 and 3*n_layers, and the 1-channel head
    at 3*n_layers+2."""
    params = {"conv0": _conv(sd, "model.0")}
    stats = {}
    for n in range(1, n_layers + 1):
        params[f"conv{n}"] = _conv(sd, f"model.{3 * n - 1}")
        params[f"norm{n}"] = _bn_params(sd, f"model.{3 * n}")
        stats[f"norm{n}"] = _bn_stats(sd, f"model.{3 * n}")
    params["head"] = _conv(sd, f"model.{3 * n_layers + 2}")
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# VidHRFormer (VidHRFormer_modules.py:30-211)
# ---------------------------------------------------------------------------

def _slmhsa(sd: StateDict, key: str, rpe: bool) -> dict:
    """SpatialLocalMultiheadAttention: packed nn.MHA when rpe=False, split
    projections + bias table when rpe=True (VidHRFormer_modules.py:310-319)."""
    out = {"attn": (_split_mha(sd, f"{key}.attn") if rpe
                    else _packed_mha(sd, f"{key}.attn"))}
    if rpe:
        out["rpe_table"] = sd[f"{key}.attn.relative_position_bias_table"]
    return out


def _mlp_dwbn(sd: StateDict, key: str, layer_norm: bool):
    """MlpDWBN: fc1/dw3x3/fc2 convs + three norms (layer when AR_model)."""
    params = {"fc1": _conv(sd, f"{key}.fc1"),
              "dw3x3": _conv(sd, f"{key}.dw3x3"),
              "fc2": _conv(sd, f"{key}.fc2")}
    stats = {}
    for j in (1, 2, 3):
        if layer_norm:
            params[f"norm{j}"] = _ln_hwc(sd, f"{key}.norm{j}")
        else:
            params[f"norm{j}"] = _bn_params(sd, f"{key}.norm{j}")
            stats[f"norm{j}"] = _bn_stats(sd, f"{key}.norm{j}")
    return params, stats


def _enc_block(sd: StateDict, key: str, rpe: bool, far: bool):
    """VidHRFormerBlockEnc -> EncoderBlock params (+batch_stats when the
    conv-FFN uses BatchNorm, i.e. the NAR encoder)."""
    params = {
        "slmhsa": _slmhsa(sd, f"{key}.SLMHSA", rpe),
        "temporal": {"attn": _packed_mha(sd, f"{key}.temporal_MHSA")},
        "ffn": {"linear1": _linear(sd, f"{key}.linear1"),
                "linear2": _linear(sd, f"{key}.linear2")},
    }
    for j in (1, 2, 3, 4):
        params[f"norm{j}"] = _ln(sd, f"{key}.norm{j}")
    ffn_params, ffn_stats = _mlp_dwbn(sd, f"{key}.SpatialFFN",
                                      layer_norm=far)
    params["spatial_ffn"] = ffn_params
    stats = {"spatial_ffn": ffn_stats} if ffn_stats else {}
    return params, stats


def _dec_block(sd: StateDict, key: str, rpe: bool, tslma: bool):
    """VidHRFormerBlockDecNAR -> DecoderBlockNAR params (all-LayerNorm)."""
    params = {
        "slmhsa": _slmhsa(sd, f"{key}.SLMHSA", rpe),
        "temporal": {"attn": _packed_mha(sd, f"{key}.temporal_MHSA")},
        "ffn": {"linear1": _linear(sd, f"{key}.linear1"),
                "linear2": _linear(sd, f"{key}.linear2")},
    }
    for j in (1, 2, 3, 4, 5, 6):
        params[f"norm{j}"] = _ln(sd, f"{key}.norm{j}")
    params["spatial_ffn"] = _mlp_dwbn(sd, f"{key}.SpatialFFN", True)[0]
    # reference names the post-enc-dec conv FFN "SpatialFFN1"
    params["spatial_ffn2"] = _mlp_dwbn(sd, f"{key}.SpatialFFN1", True)[0]
    if tslma:
        params["tslma"] = {"attn": _packed_mha(sd, f"{key}.TSLMA.attn")}
    else:
        params["enc_dec"] = {"attn": _packed_mha(sd, f"{key}.EncDecAttn")}
    return params


def import_far_transformer(sd: StateDict, num_layers: int = 12,
                           rpe: bool = False) -> dict:
    """VPTRFormerFAR state_dict -> variables of the port's unrolled
    ``VPTRFormerFAR`` (``block{i}``)."""
    params = {}
    for i in range(num_layers):
        p, _ = _enc_block(sd, f"transformer.encoder.layers.{i}", rpe,
                          far=True)
        params[f"block{i}"] = p
    params["final_norm"] = _ln(sd, "transformer.encoder.norm")
    return {"params": params}


def import_nar_transformer(sd: StateDict, num_encoder_layers: int = 4,
                           num_decoder_layers: int = 8, rpe: bool = True,
                           tslma: bool = False) -> dict:
    """VPTRFormerNAR state_dict -> variables of the port's unrolled
    ``VPTRFormerNAR``. The NAR encoder's conv FFN uses BatchNorm
    (AR_model=False, VidHRFormer_modules.py:40-43), so this returns
    batch_stats too."""
    params, stats = {}, {}
    for i in range(num_encoder_layers):
        p, s = _enc_block(sd, f"transformer.encoder.layers.{i}", rpe,
                          far=False)
        params[f"enc_block{i}"] = p
        if s:
            stats[f"enc_block{i}"] = s
    for i in range(num_decoder_layers):
        params[f"dec_block{i}"] = _dec_block(
            sd, f"transformer.decoder.layers.{i}", rpe, tslma)
    params["enc_norm"] = _ln(sd, "transformer.encoder.norm")
    params["dec_norm"] = _ln(sd, "transformer.decoder.norm")
    params["frame_queries"] = sd["frame_queries"]
    params["nce_fc1"] = _linear(sd, "NCE_projector.0")
    params["nce_fc2"] = _linear(sd, "NCE_projector.2")
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def _tolerant_pickle_module():
    """Pickle shim for the reference's checkpoint envelope.

    ``save_ckpt`` (reference: utils/train_summary.py:130-149) pickles more
    than tensors: ``loss_dict`` holds ``Loss_tuple`` instances whose class
    lives in the reference's own ``utils.train_summary`` module, and ``code``
    is a dict of source-file byte snapshots. Unpickling a genuine checkpoint
    here would raise ModuleNotFoundError on Loss_tuple. This shim resolves
    any unresolvable global to a plain stub class, so the envelope loads and
    the importer can pull out ``Module_state_dict`` and ignore the rest.
    """
    import pickle
    import types

    class _Stub:
        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)

    class _TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_Stub,), {"__module__": module})

    shim = types.ModuleType("vptr_tpu_torch._tolerant_pickle")
    shim.Unpickler = _TolerantUnpickler
    shim.load = lambda f, **kw: _TolerantUnpickler(f, **kw).load()
    shim.loads = pickle.loads
    shim.dumps = pickle.dumps
    shim.dump = pickle.dump
    return shim


def _layer_count(sd: StateDict, stack: str) -> int:
    return 1 + max(int(k.split(".")[3]) for k in sd
                   if k.startswith(f"transformer.{stack}.layers"))


def import_reference_checkpoint(path: str, map_location: str = "cpu") -> dict:
    """Load a reference ``epoch_N.tar`` (utils/train_summary.py:143-149) and
    convert every recognized module. Returns ``{module_name: variables}``
    keyed by the reference's module-dict names (VPTR_Enc / VPTR_Dec /
    VPTR_Transformer / VPTR_Disc); modules of no known layout are skipped.
    DataParallel's ``module.`` key prefix is stripped.

    The geometry comes from the keys: the encoder's downsamplings, residual
    blocks and their zero or reflect padding; the decoder's upsamplings;
    FAR or NAR, the layer counts, RPE and TSLMA; the PatchGAN's depth.

    Tolerates the full save_ckpt envelope: ``epoch``, ``loss_dict`` (pickled
    Loss_tuple instances from the reference's own module namespace),
    ``optimizer_state_dict``, and the ``code`` source-tree byte snapshot are
    all loaded (or stubbed) and ignored. The file is a pickle and loading it
    runs code from it: load only trusted files."""
    import torch

    ckpt = torch.load(path, map_location=map_location, weights_only=False,
                      pickle_module=_tolerant_pickle_module())
    modules = ckpt["Module_state_dict"]
    out = {}
    for name, sd in modules.items():
        sd = {k.removeprefix("module."): v.numpy() for k, v in sd.items()}
        if any(k.startswith("encoder.model") for k in sd):
            # detect geometry from the Sequential indices: res blocks carry
            # a .conv_block. segment; downsampling convs precede them
            res_idx = sorted({int(k.split(".")[2]) for k in sd
                              if ".conv_block." in k})
            # layout: pad,stem,bn,relu then 3 entries per downsampling, so
            # the first res block sits at index 3*n_down + 4
            n_res = len(res_idx)
            n_down = (res_idx[0] - 4) // 3 if res_idx else 3
            # zero padding has no pad layer inside the block, so the first
            # inner conv sits at conv_block.0 (ResNetAutoEncoder.py:128-138)
            pad_type = ("zero" if res_idx and
                        f"encoder.model.{res_idx[0]}.conv_block.0.weight"
                        in sd else "reflect")
            out[name] = import_vptr_enc(sd, n_downsampling=n_down,
                                        n_res_blocks=n_res,
                                        padding_type=pad_type)
        elif any(k.startswith("decoder.model") for k in sd):
            # ConvTranspose+BN pairs sit at indices (0,1), (3,4), ...
            idxs = sorted({int(k.split(".")[2]) for k in sd
                           if k.startswith("decoder.model")})
            n_down = sum(1 for i in idxs if i % 3 == 0 and i + 1 in idxs)
            out[name] = import_vptr_dec(sd, n_downsampling=n_down)
        elif any(k.startswith("transformer.decoder") for k in sd):
            rpe = any("relative_position_bias_table" in k for k in sd)
            tslma = any(".TSLMA." in k for k in sd)
            out[name] = import_nar_transformer(sd, _layer_count(sd, "encoder"),
                                               _layer_count(sd, "decoder"), rpe, tslma)
        elif any(k.startswith("transformer.encoder") for k in sd):
            rpe = any("relative_position_bias_table" in k for k in sd)
            out[name] = import_far_transformer(sd, _layer_count(sd, "encoder"), rpe)
        elif any(k.startswith("model.0.") for k in sd) and \
                any(k.endswith("running_mean") for k in sd):
            # PatchGAN disc: flat Sequential of convs + BNs; head conv sits
            # at 3*n_layers+2 (model/VPTR_modules.py:68-92)
            max_idx = max(int(k.split(".")[1]) for k in sd)
            out[name] = import_vptr_disc(sd, n_layers=(max_idx - 2) // 3)
    return out


def state_with_reference_weights(state, converted: dict):
    """A new train state (``state.clone()``: a ``Stage2TrainState`` or an
    ``AETrainState``) whose encoder, decoder and transformer hold the
    weights of :func:`import_reference_checkpoint`'s output (keys VPTR_Enc
    / VPTR_Dec / VPTR_Transformer; ``state`` is left as it was). A module
    the file lacks keeps its weights; the discriminator is never mapped.
    Each module is loaded on the CPU by
    :func:`~vptr_tpu_torch.utils.weights.load_jax_variables`, then moved
    back to the device it was on; a geometry that does not fit the
    configured modules raises there (a shape, a missing or an extra leaf).
    The optimizer states are kept, as the JAX package keeps them."""
    from vptr_tpu_torch.utils.weights import load_jax_variables

    new = state.clone()
    for name, variables in converted.items():
        field = STATE_FIELDS.get(name)
        module = None if field is None else getattr(new, field, None)
        if module is None:
            continue
        if module is getattr(state, field):     # a stage-2 clone shares its AE
            module = copy.deepcopy(module)
        device = next(module.parameters()).device
        load_jax_variables(module.cpu(), variables)
        setattr(new, field, module.to(device))
    return new
