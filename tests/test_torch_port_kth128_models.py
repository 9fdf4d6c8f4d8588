"""nar_kth_128's 16 x 16 latent (16 windows a frame, a 16-wide grid for the
conv FFN's depthwise conv) on the two fused routes whose kernels this
geometry sends to their tiled routes on the card, against the JAX package,
on the CPU (the JAX kernels in Pallas interpret mode, the port's wrappers
on their plain versions):

(e) ``VPTRFormerNAR`` at SMALL widths (d 48, 4 heads, 2 + 2 layers, Tp =
    Tf = 3) on 16 x 16 latents in eval mode, through the kernel wrappers
    (their plain versions on CPU tensors), against JAX's from one set of
    random variables
    (``load_jax_variables``): the fused-FFN route (``fused_ffn`` +
    ``fused_dw``: #7 and #9 in the decoder, whose LayerNormHWC conv FFN
    hands #9 its (HW, C) affines at w 16) and the conv-FFN route
    (``fused_conv_ffn`` + ``fused_full_temporal``: #11 at both stages of
    the decoder's conv FFN, #1 on the temporal columns);
(one NAR train step on each route: ``test_torch_port_kth128_train.py``).

Tolerance 1e-4 absolute, as ``test_torch_port_nar_models.py`` (f32
summation order over the stack).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.ops.conv_ln_gelu import conv_ln_gelu
from vptr_tpu_torch.ops.fused_dw_chain import fused_dw_chain
from vptr_tpu_torch.utils.weights import load_jax_variables

from _torch_port_util import random_variables, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
ROUTES = {"fused_ffn": dict(fused_ffn=True, fused_dw=True),
          "conv_ffn": dict(fused_attention=True, fused_full=True, fused_conv_ffn=True,
                           fused_full_temporal=True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_nar_transformer_at_the_16x16_latent_matches_jax(route):
    jc, tc = small_nar_cfgs(3, 3, "nar_kth_128", dropout=0.0, drop_path=0.0,
                            **ROUTES[route])
    assert (tc.transformer.enc_h, tc.transformer.enc_w) == (16, 16)
    rng = np.random.default_rng(233)
    feats = rng.standard_normal((2, 3, 16, 16, 48)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer)
    tv = random_variables(partial(jtr.init, method="init_all"), rng, jnp.asarray(feats))
    want = np.asarray(jtr.apply(tv, jnp.asarray(feats), train=False))
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"), tv)
    with torch.inference_mode():
        got = tr(t(feats))
    assert got.shape == (2, 3, 16, 16, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # on CPU tensors the wrappers take the plain versions: no launches
    assert fused_dw_chain.launches == conv_ln_gelu.launches == 0

