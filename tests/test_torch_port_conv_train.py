"""One FAR training step on the conv-FFN kernel route with the folded
temporal sublayer (``fused_conv_ffn`` and ``fused_full_temporal`` on, with
the preset's fused attention) against the JAX package's, on the CPU, the
JAX kernels #1/#3 and #11/#12 in Pallas interpret mode (the NAR step:
``test_torch_port_conv_nar_train.py``).

(z) the protocol and tolerances of ``test_torch_port_train.py`` (f)
    (``check_far_train_step``: losses, every gradient leaf, the parameters
    after clip -> AdamW for f32 and bf16 first moments) at dropout =
    drop_path = 0;
(z') a train-mode step at the preset's dropout rates, whose draws a cloned
    state replays exactly, with no launch on CPU tensors.
"""

import numpy as np
import torch

from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.ops.conv_ln_gelu import conv_ln_gelu
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_far_train_state
from vptr_tpu_torch.train.steps import make_far_train_step

from _torch_port_util import small_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_train import check_far_train_step

FLAGS = dict(fused_attention=True, fused_full=True, fused_conv_ffn=True,
             fused_full_temporal=True)


def test_far_conv_route_step_matches_jax():
    check_far_train_step(FLAGS, weighted=False)


def test_far_conv_route_step_with_dropout_repeats():
    _, tc = small_cfgs()
    tc = tc.override({"transformer": FLAGS})
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    tr = build_transformer(tc.transformer, device="cpu",
                           generator=torch.Generator().manual_seed(8))
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    state = create_far_train_state(enc, dec, tr, opt, seed=9)
    twin = state.clone()
    step = make_far_train_step(enc, dec, tr, opt, tc.loss)
    frames = t(np.random.default_rng(95).uniform(0, 1, (2, 6, 64, 64, 1)))
    s1, m1 = step(state, frames[:, :3], frames[:, 3:])
    s2, m2 = step(twin, frames[:, :3], frames[:, 3:])
    assert tc.transformer.dropout > 0
    assert all(bool(torch.isfinite(v)) for v in m1.values())
    assert float(m1["T_total"]) == float(m2["T_total"])
    for (n, a), b in zip(s1.transformer.named_parameters(),
                         s2.transformer.parameters()):
        assert torch.equal(a, b), n
    # on CPU tensors the wrapper takes the plain versions: no launches
    assert conv_ln_gelu.launches == conv_ln_gelu.bwd_launches == 0
