"""One FAR training step on the fused feed-forward route (``fused_ffn`` and
``fused_dw`` on, with the preset's fused attention) against the JAX
package's, on the CPU: the protocol of ``test_torch_port_train.py`` (f),
with dropout = drop_path = 0 (losses, every gradient leaf, the parameters
after clip -> AdamW for f32 and bf16 first moments; the same tolerances),
the JAX kernels #7-#10 in Pallas interpret mode; and a train-mode step at
the preset's dropout rates, whose draws (the kernels' hidden-dropout seeds
among them) a cloned state replays exactly.
"""

import numpy as np
import pytest
import torch

from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.ops.fused_dw_chain import fused_dw_chain
from vptr_tpu_torch.ops.fused_ffn import fused_ffn
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_far_train_state
from vptr_tpu_torch.train.steps import make_far_train_step

from _torch_port_util import small_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_train import check_far_train_step

FLAGS = dict(fused_attention=True, fused_full=True, fused_ffn=True, fused_dw=True)


def test_far_fused_ffn_step_matches_jax():
    check_far_train_step(FLAGS, weighted=False)


def test_far_fused_ffn_step_with_dropout_repeats():
    _, tc = small_cfgs()
    tc = tc.override({"transformer": FLAGS})
    enc, dec = build_autoencoder(tc.ae, device="cpu")
    tr = build_transformer(tc.transformer, device="cpu",
                           generator=torch.Generator().manual_seed(6))
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    state = create_far_train_state(enc, dec, tr, opt, seed=7)
    twin = state.clone()
    step = make_far_train_step(enc, dec, tr, opt, tc.loss)
    frames = t(np.random.default_rng(94).uniform(0, 1, (2, 6, 64, 64, 1)))
    s1, m1 = step(state, frames[:, :3], frames[:, 3:])
    s2, m2 = step(twin, frames[:, :3], frames[:, 3:])
    assert tc.transformer.dropout > 0
    assert all(bool(torch.isfinite(v)) for v in m1.values())
    assert float(m1["T_total"]) == float(m2["T_total"])
    for (n, a), b in zip(s1.transformer.named_parameters(),
                         s2.transformer.parameters()):
        assert torch.equal(a, b), n
    # on CPU tensors the wrappers take the plain versions: no launches
    assert fused_ffn.launches == fused_dw_chain.launches == 0
