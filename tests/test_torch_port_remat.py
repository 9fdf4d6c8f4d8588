"""``transformer.remat`` in the port (``models/transformer.py::
checkpoint_block``) and the steps' ``remat_decoder``, on the CPU.

(a) FAR (the default route, the fused-FFN route, the conv-FFN route) and
    NAR (the default route, with TSLMA) train steps at the preset's
    dropout and DropPath 0.1, remat off against remat on with the decoder
    checkpointed too, from one seed: every metric, every gradient, every
    parameter after the step, the generator's state after the step and the
    BatchNorm running statistics (the NAR encoder's conv FFN) bit-equal;
    every block ran twice in the remat step (the forward, then the
    backward's recompute) and once without; the transformer's forward
    kept a fraction of the bytes for autograd;
(b) in eval mode and under ``no_grad`` remat changes nothing: each block
    runs once, the output is the same;
(c) the NAR remat step (``remat`` and ``remat_decoder`` on both sides)
    against the JAX package's (``nn.remat`` blocks, ``jax.checkpoint``
    decoder) at dropout 0, by the protocol and tolerances of
    ``test_torch_port_nar_train.py::check_train_step`` (the attention in
    plain arithmetic on both sides: the JAX package's interpret-mode
    kernels cost seconds a call).

Sizes: far_mnist / nar_mnist cut as ``_torch_port_util.SMALL`` (d 48 over
4 heads, 2 layers, NAR 2 + 2, Tp = Tf = 3, AE ngf 8); f32.
"""

import numpy as np
import pytest
import torch

from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.transformer import EncoderBlock, DecoderBlockNAR, build_transformer
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_far_train_state
from vptr_tpu_torch.train.steps import make_far_train_step, make_nar_train_step

from test_torch_port_nar_train import check_train_step
from _torch_port_util import small_cfgs, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

FAR_ROUTES = {"default": {},
              "ffn": {"fused_ffn": True, "fused_dw": True},
              "conv": {"fused_conv_ffn": True, "fused_full_temporal": True}}
CASES = {**{f"far_{k}": ("far", v) for k, v in FAR_ROUTES.items()},
         "nar_default": ("nar", {}), "nar_tslma": ("nar", {"tslma": True})}


def _cfg(kind, flags):
    _, tc = small_cfgs() if kind == "far" else small_nar_cfgs()
    return tc.override({"transformer": flags})


def _setup(kind, flags, remat):
    """A fresh state over seeded modules (the same weights for either
    ``remat``), its step (``remat_decoder`` = ``remat``), a batch."""
    tc = _cfg(kind, {**flags, "remat": remat})
    enc, dec = build_autoencoder(tc.ae, device="cpu", generator=torch.Generator().manual_seed(1))
    tr = build_transformer(tc.transformer, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    state = create_far_train_state(enc, dec, tr, opt, seed=3)
    make = make_far_train_step if kind == "far" else make_nar_train_step
    step = make(enc, dec, tr, opt, tc.loss, remat_decoder=remat)
    frames = t(np.random.default_rng(4).uniform(0, 1, (2, 6, 64, 64, 1)))
    return state, step, (frames[:, :3], frames[:, 3:])


class _Calls:
    """Counts the forward calls of every transformer block of a model."""

    def __init__(self, model):
        self.n = 0
        blocks = [m for m in model.modules() if isinstance(m, (EncoderBlock, DecoderBlockNAR))]
        self.blocks = len(blocks)
        for b in blocks:
            b.register_forward_pre_hook(self._hook)

    def _hook(self, *_):
        self.n += 1


def _saved_bytes(fn):
    """(bytes autograd saved for the backward outside any checkpointed
    region while ``fn`` ran, its result)."""
    total = 0

    def pack(x):
        nonlocal total
        total += x.numel() * x.element_size()
        return x
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = fn()
    return total, out


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_is_bit_equal(case):
    """(a)"""
    kind, flags = CASES[case]
    runs = {}
    for remat in (False, True):
        state, step, (past, future) = _setup(kind, flags, remat)
        calls = _Calls(state.transformer)
        state, m = step(state, past, future)
        runs[remat] = (state, m, calls)
    (s0, m0, c0), (s1, m1, c1) = runs[False], runs[True]
    assert s1.transformer.remat and not s0.transformer.remat
    assert (c0.n, c1.n) == (c0.blocks, 2 * c1.blocks)
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), (k, float(m0[k]), float(m1[k]))
    assert float(m0["T_total"]) > 0
    p0, p1 = dict(s0.transformer.named_parameters()), dict(s1.transformer.named_parameters())
    for n, p in p0.items():
        assert torch.equal(p, p1[n]), n
        assert torch.equal(p.grad, p1[n].grad), n
    b0, b1 = dict(s0.transformer.named_buffers()), dict(s1.transformer.named_buffers())
    stats = [n for n in b0 if n.endswith(("running_mean", "running_var"))]
    assert (len(stats) > 0) == (kind == "nar")
    for n in b0:
        assert torch.equal(b0[n], b1[n]), n
    assert torch.equal(s0.generator.get_state(), s1.generator.get_state())
    # the statistics moved once: a second update would leave them elsewhere
    fresh, _, _ = _setup(kind, flags, False)
    for n in stats:
        assert not torch.equal(dict(fresh.transformer.named_buffers())[n], b1[n]), n


@pytest.mark.parametrize("kind", ["far", "nar"])
def test_remat_keeps_fewer_activations_and_is_inert_in_eval(kind):
    """(a)'s memory, and (b)."""
    feats = t(np.random.default_rng(5).standard_normal((2, 3, 8, 8, 48)))
    out, kept = {}, {}
    for remat in (False, True):
        tc = _cfg(kind, {"remat": remat})
        tr = build_transformer(tc.transformer, device="cpu",
                               generator=torch.Generator().manual_seed(2))
        calls = _Calls(tr)
        with torch.no_grad():
            out[remat, "eval"] = tr(feats)
        tr.train()
        with torch.no_grad():
            out[remat, "no_grad"] = tr(feats, generator=torch.Generator().manual_seed(6))
        assert calls.n == 2 * calls.blocks
        kept[remat], out[remat, "train"] = _saved_bytes(
            lambda: tr(feats, generator=torch.Generator().manual_seed(6)))
        assert calls.n == 3 * calls.blocks
    for mode in ("eval", "no_grad", "train"):
        assert torch.equal(out[False, mode], out[True, mode]), mode
    # what remat keeps: each block's inputs, not its activations
    assert kept[True] < kept[False] / 4, kept


def test_nar_remat_step_matches_jax():
    """(c): remat encoder and decoder blocks and a checkpointed decoder in
    both packages, the BatchNorm statistics included (FAR's blocks are the
    NAR encoder's class; its remat step is held against remat off in
    (a))."""
    check_train_step({"fused_attention": False, "fused_full": False, "remat": True}, 3,
                     weighted=False, remat_decoder=True)
