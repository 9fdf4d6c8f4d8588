"""The NAR training and eval steps with ``transformer.tslma`` against the
JAX package's, on the CPU.

(x) one train step at dropout = drop_path = 0 on the fused route with TSLMA
    in every decoder block (Tp = Tf = 3: 48 query tokens over 48 keys a
    window, past the short kernels' 32), with the protocol and tolerances
    of ``test_torch_port_nar_train.py`` (``check_train_step``): the
    losses, every gradient leaf (``dec_block{i}.tslma.attn.*`` included),
    the parameters after clip -> AdamW and the BatchNorm statistics;
(y) a train step at the preset's dropout rates (TSLMA's attention dropout
    is the block's ``dropout``) runs, and a cloned state replays it
    exactly;
(z) the eval step's metrics (2e-6) and frames (1e-4) against
    ``make_nar_eval_step``'s, as ``test_torch_port_nar_train_routes.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vptr_tpu.train.steps import make_nar_eval_step as jmake_nar_eval_step
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_nar_train_state
from vptr_tpu_torch.train.steps import make_nar_eval_step, make_nar_train_step
from vptr_tpu_torch.utils.weights import load_jax_variables

from test_torch_port_nar_train import _grad_probe, _jax_state, _setup, check_train_step
from _torch_port_util import small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TSLMA = dict(fused_attention=True, fused_full=True, tslma=True)


def test_nar_train_step_tslma_matches_jax():
    check_train_step(TSLMA, 3, weighted=True, seed=80)


def test_nar_train_step_tslma_with_dropout_runs_and_repeats():
    s = _setup(TSLMA, 3, seed=82)
    enc, dec, _ = s["port"]
    _, tc = small_nar_cfgs(tslma=True)          # the preset's dropout rates
    assert tc.transformer.dropout > 0.0
    tr = load_jax_variables(build_transformer(tc.transformer, device="cpu"),
                            s["jvars"][2])
    assert tr.dec_block0.tslma.attn.dropout == tc.transformer.dropout
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    state = create_nar_train_state(enc, dec, tr, opt, seed=5)
    twin = state.clone()
    step = make_nar_train_step(enc, dec, tr, opt, tc.loss)
    frames = t(np.concatenate([s["past"], s["future"]], axis=1))
    s1, m1 = step(state, frames[:, :3], frames[:, 3:])
    s2, m2 = step(twin, frames[:, :3], frames[:, 3:])
    assert all(bool(torch.isfinite(v)) for v in m1.values())
    assert float(m1["T_total"]) == float(m2["T_total"])
    b1, b2 = s1.transformer.state_dict(), s2.transformer.state_dict()
    for n in b1:
        assert torch.equal(b1[n], b2[n]), n
    start = s["jvars"][2]["params"]["dec_block0"]["tslma"]["attn"]["q_proj"]["kernel"]
    assert not torch.equal(s1.transformer.dec_block0.tslma.attn.q_proj.weight,
                           torch.from_numpy(np.ascontiguousarray(start.T)))


def test_nar_eval_step_tslma_matches_jax():
    s = _setup(TSLMA, 3, seed=81)
    (jenc, jdec, jtr) = s["jmods"]
    jstep = jax.jit(jmake_nar_eval_step(jenc, jdec, jtr, s["jc"].loss))
    jm, jpred = jstep(_jax_state(s["jvars"], _grad_probe()),
                      jnp.asarray(s["past"]), jnp.asarray(s["future"]))
    enc, dec, tr = s["port"]
    state = create_nar_train_state(enc, dec, tr, build_optimizer(s["tc"].optim, 48))
    m, pred = make_nar_eval_step(enc, dec, tr, s["tc"].loss)(
        state, t(s["past"]), t(s["future"]))
    assert set(m) == set(jm)
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= 2e-6, k
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-4)
