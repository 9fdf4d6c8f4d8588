"""The NAR steps against the JAX package's on the other routes, on the CPU.

(q) one train step on the unfused route (projections and plain attention,
    LayerNorm outside the kernels) at Tp = Tf = 3, and on the fused route
    at Tp = 2 != Tf = 3 (the rectangular enc-dec attention on the
    attention-core wrapper, which the JAX package sends to XLA). The
    protocol and tolerances are ``test_torch_port_nar_train.py``'s
    (``check_train_step``): losses, every gradient leaf, the parameters
    after clip -> AdamW and the BatchNorm statistics;
(r) the eval step's metrics (``T_MSE``, ``T_GDL``, ``T_bpc``, ``T_total``
    with the NCE term folded in) and predicted frames against
    ``make_nar_eval_step``: 2e-6 absolute on the metrics (sums of three
    O(1) means), 1e-4 on the frames (as the module tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vptr_tpu.train.steps import make_nar_eval_step as jmake_nar_eval_step
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_nar_train_state
from vptr_tpu_torch.train.steps import make_nar_eval_step

from test_torch_port_nar_train import _grad_probe, _jax_state, _setup, check_train_step
from _torch_port_util import t

from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("route,past,seed", [("unfused", 3, 80),
                                             ("fused", 2, 84)])
def test_nar_train_step_route_matches_jax(route, past, seed):
    """``seed``: one whose predicted frames have no tied neighbouring
    pixels (see ``check_train_step``)."""
    check_train_step(route, past, weighted=False, seed=seed)


def test_nar_eval_step_matches_jax():
    s = _setup("fused", 3, seed=81)
    (jenc, jdec, jtr) = s["jmods"]
    jstep = jax.jit(jmake_nar_eval_step(jenc, jdec, jtr, s["jc"].loss))
    jm, jpred = jstep(_jax_state(s["jvars"], _grad_probe()),
                      jnp.asarray(s["past"]), jnp.asarray(s["future"]))
    enc, dec, tr = s["port"]
    opt = build_optimizer(s["tc"].optim, 48)
    state = create_nar_train_state(enc, dec, tr, opt)
    m, pred = make_nar_eval_step(enc, dec, tr, s["tc"].loss)(
        state, t(s["past"]), t(s["future"]))
    assert set(m) == set(jm) == {"T_MSE", "T_GDL", "T_bpc", "T_total"}
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= 2e-6, k
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-4)
