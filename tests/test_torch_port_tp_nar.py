"""The port's tensor- and sequence-parallel NAR train steps on the CPU:
``tests/test_torch_port_tp.py``'s checks (a) and (b) for its NAR cases (TP
at (1, 2) and (2, 2), SP + TP at (2, 2), TSLMA at model 2), on their own
2-rank and 4-rank launches, spawned once for the module. The NAR step adds
the encoder's BatchNorm conv FFN (its split hidden's statistics, held
whole), the decoder's two-stream window kernel with the RPE bias on a head
subset, the enc-dec attention and the NCE head.
"""

import pytest

from test_torch_port_tp import CASES, check_jax_mesh, check_one_process, tp_cases
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

NAR = [n for n in CASES if CASES[n][0] == "nar"]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    yield from tp_cases(tmp_path_factory.mktemp("tp_nar_steps"), "nar")


@pytest.mark.parametrize("name", NAR)
def test_tp_nar_step_matches_one_process(tp, name):
    """(a): the mesh's step with dropout against the one-process step."""
    check_one_process(tp, name)


@pytest.mark.parametrize("name", NAR)
def test_tp_nar_step_matches_jax_mesh(tp, name):
    """(b): the mesh's step at dropout 0 against the JAX package's step on a
    (data, model) mesh."""
    check_jax_mesh(tp, name)
