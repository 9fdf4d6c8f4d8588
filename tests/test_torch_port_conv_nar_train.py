"""One NAR training step on the conv-FFN kernel route with the folded
temporal sublayer (``fused_conv_ffn`` and ``fused_full_temporal`` on, with
the preset's fused attention) against the JAX package's, on the CPU, the
JAX kernels #1/#3 and #11/#12 in Pallas interpret mode: the protocol and
tolerances of ``test_torch_port_nar_train.py`` (o) (``check_train_step``:
losses, every gradient leaf, the parameters after clip -> AdamW, the
BatchNorm statistics) at dropout = drop_path = 0. The decoder's conv FFNs
take the kernels, the encoder's BatchNorm ones do not; both stacks' temporal
sublayers fold their norm.
"""

from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_conv_train import FLAGS
from test_torch_port_nar_train import check_train_step


def test_nar_conv_route_step_matches_jax():
    check_train_step(FLAGS, 3, weighted=False)
