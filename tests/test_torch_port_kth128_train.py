"""One NAR train step at nar_kth_128's geometry (128 x 128 frames, 16 x 16
latents, a 16-wide grid for the conv FFN) on the fused-FFN route
(``fused_ffn`` + ``fused_dw``: #7-#10) and on the conv-FFN route
(``fused_conv_ffn`` + ``fused_full_temporal``: #11/#12, #1/#3 folded)
against the JAX package's, on the CPU, the JAX kernels in Pallas interpret
mode: ``check_train_step`` of ``test_torch_port_nar_train.py`` at SMALL
widths (AE ngf 8, d 48, 2 + 2 layers, Tp = Tf = 3), dropout 0: the losses
(1e-6, the total 2e-6), the parameters after clip -> AdamW (2e-6; 2 lr
where the exact gradient is under 1e-6) as there, and

* the gradients as one vector: relative L2 error <= 1e-4, every leaf's
  largest error <= 1e-4 of the largest gradient of the tree, the gradient
  norm within 1e-4 (measured: 1.6e-5, 1.9e-5);
* the BatchNorm statistics within 1e-4 absolute (measured: 3.1e-5).

Why wider than nar_mnist's leaf-by-leaf 1e-5: at this geometry the two
packages' steps differ more on every route, the default one included (1.6e-5
as one vector, against 1.0e-6 at nar_mnist's 64 x 64), while the eval-mode
forward agrees as closely as at 64 x 64; the suspected source is the NAR
encoder's train-mode BatchNorm, whose variance E[x^2] - E[x]^2 (flax's,
kept by the port) cancels on the near-constant feature channels of the
random-init 128 x 128 autoencoder, so summation order moves them (ROADMAP
§3, "To check" 3). Seed 81: no two neighbouring predicted pixels of the
port's first forward tie (seed 80 has such a tie at this frame size).
"""

import pytest

from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_kth128_models import ROUTES
from test_torch_port_nar_train import check_train_step


@pytest.mark.parametrize("route", list(ROUTES))
def test_nar_train_step_at_the_16x16_latent_matches_jax(route):
    check_train_step(ROUTES[route], 3, weighted=False, seed=81, preset="nar_kth_128",
                     grad_tol=1e-4, stats_atol=1e-4)
