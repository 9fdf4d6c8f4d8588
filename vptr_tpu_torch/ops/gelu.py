"""The GELU of the fused feed-forward kernels: exact-erf GELU with the
Abramowitz-Stegun 7.1.26 rational erf (|error| <= 1.5e-7).

Counterpart of ``vptr_tpu/ops/fused_conv_ln.py:42-60`` (``_erf``,
``_gelu``, ``_gelu_grad``), which the TPU kernels ``fused_ffn`` and
``fused_dw_chain`` use because Mosaic has no erf. The device twin is
``csrc/gelu_as.cuh``. Only those kernels and their plain versions use it;
the unfused routes keep ``F.gelu`` (exact erf), as the JAX package keeps
``jax.nn.gelu``. All arithmetic is f32.
"""

from __future__ import annotations

import math

import torch

_SQRT_2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """sign(x) (1 - poly(t) exp(-x^2)), t = 1 / (1 + 0.3275911 |x|)."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_as(a: torch.Tensor) -> torch.Tensor:
    """0.5 a (1 + erf(a / sqrt 2))."""
    return 0.5 * a * (1.0 + erf_as(a / _SQRT_2))


def gelu_as_grad(a: torch.Tensor) -> torch.Tensor:
    """d gelu / da: the A&S cdf plus a times the exact normal pdf."""
    cdf = 0.5 * (1.0 + erf_as(a / _SQRT_2))
    pdf = torch.exp(-0.5 * a * a) * _INV_SQRT_2PI
    return cdf + a * pdf
