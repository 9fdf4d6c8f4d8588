"""Seeding, parameter counting, FLOPs estimators, loss meters.

Counterpart of ``vptr_tpu/utils/misc.py``. The FLOP estimators are the
same formulas (the trainer's ``transformer_tflops_per_sec`` reads them).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed Python's and numpy's global generators and return a CPU
    ``torch.Generator`` seeded with ``seed`` (reference: utils/misc.py:8-34).
    The JAX package's ``impl`` (its PRNG implementation, ``rng_impl``) has
    no counterpart here: the port draws from explicit torch generators."""
    import random

    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator().manual_seed(seed)


def count_params(module_or_tensors: Any) -> int:
    """Total parameter count of a module or of an iterable of tensors
    (reference prints it at startup, train_FAR.py:199-200)."""
    if isinstance(module_or_tensors, torch.nn.Module):
        module_or_tensors = module_or_tensors.parameters()
    return sum(t.numel() for t in module_or_tensors)


def window_attention_flops(n_tokens: int, dim: int, num_heads: int) -> int:
    """Analytic per-window FLOPs — parity with the reference's estimator
    (reference: VidHRFormer_modules.py:362-373)."""
    head_dim = dim // num_heads
    flops = n_tokens * dim * 3 * dim             # qkv projections
    flops += num_heads * n_tokens * head_dim * n_tokens  # q @ k^T
    flops += num_heads * n_tokens * n_tokens * head_dim  # attn @ v
    flops += n_tokens * dim * dim                # out projection
    return flops


def transformer_step_flops(batch: int, t: int, h: int, w: int, dim: int,
                           num_heads: int, num_layers: int, window: int,
                           ffn_ratio: int = 4, backward: bool = True) -> int:
    """Rough per-step FLOPs of the FAR/NAR encoder stack, for MFU reporting."""
    win2 = window * window
    n_windows = (h // window) * (w // window) * batch * t
    per_layer = n_windows * window_attention_flops(win2, dim, num_heads)
    # temporal attention: batch*h*w sequences of length t
    per_layer += batch * h * w * window_attention_flops(t, dim, num_heads)
    # conv FFN (1x1 + dw3x3 + 1x1) + linear FFN
    hidden = ffn_ratio * dim
    per_layer += batch * t * h * w * (2 * dim * hidden + 9 * hidden)
    per_layer += batch * t * h * w * 2 * dim * hidden
    total = 2 * num_layers * per_layer          # x2: multiply-add
    if backward:
        total *= 3
    return total


def nar_step_flops(batch: int, tp: int, tf: int, h: int, w: int, dim: int,
                   num_heads: int, num_encoder_layers: int,
                   num_decoder_layers: int, window: int, ffn_ratio: int = 4,
                   backward: bool = True) -> int:
    """Per-step FLOPs of the NAR encoder-decoder stack (train_NAR recipe):
    encoder blocks over the Tp past frames plus decoder blocks over the Tf
    query frames (window + temporal self-attention, enc-dec cross attention
    over Tp keys, TWO conv FFNs and one linear FFN per decoder block).
    NCE projector and frame-query adds are negligible and excluded."""
    win2 = window * window
    hidden = ffn_ratio * dim
    hd = dim // num_heads

    def enc_layer(t):
        per = ((h // window) * (w // window) * batch * t
               * window_attention_flops(win2, dim, num_heads))
        per += batch * h * w * window_attention_flops(t, dim, num_heads)
        per += batch * t * h * w * (2 * dim * hidden + 9 * hidden)
        per += batch * t * h * w * 2 * dim * hidden
        return per

    def dec_layer():
        per = ((h // window) * (w // window) * batch * tf
               * window_attention_flops(win2, dim, num_heads))
        per += batch * h * w * window_attention_flops(tf, dim, num_heads)
        # enc-dec cross attention: Tf queries over Tp keys per column
        cross = (tf * dim * 2 * dim + tp * dim * 2 * dim
                 + 2 * num_heads * tf * tp * hd)
        per += batch * h * w * cross
        per += 2 * batch * tf * h * w * (2 * dim * hidden + 9 * hidden)
        per += batch * tf * h * w * 2 * dim * hidden
        return per

    total = 2 * (num_encoder_layers * enc_layer(tp)
                 + num_decoder_layers * dec_layer())
    if backward:
        total *= 3
    return total


class AverageMeters:
    """Running means per named loss for one epoch
    (reference: utils/train_summary.py:41-91).

    The trainer runs on one card, so every loss is already a whole-batch
    mean; these meters only average over steps on the host."""

    def __init__(self, names=None):
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        if names:
            for n in names:
                self.sums[n] = 0.0
                self.counts[n] = 0

    def update(self, values: Dict[str, Any]):
        for k, v in values.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1

    def averages(self) -> Dict[str, float]:
        return {k: self.sums[k] / max(1, self.counts[k]) for k in self.sums}

    def __getitem__(self, k: str) -> float:
        return self.sums[k] / max(1, self.counts[k])
