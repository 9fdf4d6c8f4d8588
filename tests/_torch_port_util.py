"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: small FAR and NAR configurations, seeded numpy inputs and weights
that go to both packages, and the JAX variables as nested numpy dicts."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import vptr_tpu.config as jcfg
import vptr_tpu_torch.config as tcfg

# f32, small: d_model 48 over 4 heads (head width 12, not a power of two),
# 2 FAR layers, AE ngf 8 / feat 48 / 1 res block, 64x64 frames, Tp = Tf = 3
SMALL = {
    "dtype": "float32",
    "ae": {"ngf": 8, "feat_dim": 48, "n_res_blocks": 1},
    "transformer": {"d_model": 48, "n_heads": 4, "num_encoder_layers": 2,
                    "num_past_frames": 3, "num_future_frames": 3},
    "data": {"batch_size": 2, "num_past_frames": 3, "num_future_frames": 3},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a port test module runs (tier-1 runs six
    workers side by side); the previous count is restored afterwards, so
    other test files in the same worker keep theirs. Import it into a test
    module to turn it on there."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def small_cfgs():
    """(JAX config, port config) of far_mnist cut to SMALL."""
    return (jcfg.get_preset("far_mnist").override(SMALL),
            tcfg.get_preset("far_mnist").override(SMALL))


def small_nar_cfgs(past: int = 3, future: int = 3, **transformer):
    """(JAX config, port config) of nar_mnist cut to SMALL with 2 + 2
    layers (RPE on, as the preset) and Tp = ``past``, Tf = ``future``;
    ``transformer`` overrides more fields."""
    over = {**SMALL,
            "transformer": {**SMALL["transformer"], "num_decoder_layers": 2,
                            "num_past_frames": past,
                            "num_future_frames": future, **transformer},
            "data": {**SMALL["data"], "num_past_frames": past,
                     "num_future_frames": future}}
    return (jcfg.get_preset("nar_mnist").override(over),
            tcfg.get_preset("nar_mnist").override(over))


def to_numpy(tree):
    """JAX variables -> nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def randomize(tree, rng: np.random.Generator):
    """Replace every leaf with seeded random values of its shape, so zero
    biases and unit norms cannot hide a mapping or layout fault. Kernels
    are scaled by fan-in so activations stay O(1); BatchNorm variances stay
    positive."""
    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(x.shape)
        if name.endswith("['var']"):
            out = rng.uniform(0.5, 1.5, x.shape)
        elif name.endswith("['kernel']"):
            out = noise / np.sqrt(np.prod(x.shape[:-1]))
        elif name.endswith("['scale']"):
            out = 1.0 + 0.1 * noise
        else:                                   # biases, BN means
            out = 0.1 * noise
        return out.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, to_numpy(tree))


def random_variables(init, rng: np.random.Generator, *args):
    """Seeded random variables (:func:`randomize`) of the tree that
    ``init(key, *args)`` makes, from its shapes alone: a JAX init would run
    (or compile) the interpret-mode kernels only for its values to be
    replaced. The draws equal ``randomize(init(key, *args), rng)``'s."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return randomize(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                     rng)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def heads_view(x) -> torch.Tensor:
    """numpy (B, H, T, D) -> the same values as the (B, H, T, D) view of a
    contiguous torch (B, T, H*D) tensor: the attention layer's projections
    split into heads, strides (T H D, D, H D, 1)."""
    b, h, tt, d = x.shape
    rows = t(np.transpose(x, (0, 2, 1, 3)).reshape(b, tt, h * d))
    return rows.view(b, tt, h, d).transpose(1, 2)
