"""``transformer.scan_layers`` in the port (a ``BlockStack`` of blocks, the
JAX package's stacked tree sliced into it and stacked back by
``utils/weights.py``), on the CPU.

(a) the JAX package's ``scan_layers=True`` variables (FAR: ``blocks/block``;
    NAR: ``enc_blocks/block`` and ``dec_blocks/block``, the encoder's
    stacked BatchNorm ``batch_stats`` included), seeded random, loaded into
    the port's scan_layers model: its eval output against the JAX scanned
    model's, 1e-4 absolute (``test_torch_port_models.py``'s);
(b) the port's unrolled model from the same tree unstacked gives the
    scanned port model's output bit for bit;
(c) ``export_jax_variables`` of the scanned port model gives the JAX tree
    back bit for bit (same leaves, same shapes, stacked on axis 0), and a
    leaf stacked over the wrong number of blocks raises;
(d) scan_layers with remat: a train step (dropout and DropPath 0.1, the
    decoder checkpointed) from the same weights as the unrolled model's
    step without remat gives the same metrics, gradients, parameters,
    statistics and generator state, bit for bit.

Sizes: ``_torch_port_util.SMALL`` (d 48 over 4 heads, FAR 3 layers, NAR 2
+ 2, Tp = Tf = 3); f32, the attention in plain arithmetic on both sides.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.transformer import BlockStack, build_transformer
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_far_train_state
from vptr_tpu_torch.train.steps import make_far_train_step, make_nar_train_step
from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

from _torch_port_util import random_variables, small_cfgs, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

PLAIN = {"fused_attention": False, "fused_full": False}
STACKS = {"blocks": "block", "enc_blocks": "enc_block", "dec_blocks": "dec_block"}


def _cfgs(kind, **over):
    if kind == "far":
        jc, tc = small_cfgs()
        over = {"num_encoder_layers": 3, **over}
        return jc.override({"transformer": over}), tc.override({"transformer": over})
    return small_nar_cfgs(**over)


def _unstack(tree):
    """A stacked JAX tree -> the unrolled one (``<stack>/block`` -> one
    ``<prefix>{i}`` a layer)."""
    out = {}
    for k, v in tree.items():
        if k in STACKS:
            n = jax.tree.leaves(v["block"])[0].shape[0]
            for i in range(n):
                out[f"{STACKS[k]}{i}"] = jax.tree.map(lambda a: a[i], v["block"])
        else:
            out[k] = v
    return out


def _jax_scanned(kind, seed):
    """(port config, JAX scanned module, its seeded variables, latents)."""
    jc, tc = _cfgs(kind, scan_layers=True, **PLAIN)
    jtr = jbuild_tr(jc.transformer)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 3, 8, 8, 48)).astype(np.float32) * 0.5
    init = jtr.init if kind == "far" else partial(jtr.init, method="init_all")
    return tc, jtr, random_variables(init, rng, feats), feats


def _equal_trees(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("kind", ["far", "nar"])
def test_scanned_tree_loads_and_matches_jax(kind):
    """(a), (b), (c)"""
    tc, jtr, v, feats = _jax_scanned(kind, 60 if kind == "far" else 61)
    stacked = sorted(k for k in v["params"] if k in STACKS)
    assert stacked == (["blocks"] if kind == "far" else ["dec_blocks", "enc_blocks"])
    if kind == "nar":
        assert jax.tree.leaves(v["batch_stats"]["enc_blocks"])[0].shape[0] == 2
    want = jax.jit(jtr.apply)(jax.tree.map(jnp.asarray, v), jnp.asarray(feats))
    scanned = load_jax_variables(build_transformer(tc.transformer, device="cpu"), v)
    assert all(isinstance(getattr(scanned, k), BlockStack) for k in stacked)
    unrolled_cfg = tc.override({"transformer": {"scan_layers": False}}).transformer
    unrolled = load_jax_variables(build_transformer(unrolled_cfg, device="cpu"),
                                  {c: _unstack(tree) for c, tree in v.items()})
    with torch.inference_mode():
        got, got_unrolled = scanned(t(feats)), unrolled(t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert torch.equal(got, got_unrolled)
    _equal_trees(export_jax_variables(scanned), v)
    # a leaf stacked over another count of blocks raises
    short = jax.tree.map(lambda a: a, v)
    first = stacked[0]
    short["params"][first]["block"] = jax.tree.map(lambda a: a[:1],
                                                   v["params"][first]["block"])
    with pytest.raises(ValueError, match="is not stacked over"):
        load_jax_variables(build_transformer(tc.transformer, device="cpu"), short)


@pytest.mark.parametrize("kind", ["far", "nar"])
def test_scan_layers_with_remat_step_equals_unrolled(kind):
    """(d)"""
    runs = []
    tree = None
    for scan in (False, True):
        _, tc = _cfgs(kind, scan_layers=scan, remat=scan)
        enc, dec = build_autoencoder(tc.ae, device="cpu",
                                     generator=torch.Generator().manual_seed(1))
        tr = build_transformer(tc.transformer, device="cpu",
                               generator=torch.Generator().manual_seed(2))
        if tree is None:
            tree = export_jax_variables(tr)
        else:
            load_jax_variables(tr, {c: _restack(x) for c, x in tree.items()})
        opt = build_optimizer(tc.optim, tc.transformer.d_model)
        state = create_far_train_state(enc, dec, tr, opt, seed=3)
        make = make_far_train_step if kind == "far" else make_nar_train_step
        step = make(enc, dec, tr, opt, tc.loss, remat_decoder=scan)
        frames = t(np.random.default_rng(4).uniform(0, 1, (2, 6, 64, 64, 1)))
        state, m = step(state, frames[:, :3], frames[:, 3:])
        grads = export_jax_variables(
            state.transformer, {n: p.grad for n, p in state.transformer.named_parameters()})
        runs.append((m, export_jax_variables(state.transformer), grads,
                     state.generator.get_state()))
    (m0, v0, g0, r0), (m1, v1, g1, r1) = runs
    assert tc.transformer.dropout > 0 and tc.transformer.scan_layers
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    _equal_trees({c: _restack(x) for c, x in v0.items()}, v1)
    _equal_trees({c: _restack(x) for c, x in g0.items()}, g1)
    assert torch.equal(r0, r1)


def _restack(tree):
    """The inverse of :func:`_unstack`."""
    out = {k: v for k, v in tree.items()
           if not any(k.startswith(p) and k[len(p):].isdigit() for p in STACKS.values())}
    for stack, prefix in STACKS.items():
        layers = [tree[f"{prefix}{i}"] for i in range(len(tree))
                  if f"{prefix}{i}" in tree]
        if layers:
            out[stack] = {"block": jax.tree.map(lambda *a: np.stack(a), *layers)}
    return out
