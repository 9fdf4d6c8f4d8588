"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: small FAR and NAR configurations, seeded numpy inputs and weights
that go to both packages, the JAX variables as nested numpy dicts, and the
attention core's backward held against JAX's on operands in the layer's
layout."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vptr_tpu.config as jcfg
import vptr_tpu_torch.config as tcfg
from vptr_tpu.ops import attention_core as jax_core
from vptr_tpu_torch.ops import attention_core as torch_core

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


def small_nar_cfgs(past: int = 3, future: int = 3, preset: str = "nar_mnist",
                   **transformer):
    """(JAX config, port config) of ``preset`` (nar_mnist by default) cut to
    SMALL with 2 + 2 layers (RPE on, as the preset) and Tp = ``past``, Tf =
    ``future``; ``transformer`` overrides more fields."""
    over = {**SMALL,
            "transformer": {**SMALL["transformer"], "num_decoder_layers": 2,
                            "num_past_frames": past,
                            "num_future_frames": future, **transformer},
            "data": {**SMALL["data"], "num_past_frames": past,
                     "num_future_frames": future}}
    return (jcfg.get_preset(preset).override(over),
            tcfg.get_preset(preset).override(over))


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


def assert_grad_close(got, want, name):
    """max |got - want| <= 1e-5 times the larger of 1 and max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want).max()
    assert err <= tol, f"{name}: max |err| {err:.3e} > {tol:.3e}"


# layouts of q, k, v and g: 1 the layer's (heads_view), 0 contiguous
CORE_LAYOUTS = {"strided": (1, 1, 1, 1), "mixed": (1, 0, 1, 0)}


def core_bias(kind, rng, h, tq, tk):
    if kind == "none":
        return None
    if kind == "causal":
        return np.triu(np.full((tq, tk), -1e30, np.float32), 1)[None]
    return rng.standard_normal((1 if kind == "one" else h, tq, tk)).astype(np.float32)


def jax_core_vjp(q, k, v, bias, g, seed, rate):
    """JAX's (dq, dk, dv[, dbias]) of the attention core (interpret mode)."""
    prim = (q, k, v) if bias is None else (q, k, v, bias)
    f = lambda *a: jax_core.attention_core(*a[:3], a[3] if len(a) > 3 else None,
                                           seed, rate, 128, True)
    _, vjp = jax.vjp(f, *map(jnp.asarray, prim))
    return vjp(jnp.asarray(g))


def check_strided_core_backward(tq, tk, bias_kind, layouts, rate, rng):
    """The backward on operands in ``layouts`` against JAX's on contiguous
    ones: called alone, and through autograd with g in g's layout."""
    b, h, d, seed = 3, 8, 12, 4321
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d), (b, h, tq, d)))
    bias = core_bias(bias_kind, rng, h, tq, tk)
    want = jax_core_vjp(q, k, v, bias, g, seed, rate)
    ops = [heads_view(x) if lay else t(x)
           for x, lay in zip((q, k, v, g), CORE_LAYOUTS[layouts])]
    assert tuple(torch_core.layout(x) for x in ops) == CORE_LAYOUTS[layouts]
    tbias = None if bias is None else t(bias)
    got = torch_core.attention_core_backward(*ops[:3], tbias, seed, ops[3], rate,
                                             need_dbias=bias is not None)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert_grad_close(a, w, name)
    ins = [x.detach().clone().requires_grad_() for x in ops[:3]]   # strides kept
    extra = [] if bias is None else [tbias.clone().requires_grad_()]
    out = torch_core.attention_core(*ins, extra[0] if extra else None, seed, rate)
    grads = torch.autograd.grad(out, ins + extra, ops[3])
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
        assert_grad_close(a, w, name + " (autograd)")




def recording(opt):
    """optax transformation that applies ``opt`` and keeps the gradients it
    was given in its state (``state[1]``): one JAX step gives both its exact
    gradients and its updated parameters."""
    import optax

    def update(g, s, p=None):
        u, inner = opt.update(g, s[0], p)
        return u, (inner, g)

    return optax.GradientTransformation(
        lambda p: (opt.init(p), jax.tree.map(jnp.zeros_like, p)), update)


def leaf_errors(got, want, rel: float, floor: float = 1e-9):
    """The leaves where max |got - want| > rel * max |want| + floor, as
    'path: err > tol' lines (empty when every leaf agrees)."""
    bad = []

    def check(path, g, w):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        tol = rel * np.abs(w).max() + floor
        err = np.abs(g - w).max()
        if not err <= tol:
            bad.append(f"{jax.tree_util.keystr(path)}: {err:.3e} > {tol:.3e}")
    jax.tree_util.tree_map_with_path(check, got, want)
    return bad


def adam_param_errors(got, want, grads, lr: float, grad_rel: float,
                      grad_floor: float = 1e-9, eps: float = 1e-8):
    """Parameters after one Adam step against JAX's. The first step moves an
    element by lr * g / (|g| + eps): with the gradient known to within
    d = grad_rel * (the leaf's largest) + grad_floor, an element with
    |g| <= d may step lr either way (bound 2 lr), and any other moves by at
    most lr * eps * d / (|g| + eps)^2 more than JAX's (its derivative);
    2e-6 absolute on top for the rest of the arithmetic."""
    bad = []

    def check(path, g, w, gr):
        g, w, gr = (np.asarray(a, np.float64) for a in (g, w, gr))
        d = grad_rel * np.abs(gr).max() + grad_floor
        tol = np.where(np.abs(gr) <= d, 2 * lr,
                       2e-6 + lr * eps * d / (np.abs(gr) + eps) ** 2)
        err = np.abs(g - w)
        if not (err <= tol).all():
            bad.append(f"{jax.tree_util.keystr(path)}: {err.max():.3e}")
    jax.tree_util.tree_map_with_path(check, got, want, grads)
    return bad
