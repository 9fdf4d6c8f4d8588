"""The float16 compute dtype in the port against the JAX package's, on the
CPU (the JAX package maps ``dtype = "float16"``, ``vptr_tpu/train/
trainer.py``; its Pallas kernels cast with ``.astype(x.dtype)``).

(a) Kernels #1-#6 through their plain versions (what the wrappers take
    for CPU tensors) in f16 against the JAX kernels in Pallas interpret
    mode, forward and backward, dropout 0 and 0.1: ``attention_core`` (#2,
    #4: causal, per-head bias, rectangular), ``fused_attention_ln`` /
    ``_res`` (#1, #3: L 16 and the odd L 19, whose dropout index runs over
    24 padded tokens in f16 as in f32, 32 in bf16) and ``fused_attention``
    (#5, #6); a 2-head subset of 4 (tensor parallelism's head subsets) held
    against the JAX call's heads.
(b) The routes: f16 takes #1-#6's FMA routes (no f16 tensor-core route);
    #2/#4's long route (Tq or Tk past 32) and the wrappers of #7-#12 refuse
    f16 before any launch, with a ValueError naming float16 (pure
    functions of shape and dtype, so no card is needed).
(c) The FAR and NAR transformers' forwards in f16 against JAX's.
(d) One FAR, one NAR and one AE/GAN train step in f16 against JAX's f16
    step on the same weights (``load_jax_variables``), dropout 0.
(e) ``mu_dtype = "float16"``: clip -> AdamW against optax's f16 first
    moment; the trainer's dtype map (and its refusal of f16 under a model
    axis, queued); ``cli train --set dtype=float16``.
The Trainer's history in f16 against JAX's Trainer is a case of
``test_torch_port_trainer.py::test_train_matches_jax``.

Tolerances, measured first (SMALL widths, seeded numpy inputs), each
against the larger of 1 and the largest magnitude of the JAX value:
* kernels, forward 2^-10 (one f16 ulp of an output in [1, 2); measured
  at most 5.8e-4: a rounding at an intermediate that falls the other
  way), backward 2^-9 (two ulps: measured at most 8.7e-4, on the weight
  gradients that sum 95 rows), head subsets as the whole calls (the
  shares' sum 2^-9: each share is rounded once);
* the transformers' outputs 2^-8 (measured 1.8e-3 FAR, 2.5e-3 NAR after
  2 + 2 layers), the NCE projection of the NAR output, two layers and a
  normalisation further, 2^-7 (measured 3.4e-3);
* the train steps' losses 2^-10 (measured 2.1e-4); their gradients as one
  vector: relative L2 within 2^-3 of JAX's f16 step (measured 7.9e-2 FAR,
  1.2e-2 NAR, 6.8e-2 the AE's encoder) and, against JAX's f32 step on the
  same weights, no farther than 1.5 times JAX's own f16 step is plus
  1e-3 (measured: the port 4.3e-2 against JAX's 7.6e-2 FAR, 1.04e-1
  against 1.19e-1 the AE's encoder). f16 has 10
  mantissa bits and underflows below 6e-8: the small gradients of these
  steps (leaves of 1e-12 to 1e-6) keep a few bits or none, in both
  packages, so the step gradients are held against f16's own error;
* the optimizer: parameters 2e-6, the f16 first moment one f16 ulp.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vptr_tpu import losses as jlosses
from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.discriminator import build_discriminator as jbuild_disc
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu.ops import attention_core as jac
from vptr_tpu.ops import fused_window_attention as jfw
from vptr_tpu.train.state import AETrainState, ModuleState, Stage2TrainState
from vptr_tpu.train.steps import make_ae_train_step as jmake_ae_train_step
from vptr_tpu.train.steps import make_far_train_step as jmake_far_train_step
from vptr_tpu.train.steps import make_nar_train_step as jmake_nar_train_step
from vptr_tpu_torch.cli import main
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.discriminator import build_discriminator
from vptr_tpu_torch.models.layers import use_kernels
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.ops import _build
from vptr_tpu_torch.ops import attention_core as tac
from vptr_tpu_torch.ops import conv_ln_gelu as tcl
from vptr_tpu_torch.ops import dropout as tdrop
from vptr_tpu_torch.ops import fused_dw_chain as tdw
from vptr_tpu_torch.ops import fused_ffn as tff
from vptr_tpu_torch.ops import fused_window_attention as tfw
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_far_train_state, create_nar_train_state
from vptr_tpu_torch.train.steps import (
    make_ae_train_step,
    make_far_train_step,
    make_nar_train_step,
)
from vptr_tpu_torch.train.trainer import _dtype_of
from vptr_tpu_torch.utils.weights import (
    ae_train_state_from_jax,
    export_jax_variables,
    load_jax_variables,
)

from test_cli import TINY_SETS
from test_torch_port_ae_train import tiny_cfgs
from _torch_port_util import random_variables, recording, small_cfgs, small_nar_cfgs, t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

F16, JF16 = torch.float16, jnp.float16
FWD_REL, BWD_REL = 2.0 ** -10, 2.0 ** -9      # kernels, forward and backward
MODEL_REL = 2.0 ** -8                         # the transformers' outputs
PROJ_REL = 2.0 ** -7                          # the NCE projection of NAR's
LOSS_REL = 2.0 ** -10                         # the train steps' losses
STEP_L2 = 2.0 ** -3                           # the step gradients, as one vector
SEED = 4321


def h(x) -> torch.Tensor:
    """numpy -> an f16 torch tensor (rounded to nearest even)."""
    return t(x).to(F16)


def jh(x):
    """numpy -> an f16 JAX array (rounded to nearest even)."""
    return jnp.asarray(np.asarray(x, np.float32)).astype(JF16)


def assert_rel(got, want, rel, name):
    """max |got - want| <= rel * max(1, max |want|), both read in f64."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max |err| {err:.3e} > {tol:.3e}"


# ------------------------------------------------ (a) kernels #2 / #4 in f16

def _core_case(case, rng):
    b, hh, tq, tk, d = 6, 4, 7, 7, 12
    if case == "rectangular":
        tk = 5
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, hh, tq, d), (b, hh, tk, d), (b, hh, tk, d), (b, hh, tq, d)))
    if case == "causal":
        bias = np.triu(np.full((tq, tk), -1e30, np.float32), 1)[None]
    else:
        bias = rng.standard_normal((hh if case == "per_head_bias" else 1, tq, tk)
                                   ).astype(np.float32)
    return (q, k, v, g), bias


def _jax_core(q, k, v, bias, g, rate):
    f = lambda q, k, v, b: jac.attention_core(q, k, v, b, SEED, rate, 128, True)
    out, vjp = jax.vjp(f, jh(q), jh(k), jh(v), jnp.asarray(bias))
    return out, vjp(jh(g))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", ["causal", "per_head_bias", "rectangular"])
def test_attention_core_f16_matches_jax(case, rate):
    (q, k, v, g), bias = _core_case(case, np.random.default_rng(60))
    want, wgrads = _jax_core(q, k, v, bias, g, rate)
    ins = [h(a).requires_grad_() for a in (q, k, v)]
    tb = t(bias).requires_grad_()
    out = tac.attention_core(*ins, tb, SEED, rate)
    assert out.dtype == F16
    assert_rel(out, want, FWD_REL, "out")
    out.backward(h(g))
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), ins + [tb], wgrads):
        assert a.grad.dtype == a.dtype
        assert_rel(a.grad, w, BWD_REL, name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_core_f16_head_subset(rate):
    """Heads 2-3 of 4 (mask_heads 4, head0 2): JAX's whole call's slice."""
    (q, k, v, g), bias = _core_case("per_head_bias", np.random.default_rng(61))
    want, wgrads = _jax_core(q, k, v, bias, g, rate)
    sl = slice(2, 4)
    got = tac.attention_core(h(q)[:, sl], h(k)[:, sl], h(v)[:, sl], t(bias)[sl], SEED,
                             rate, 4, 2)
    assert_rel(got, np.asarray(want, np.float32)[:, sl], FWD_REL, "out")
    grads = tac.attention_core_backward(h(q)[:, sl], h(k)[:, sl], h(v)[:, sl], t(bias)[sl],
                                        SEED, h(g)[:, sl], rate, True, 4, 2)
    for name, a, w in zip(("dq", "dk", "dv"), grads, wgrads):
        assert_rel(a, np.asarray(w, np.float32)[:, sl], BWD_REL, name)
    assert_rel(grads[3], np.asarray(wgrads[3])[sl], BWD_REL, "dbias")


# ------------------------------------------ (a) kernels #1, #3, #5, #6 in f16

C, HEADS, BW = 48, 4, 5


def _window_args(rng, l, two):
    """x (or x_qk, x_v), wq, bq, wk, bk, wv, bv, wo, bo [, ls, lb, pos]."""
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    xs = [f(BW, l, C)] + ([f(BW, l, C)] if two else [])
    wb = []
    for _ in range(4):
        wb += [f(C, C, scale=C ** -0.5), f(C, scale=0.1)]
    extra = [] if two else [1.0 + f(C, scale=0.1), f(C, scale=0.1), f(l, C, scale=0.5)]
    return xs + wb + extra


def _halves(args, two):
    """Which of ``args`` are f16: the inputs and the four weights."""
    n_in = 2 if two else 1
    return [i < n_in or (i - n_in) in (0, 2, 4, 6) and i < n_in + 8 for i in range(len(args))]


def _to_torch(args, two):
    return [h(a) if half else t(a) for a, half in zip(args, _halves(args, two))]


def _to_jax(args, two):
    return [jh(a) if half else jnp.asarray(a) for a, half in zip(args, _halves(args, two))]


def _jax_window(args, bias, scale, g, two, res, rate):
    """JAX's output and vjp (every argument and the bias) in f16."""
    def f(*a):
        if two:
            return jfw.fused_attention(*a[:10], a[10], SEED, HEADS, rate, 64, True)
        if res:
            return jfw.fused_attention_ln_res(*a[:12], a[12], jnp.asarray(scale), SEED,
                                              HEADS, rate, 64, True)
        return jfw.fused_attention_ln(*a[:12], a[12], SEED, HEADS, rate, 64, True)
    out, vjp = jax.vjp(f, *_to_jax(args, two), jnp.asarray(bias))
    return out, vjp(jh(g))


LN_NAMES = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo", "dls", "dlb",
            "dpos", "dbias")
TWO_NAMES = ("dx_qk", "dx_v", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo",
             "dbias")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("l", [16, 19])
@pytest.mark.parametrize("kind", ["ln", "ln_res", "two_stream"])
def test_window_kernels_f16_match_jax(kind, l, rate):
    """#1/#3 (``ln``, ``ln_res``: the residual and the DropPath scale) and
    #5/#6 (``two_stream``) with a per-head bias, forward and backward."""
    rng = np.random.default_rng(62)
    two, res = kind == "two_stream", kind == "ln_res"
    args = _window_args(rng, l, two)
    bias = rng.standard_normal((HEADS, l, l)).astype(np.float32)
    scale = np.array([1.0, 0.0, 2.0, 1.0, 0.5], np.float32)
    g = rng.standard_normal((BW, l, C)).astype(np.float32)
    want, wgrads = _jax_window(args, bias, scale, g, two, res, rate)

    ins = [a.requires_grad_() for a in _to_torch(args, two)]
    tb = t(bias).requires_grad_()
    if two:
        out = tfw.fused_attention(*ins, tb, SEED, HEADS, rate)
    elif res:
        out = tfw.fused_attention_ln_res(*ins, tb, t(scale), SEED, HEADS, rate)
    else:
        out = tfw.fused_attention_ln(*ins, tb, SEED, HEADS, rate)
    assert out.dtype == F16
    assert_rel(out, want, FWD_REL, "out")
    out.backward(h(g))
    names = TWO_NAMES if two else LN_NAMES
    for name, a, w in zip(names, ins + [tb], wgrads):
        assert a.grad is not None and a.grad.dtype == a.dtype, name
        assert_rel(a.grad, w, BWD_REL, name)


def _subset_args(args, two, hl, h0):
    """The subset's operands: Wq/Wk/Wv columns and biases, Wo rows, bo 0."""
    n_in = 2 if two else 1
    cols = slice(h0 * C // HEADS, (h0 + hl) * C // HEADS)
    xs, (wq, bq, wk, bk, wv, bv, wo, bo), rest = (args[:n_in], args[n_in:n_in + 8],
                                                  args[n_in + 8:])
    return (list(xs) + [wq[:, cols], bq[cols], wk[:, cols], bk[cols], wv[:, cols], bv[cols],
                        wo[cols], torch.zeros_like(bo)] + list(rest))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("two", [False, True], ids=["ln_1_3", "two_stream_5_6"])
def test_window_kernels_f16_two_head_subsets(two, rate):
    """Two 2-head subsets of 4 (mask_heads 4, head0 0 and 2) at L 19: their
    shares summed with bo once, and their input gradients summed, against
    JAX's whole call; each subset's weight gradients against JAX's slices."""
    rng = np.random.default_rng(63)
    l, hd = 19, C // HEADS
    args = _window_args(rng, l, two)
    bias = rng.standard_normal((HEADS, l, l)).astype(np.float32)
    g = rng.standard_normal((BW, l, C)).astype(np.float32)
    want, wgrads = _jax_window(args, bias, None, g, two, False, rate)
    whole = _to_torch(args, two)
    n_in = 2 if two else 1
    total = whole[n_in + 7].float()                       # bo, once
    dins = [0.0] * n_in
    for h0 in (0, 2):
        sub = _subset_args(whole, two, 2, h0)
        sb = t(bias)[h0:h0 + 2]
        if two:
            share = tfw.fused_attention_plain(*sub, sb, SEED, 2, rate, mask_heads=HEADS,
                                              head0=h0)
            grads = tfw.fused_attention_backward_plain(*sub, sb, SEED, h(g), 2, rate, True,
                                                       mask_heads=HEADS, head0=h0)
        else:
            share = tfw.fused_attention_ln_plain(*sub, sb, SEED, 2, rate, mask_heads=HEADS,
                                                 head0=h0)
            grads = tfw.fused_attention_ln_backward_plain(*sub, sb, SEED, h(g), 2, rate,
                                                          None, False, True,
                                                          mask_heads=HEADS, head0=h0)
        total = total + share.float()
        dins = [d + a.float() for d, a in zip(dins, grads[:n_in])]
        cols = slice(h0 * hd, (h0 + 2) * hd)
        jw = [np.asarray(w, np.float32) for w in wgrads]
        for j, name in enumerate(("dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo")):
            w = jw[n_in + j]
            w = w[:, cols] if name in ("dwq", "dwk", "dwv") else w[cols]
            assert_rel(grads[n_in + j], w, BWD_REL, f"{name} of heads {h0}-{h0 + 1}")
        assert_rel(grads[-1], jw[-1][h0:h0 + 2], BWD_REL, f"dbias of heads {h0}-{h0 + 1}")
    assert_rel(total, want, 2 * FWD_REL, "the shares summed")
    for i, d in enumerate(dins):
        assert_rel(d, wgrads[i], BWD_REL, f"input gradient {i} summed")


def test_f16_window_dropout_index_pads_to_8():
    """JAX pads the token axis to 16 for bf16 and to 8 for every other
    dtype before it draws the mask: L 19 is 24 tokens in f16, as in f32."""
    assert tdrop.padded_tokens(19, F16) == tdrop.padded_tokens(19, torch.float32) == 24
    assert tdrop.padded_tokens(19, torch.bfloat16) == 32
    assert tdrop.padded_tokens(16, F16) == 16
    f16 = tdrop.window_keep_mask(SEED, 3, HEADS, 19, 0.1, F16)
    assert torch.equal(f16, tdrop.window_keep_mask(SEED, 3, HEADS, 19, 0.1, torch.float32))
    assert not torch.equal(f16, tdrop.window_keep_mask(SEED, 3, HEADS, 19, 0.1,
                                                       torch.bfloat16))


# ------------------------------------------------------------- (b) the routes

@pytest.mark.parametrize("tokens,inner", [(16, 528), (19, 528), (20, 528), (10, 528),
                                          (16, 264), (16, 132)])
def test_f16_takes_the_window_fma_routes(tokens, inner):
    """far_rip's windows (16), the FAR step's and far_rip's temporal (19,
    20), NAR's (10), head subsets (Cl 264, 132): FMA in f16."""
    assert tfw.kernel_route(tokens, 528, F16, inner=inner) == "fma"
    assert tfw.backward_route(tokens, 528, F16, inner=inner) == "fma"
    assert tfw.backward_route(tokens, 528, F16, False, inner=inner) == "fma"


@pytest.mark.parametrize("heads,tq,tk,d", [(8, 20, 20, 66), (8, 19, 19, 66),
                                           (8, 10, 10, 66), (8, 10, 2, 66),
                                           (4, 19, 19, 66), (8, 32, 32, 128)])
def test_f16_takes_the_core_fma_route(heads, tq, tk, d):
    assert tac.kernel_route(F16, heads, tq, tk, d) == "fma"
    assert tac.backward_route(F16, heads, tq, tk, d) == "fma"
    assert tac.kernel_route(torch.bfloat16, heads, tq, tk, d) == "mma"


@pytest.mark.parametrize("tq,tk", [(40, 40), (160, 160), (10, 40), (40, 10)])
def test_f16_long_route_refused(tq, tk):
    """#2/#4 past 32 tokens (TSLMA's windows) have no f16 kernel: both
    route functions raise before any launch; bf16 and f32 take "long"."""
    for route in (tac.kernel_route, tac.backward_route):
        with pytest.raises(ValueError, match="float16.*queued"):
            route(F16, 8, tq, tk, 66)
        assert route(torch.bfloat16, 8, tq, tk, 66) == "long"
        assert route(torch.float32, 8, tq, tk, 66) == "long"


def test_f16_refused_by_kernels_7_to_12():
    """The wrappers of #7-#12 check the dtype first (``_build.dtype_code``
    on their ``_DTYPES``, a pure function) and raise for f16 with a message
    naming float16 and the queue, before any device or launch; f32 and bf16
    keep their codes."""
    for mod in (tff, tdw, tcl):
        assert _build.dtype_code(mod._DTYPES, torch.float32, "k") == 0
        assert _build.dtype_code(mod._DTYPES, torch.bfloat16, "k") == 1
        with pytest.raises(ValueError, match="float16.*#7-#12.*queued"):
            _build.dtype_code(mod._DTYPES, F16, mod.__name__)
    x = torch.zeros(64, 48, dtype=F16)
    with pytest.raises(ValueError, match="fused_ffn.*float16"):
        tff._operands(x, torch.zeros(48, 96, dtype=F16), torch.zeros(96),
                      torch.zeros(96, 48, dtype=F16), torch.zeros(48), torch.zeros(48),
                      torch.zeros(48))
    x3 = torch.zeros(2, 64, 64, dtype=F16)
    with pytest.raises(ValueError, match="fused_dw_chain.*float16"):
        tdw._operands(x3, None, None, None, None, None, None, 8)
    with pytest.raises(ValueError, match="fused_dw_chain.*float16"):
        tdw._check_split("split_forward", x3, 8, (2, 0))
    with pytest.raises(ValueError, match="conv_ln_gelu.*float16"):
        tcl._operands(x3, torch.zeros(64, 64, dtype=F16), None, None, None)
    with pytest.raises(ValueError, match="conv_ln_gelu.*float16"):
        tcl._check_split("split_forward", x3, torch.zeros(64, 64, dtype=F16))


# ------------------------------------------------------- (c) the transformers

@pytest.mark.parametrize("kernels", ["cuda", "plain"])
def test_far_transformer_f16_matches_jax(kernels):
    jc, tc = small_cfgs()
    rng = np.random.default_rng(64)
    feats = rng.standard_normal((2, 6, 8, 8, 48)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer, dtype=JF16)
    tv = random_variables(jtr.init, rng, jh(feats))
    want = jtr.apply(tv, jh(feats), train=False)
    tr = build_transformer(tc.transformer, F16, device="cpu")
    use_kernels(load_jax_variables(tr, tv), kernels)
    with torch.inference_mode():
        got = tr(h(feats))
    assert got.dtype == F16 and want.dtype == JF16
    assert_rel(got, want, MODEL_REL, "FAR output")


def test_nar_transformer_f16_matches_jax():
    jc, tc = small_nar_cfgs(3, 3)
    rng = np.random.default_rng(65)
    feats = rng.standard_normal((2, 3, 8, 8, 48)).astype(np.float32)
    jtr = jbuild_tr(jc.transformer, dtype=JF16)
    tv = random_variables(partial(jtr.init, method="init_all"), rng, jh(feats))
    want = jtr.apply(tv, jh(feats), train=False)
    want_proj = jtr.apply(tv, want, method=jtr.nce_project)
    tr = load_jax_variables(build_transformer(tc.transformer, F16, device="cpu"), tv)
    with torch.inference_mode():
        got = tr(h(feats))
        proj = tr.nce_project(got)
    assert got.dtype == F16
    assert_rel(got, want, MODEL_REL, "NAR output")
    assert_rel(proj, want_proj, PROJ_REL, "NCE projection")


# ------------------------------------------------------- (d) the train steps

def _grad_probe():
    """optax transformation whose state becomes the gradients it is given:
    the JAX step's exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in jax.tree.leaves(tree)])


def _l2(got, want) -> float:
    g, w = _flat(got), _flat(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def check_step_gradients(got, want16, want32, what):
    """The port's f16 gradients (a JAX-layout tree) against JAX's f16 step
    and, with JAX's f16 step as the yardstick, JAX's f32 step."""
    assert jax.tree.structure(got) == jax.tree.structure(want16)
    assert np.isfinite(_flat(got)).all(), f"{what}: non-finite port gradient"
    err16 = _l2(got, want16)
    assert err16 <= STEP_L2, f"{what}: relative L2 {err16:.3e} from JAX's f16 step"
    ours, theirs = _l2(got, want32), _l2(want16, want32)
    assert ours <= 1.5 * theirs + 1e-3, (
        f"{what}: {ours:.3e} from JAX's f32 step, JAX's f16 step {theirs:.3e}")


def check_losses(m, jm, keys):
    for k in keys:
        w = float(jm[k])
        assert abs(float(m[k]) - w) <= LOSS_REL * max(1.0, abs(w)), (k, float(m[k]), w)


def _stage2_step(nar: bool):
    """One FAR or NAR step of both packages in f16 from one set of seeded
    weights, dropout 0: (port metrics, port gradients, JAX f16 metrics and
    gradients, JAX f32 gradients on the same weights)."""
    if nar:
        jc, tc = small_nar_cfgs(3, 3, dropout=0.0, drop_path=0.0)
    else:
        over = {"transformer": dict(dropout=0.0, drop_path=0.0)}
        jc, tc = (c.override(over) for c in small_cfgs())
    rng = np.random.default_rng(22)
    frames = rng.uniform(0, 1, (2, 6, 64, 64, 1)).astype(np.float32)
    past, future = frames[:, :3], frames[:, 3:]
    feats = jh(np.zeros((2, 3 if nar else 5, 8, 8, 48)))
    jenc, jdec = jbuild_ae(jc.ae, dtype=JF16)
    ev = random_variables(jenc.init, rng, jh(frames))
    dv = random_variables(jdec.init, rng, feats)
    jtr = jbuild_tr(jc.transformer, dtype=JF16)
    tv = random_variables(partial(jtr.init, method="init_all") if nar else jtr.init, rng,
                          feats)
    make = jmake_nar_train_step if nar else jmake_far_train_step
    jgrads, jm16 = {}, None
    for name, dt in (("f16", JF16), ("f32", jnp.float32)):
        je, jd = jbuild_ae(jc.ae, dtype=dt)
        jt = jbuild_tr(jc.transformer, dtype=dt)
        js = Stage2TrainState(
            step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
            transformer=ModuleState.from_variables(tv), t_opt=_grad_probe().init(tv["params"]),
            enc=ModuleState.from_variables(ev), dec=ModuleState.from_variables(dv),
            disc=None, d_opt=None)
        jnew, jm = jax.jit(make(je, jd, jt, None, _grad_probe(), None, jc.loss))(
            js, jnp.asarray(past).astype(dt), jnp.asarray(future).astype(dt))
        jgrads[name] = jnew.t_opt
        jm16 = jm if name == "f16" else jm16

    enc, dec = build_autoencoder(tc.ae, F16, device="cpu")
    load_jax_variables(enc, ev)
    load_jax_variables(dec, dv)
    tr = load_jax_variables(build_transformer(tc.transformer, F16, device="cpu"), tv)
    opt = build_optimizer(tc.optim, tc.transformer.d_model)
    create = create_nar_train_state if nar else create_far_train_state
    state = create(enc, dec, tr, opt, seed=0).clone()
    step = (make_nar_train_step if nar else make_far_train_step)(
        enc, dec, state.transformer, opt, tc.loss)
    state, m = step(state, h(past), h(future))
    got = export_jax_variables(
        state.transformer, {n: p.grad for n, p in state.transformer.named_parameters()})
    return m, got["params"], jm16, jgrads


@pytest.mark.parametrize("nar", [False, True], ids=["far", "nar"])
def test_stage2_train_step_f16_matches_jax(nar):
    m, got, jm, jgrads = _stage2_step(nar)
    keys = ("T_MSE", "T_GDL", "T_total") + (("T_bpc",) if nar else ())
    check_losses(m, jm, keys)
    check_step_gradients(got, jgrads["f16"], jgrads["f32"], "NAR step" if nar else "FAR step")
    norm16 = float(optax.global_norm(jgrads["f16"]))
    assert float(m["grad_norm"]) == pytest.approx(norm16, rel=0.05)


def test_ae_gan_train_step_f16_matches_jax():
    """ae_mnist at TINY widths with the GAN term (D updated before G), f16
    in both packages: losses, and the encoder's, decoder's and
    discriminator's gradients as above."""
    jc, tc = tiny_cfgs("ae_mnist")
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 4, 32, 32, 1)).astype(np.float32)
    jvars, results = None, {}
    for name, dt in (("f16", JF16), ("f32", jnp.float32)):
        jenc, jdec = jbuild_ae(jc.ae, dtype=dt)
        jdisc = jbuild_disc(jc.disc, dtype=dt)
        if jvars is None:
            jvars = {"enc": random_variables(jenc.init, rng, jh(x)),
                     "dec": random_variables(jdec.init, rng, jh(np.zeros((2, 4, 4, 4, 8)))),
                     "disc": random_variables(jdisc.init, rng, jh(x[:, 0]))}
        g_opt = recording(jlosses.build_optimizer(jc.optim))
        d_opt = recording(jlosses.build_optimizer(jc.optim_d))
        ms = ModuleState.from_variables
        js = AETrainState(
            step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3), enc=ms(jvars["enc"]),
            dec=ms(jvars["dec"]), disc=ms(jvars["disc"]),
            g_opt=g_opt.init((jvars["enc"]["params"], jvars["dec"]["params"])),
            d_opt=d_opt.init(jvars["disc"]["params"]))
        step = jax.jit(jmake_ae_train_step(jenc, jdec, jdisc, g_opt, d_opt, jc.loss))
        results[name] = step(js, jnp.asarray(x[:, :2]).astype(dt),
                             jnp.asarray(x[:, 2:]).astype(dt))

    enc, dec = build_autoencoder(tc.ae, F16, device="cpu")
    disc = build_discriminator(tc.disc, F16, device="cpu")
    g_opt, d_opt = build_optimizer(tc.optim), build_optimizer(tc.optim_d)
    state = ae_train_state_from_jax(jvars, enc, dec, disc, g_opt, d_opt)
    state, m = make_ae_train_step(enc, dec, disc, g_opt, d_opt, tc.loss)(
        state, h(x[:, :2]), h(x[:, 2:]))
    jnew, jm = results["f16"]
    check_losses(m, jm, ("AE_MSE", "AE_GDL", "AEgan", "AE_total", "Dtotal", "Dfake", "Dreal"))
    assert float(m["Dtotal"]) > 0
    j32 = results["f32"][0]
    for name, module, want16, want32 in (
            ("enc", state.enc, jnew.g_opt[1][0], j32.g_opt[1][0]),
            ("dec", state.dec, jnew.g_opt[1][1], j32.g_opt[1][1]),
            ("disc", state.disc, jnew.d_opt[1], j32.d_opt[1])):
        got = export_jax_variables(module, {n: p.grad for n, p in module.named_parameters()})
        check_step_gradients(got["params"], want16, want32, f"AE step {name}")


# ------------------------------------------- (e) optimizer, dtype map, the CLI

def test_adamw_f16_first_moment_matches_optax():
    """clip -> AdamW with ``mu_dtype = "float16"`` over 5 steps (clipping on
    and off) against optax's chain with an f16 first moment."""
    jc, tc = small_cfgs()
    over = {"optim": {"mu_dtype": "float16", "max_grad_norm": 1.0}}
    jopt = jlosses.build_optimizer(jc.override(over).optim, 48)
    topt = build_optimizer(tc.override(over).optim, 48)
    rng = np.random.default_rng(66)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = {k: t(v) for k, v in params.items()}
    tstate = topt.init(tp)
    for i in range(5):
        s = 0.1 if i % 2 == 0 else 1.0
        g = {k: (s * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate, _ = topt.update({k: t(v) for k, v in g.items()}, tstate, tp)
        tp = {k: tp[k] + tupd[k] for k in tp}
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=2e-6, rtol=0)
    mu = jstate[-1][0].mu
    for k in tp:
        assert tstate.mu[k].dtype == F16 and mu[k].dtype == JF16
        want = np.asarray(mu[k]).astype(np.float32)
        ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
        assert (np.abs(tstate.mu[k].float().numpy() - want) <= ulp).all(), k


def test_dtype_map_takes_float16():
    assert _dtype_of("float16") is torch.float16
    assert _dtype_of("bfloat16") is torch.bfloat16 and _dtype_of("float32") is torch.float32
    with pytest.raises(ValueError, match="dtype must be one of"):
        _dtype_of("float64")


def test_float16_under_a_model_axis_is_refused():
    """f16 with ``mesh.model`` > 1 is queued: the Trainer raises before it
    builds a mesh, naming float16."""
    from vptr_tpu_torch.train.trainer import Trainer

    _, tc = small_cfgs()
    with pytest.raises(ValueError, match="float16 under mesh.model 2 is queued"):
        Trainer(tc.override({"dtype": "float16", "mesh": {"data": 1, "model": 2}}),
                device="cpu", write_outputs=False)


def test_cli_train_float16(tmp_path):
    """``cli train --set dtype=float16 --device cpu`` at the CLI tests' tiny
    geometry: two steps and a validation pass, finite losses, an f16
    model and the checkpoint written."""
    import json

    run = tmp_path / "run"
    main(["train", "--preset", "far_mnist", "--ckpt-dir", str(run), "--device", "cpu",
          *TINY_SETS, "--set", "dtype=float16", "--set", "epochs=1",
          "--set", "steps_per_epoch=2", "--set", "val_per_epochs=1"])
    assert (run / "ckpt" / "2" / "state.pt").is_file()
    history = json.loads((run / "ckpt" / "history.json").read_text())
    assert np.isfinite([r[1] for r in history["train"]["T_total"]]).all()
    assert json.loads((run / "ckpt" / "config.json").read_text())["dtype"] == "float16"
