"""Kernels #7-#10 under tensor parallelism, through their plain versions on
the CPU (what the wrappers take for CPU tensors), against the whole call
and the JAX package.

(a) the hidden-subset dropout masks: ``ffn_keep_mask`` and ``dw_keep_mask``
    with ``mask_cols`` / ``col0`` are the column slices of the JAX
    package's whole masks, bit for bit;
(b) #7/#8 (``fused_ffn`` and its backward) on two hidden halves (w1's
    columns, b1's and w2's rows, b2 zero, the mask at the global column),
    dropout 0 and 0.3: the halves' outputs summed plus b2, and their dx,
    dls, dlb summed, equal the whole plain call's, and their dw1, db1, dw2
    are its slices, in f32 within 1e-6 (of the largest value of each);
(c) #9/#10 (``fused_dw_chain(..., model=(2, m))`` and its backward) on two
    gloo ranks (``tests/_torch_port_mp_worker.py``'s ``dw_split`` job,
    spawned once for the module), each on its half of the channels with
    the whole-sample LayerNorms over both ranks': through the wrapper and
    through the plain version under autograd, the output and every
    gradient against the whole plain call's channel slice and against the
    JAX package's Pallas kernels in interpret mode (1e-5, as
    ``test_torch_port_ffn_ops.py``), dropout 0 and 0.3, on an 8 x 8 and a
    4 x 16 grid;
(d) the split route's limits: a rank's channels a multiple of 32 (far_mnist's
    2112 over mesh.model 4 is 528 a rank: refused, naming the limit), and
    a share without the mesh's model group.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.ops import fused_dw_chain as jdw
from vptr_tpu.ops import fused_ffn as jffn
from vptr_tpu_torch.ops import dropout as tdrop
from vptr_tpu_torch.ops import fused_dw_chain as tdw
from vptr_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_plain

from _torch_port_mp_worker import Launch
from _torch_port_util import t
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

FFN_TOL = 1e-6
DW_TOL = 1e-5


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max |err| {err:.3e} > {bound:.3e}"


# ------------------------------------------------------------------ (a) masks

@pytest.mark.parametrize("cols", [(0, 48), (48, 48), (16, 32)])
def test_ffn_subset_mask_is_the_whole_masks_slice(cols):
    c0, hl = cols
    seed, rows, hg = 4321, 37, 96
    want = np.asarray(jffn.ffn_keep_mask(seed, rows, hg, 0.3))[:, c0:c0 + hl]
    got = tdrop.ffn_keep_mask(seed, rows, hl, 0.3, mask_cols=hg, col0=c0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cols", [(0, 32), (32, 32)])
def test_dw_subset_mask_is_the_whole_masks_slice(cols):
    c0, cl = cols
    seed, n, hw, cg = 99, 5, 64, 64
    want = np.asarray(jdw.dw_keep_mask(seed, n, hw, cg, 0.1))[..., c0:c0 + cl]
    got = tdrop.dw_keep_mask(seed, n, hw, cl, 0.1, mask_cols=cg, col0=c0).numpy()
    np.testing.assert_array_equal(got, want)


def test_subset_mask_refuses_columns_outside_the_whole():
    with pytest.raises(ValueError, match="are not columns of 64"):
        tdrop.dw_keep_mask(1, 2, 4, 32, 0.1, mask_cols=64, col0=48)


# ------------------------------------------------------------ (b) #7/#8 halves

FFN_GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb")


def _ffn_args(rng, s, c, h):
    return [a.astype(np.float32) for a in (
        rng.standard_normal((s, c)), rng.standard_normal((c, h)) * c ** -0.5,
        rng.standard_normal(h) * 0.1, rng.standard_normal((h, c)) * h ** -0.5,
        rng.standard_normal(c) * 0.1, 1 + 0.1 * rng.standard_normal(c),
        0.1 * rng.standard_normal(c))]


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_ffn_hidden_halves_sum_to_the_whole_call(rate):
    rng = np.random.default_rng(90)
    s, c, h, seed = 136, 48, 192, 777
    args = _ffn_args(rng, s, c, h)
    g = t(rng.standard_normal((s, c)).astype(np.float32))
    whole = [t(a).requires_grad_() for a in args]
    want = fused_ffn_plain(*whole, seed, rate)
    want_grads = torch.autograd.grad(want, whole, g)

    hl = h // 2
    outs, grads = [], []
    for m in range(2):
        cols = slice(m * hl, (m + 1) * hl)
        x, w1, b1, w2, b2, ls, lb = (t(a) for a in args)
        ops = [x, w1[:, cols].contiguous(), b1[cols].contiguous(), w2[cols].contiguous(),
               torch.zeros_like(b2), ls, lb]
        ops = [o.requires_grad_() for o in ops]
        y = fused_ffn(*ops, seed, rate, mask_cols=h, col0=m * hl)
        outs.append(y.detach())
        grads.append(torch.autograd.grad(y, ops, g))
    b2 = t(args[4])
    _close(outs[0] + outs[1] + b2, want.detach(), FFN_TOL, "y (halves summed + b2)")
    for i in (0, 5, 6):                              # dx, dls, dlb: partial sums
        _close(grads[0][i] + grads[1][i], want_grads[i], FFN_TOL, FFN_GRADS[i])
    for i, dim in ((1, 1), (2, 0), (3, 0)):          # dw1, db1, dw2: the shares
        _close(torch.cat([grads[0][i], grads[1][i]], dim), want_grads[i], FFN_TOL,
               FFN_GRADS[i])


def test_ffn_subset_refuses_columns_outside_the_whole():
    rng = np.random.default_rng(91)
    ops = [t(a) for a in _ffn_args(rng, 8, 16, 32)]
    with pytest.raises(ValueError, match="are not columns of 48"):
        fused_ffn(*ops, 0, 0.0, mask_cols=48, col0=32)


# --------------------------------------------------- (c) #9/#10 on two ranks

DW_GRADS = ("z3", "dx", "dtaps", "ddwb", "ds1", "db1", "ds2", "db2")
# case -> (rows, grid width, dropout rate, seed)
DW_CASES = {"8x8": (8, 8, 0.0, 31), "8x8_drop": (8, 8, 0.3, 32),
            "4x16_drop": (4, 16, 0.3, 33)}
N, CG = 3, 64


def _dw_case(name):
    h, w, rate, seed = DW_CASES[name]
    rng = np.random.default_rng(seed)
    hw = h * w
    args = [a.astype(np.float32) for a in (
        rng.standard_normal((N, hw, CG)), rng.standard_normal((9, CG)) * 0.2,
        rng.standard_normal(CG) * 0.05, 1 + 0.1 * rng.standard_normal((hw, CG)),
        0.1 * rng.standard_normal((hw, CG)), 1 + 0.1 * rng.standard_normal((hw, CG)),
        0.1 * rng.standard_normal((hw, CG)))]
    g = rng.standard_normal((N, hw, CG)).astype(np.float32)
    return {"args": args, "g": g, "seed": seed * 7, "w": w, "rate": rate}


@pytest.fixture(scope="module")
def dw_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dw_split")
    cases = {name: _dw_case(name) for name in DW_CASES}
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    launch = Launch("dw_split", out, world=2)
    yield cases, launch
    for p in launch.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _whole_plain(case):
    ops = [t(a).requires_grad_() for a in case["args"]]
    y = tdw.fused_dw_chain_plain(*ops, case["seed"], case["w"], case["rate"])
    return [y.detach()] + list(torch.autograd.grad(y, ops, t(case["g"])))


def _whole_jax(case):
    jargs = [jnp.asarray(a) for a in case["args"]]
    y, vjp = jax.vjp(lambda *a: jdw.fused_dw_chain(*a, case["seed"], case["w"], case["rate"],
                                                   2, True), *jargs)
    return [np.asarray(y)] + [np.asarray(d) for d in vjp(jnp.asarray(case["g"]))]


def _rank_slice(whole, i, r, m=2):
    """Rank r's share of output / gradient i of the whole call."""
    c = CG // m
    return np.asarray(whole[i])[..., r * c:(r + 1) * c]


@pytest.mark.parametrize("route", ["wrapper", "plain"])
@pytest.mark.parametrize("name", list(DW_CASES))
def test_dw_split_matches_the_whole_calls_slice(dw_ranks, name, route):
    cases, launch = dw_ranks
    case = cases[name]
    want, oracle = _whole_plain(case), _whole_jax(case)
    for r, res in enumerate(launch.results()):
        got = res[name][route]
        for i, what in enumerate(DW_GRADS):
            _close(got[i], _rank_slice(want, i, r), DW_TOL, f"rank {r} {what} vs whole plain")
            _close(got[i], _rank_slice(oracle, i, r), DW_TOL, f"rank {r} {what} vs JAX")


# -------------------------------------------------------------- (d) limits

def test_dw_split_refuses_a_share_that_is_not_whole_tiles():
    """far_mnist's hidden 2112 over mesh.model 4: 528 channels a rank, not
    whole 32-channel tiles; refused before anything is launched."""
    x = torch.zeros(2, 64, 528)
    ops = (x, torch.zeros(9, 528), torch.zeros(528)) + tuple(torch.zeros(64, 528)
                                                             for _ in range(4))
    with pytest.raises(ValueError, match="a rank's channels a multiple of 32"):
        tdw.run_split([tdw.split_forward(*ops, None, 8, 0.0, (4, 1))])


def test_dw_share_needs_the_model_group():
    ops = [torch.zeros(2, 64, 32), torch.zeros(9, 32), torch.zeros(32)] + [
        torch.zeros(64, 32) for _ in range(4)]
    with pytest.raises(ValueError, match="needs the mesh's model group"):
        tdw.fused_dw_chain_plain(*ops, 0, 8, 0.0, model=(2, 0))
