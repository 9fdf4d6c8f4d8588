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
(c) #9/#10 (``fused_dw_chain(..., model=(M, m))`` and its backward) on two
    gloo ranks (``tests/_torch_port_mp_worker.py``'s ``dw_split`` job,
    spawned once for the module), each on its half of the channels with
    the whole-sample LayerNorms over both ranks': through the wrapper and
    through the plain version under autograd, the output and every
    gradient against the whole plain call's channel slice and against the
    JAX package's Pallas kernels in interpret mode (1e-5, as
    ``test_torch_port_ffn_ops.py``), dropout 0 and 0.3, on an 8 x 8 and a
    4 x 16 grid; and on four gloo ranks (a second launch) over 176
    channels, 44 a rank: a share that on the card ends each grid row in a
    partial tile of 12 channels (one whole 32-channel tile and 12 lanes);
(d) the split route's limits (``split_ok``): far_mnist's hidden 2112 over
    mesh.model 2, 4 and 8 (1056, 528 = 16 tiles and a half, 264 a rank)
    taken; a grid wider than 32 and more than 65,535 samples refused
    before any launch, naming the limit; a share without the mesh's model
    group.
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
# case -> (rows, grid width, dropout rate, seed, ranks, channels); the
# four-rank case's 44 channels a rank are one whole tile and 12 lanes
DW_CASES = {"8x8": (8, 8, 0.0, 31, 2, 64), "8x8_drop": (8, 8, 0.3, 32, 2, 64),
            "4x16_drop": (4, 16, 0.3, 33, 2, 64),
            "8x8_drop_4ranks_partial_tile": (8, 8, 0.3, 34, 4, 176)}
N = 3


def _dw_case(name):
    h, w, rate, seed, _, cg = DW_CASES[name]
    rng = np.random.default_rng(seed)
    hw = h * w
    args = [a.astype(np.float32) for a in (
        rng.standard_normal((N, hw, cg)), rng.standard_normal((9, cg)) * 0.2,
        rng.standard_normal(cg) * 0.05, 1 + 0.1 * rng.standard_normal((hw, cg)),
        0.1 * rng.standard_normal((hw, cg)), 1 + 0.1 * rng.standard_normal((hw, cg)),
        0.1 * rng.standard_normal((hw, cg)))]
    g = rng.standard_normal((N, hw, cg)).astype(np.float32)
    return {"args": args, "g": g, "seed": seed * 7, "w": w, "rate": rate}


@pytest.fixture(scope="module")
def dw_ranks(tmp_path_factory):
    """The cases and a launch a world size (2 and 4 ranks), each running
    that world's cases."""
    cases = {name: _dw_case(name) for name in DW_CASES}
    launches = {}
    for world in sorted({c[4] for c in DW_CASES.values()}):
        out = tmp_path_factory.mktemp(f"dw_split_w{world}")
        with open(out / "cases.pkl", "wb") as f:
            pickle.dump({n: c for n, c in cases.items() if DW_CASES[n][4] == world}, f)
        launches[world] = Launch("dw_split", out, world=world)
    yield cases, launches
    for launch in launches.values():
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


def _rank_slice(whole, i, r, m):
    """Rank r of m's share of output / gradient i of the whole call."""
    arr = np.asarray(whole[i])
    c = arr.shape[-1] // m
    return arr[..., r * c:(r + 1) * c]


@pytest.mark.parametrize("route", ["wrapper", "plain"])
@pytest.mark.parametrize("name", list(DW_CASES))
def test_dw_split_matches_the_whole_calls_slice(dw_ranks, name, route):
    cases, launches = dw_ranks
    case, world = cases[name], DW_CASES[name][4]
    want, oracle = _whole_plain(case), _whole_jax(case)
    results = launches[world].results()
    assert len(results) == world
    for r, res in enumerate(results):
        got = res[name][route]
        for i, what in enumerate(DW_GRADS):
            _close(got[i], _rank_slice(want, i, r, world), DW_TOL,
                   f"rank {r} {what} vs whole plain")
            _close(got[i], _rank_slice(oracle, i, r, world), DW_TOL, f"rank {r} {what} vs JAX")


# -------------------------------------------------------------- (d) limits

@pytest.mark.parametrize("model", [2, 4, 8])
def test_dw_split_takes_far_mnists_shares(model):
    """far_mnist's hidden 2112 over mesh.model 2, 4 and 8 (1056, 528 and
    264 channels a rank: 33 tiles, 16 and a half, 8 and a quarter) at its
    step's 190 samples of 8 x 8: the split route takes each."""
    c = 2112 // model
    assert tdw.split_ok(64, c, 8, 190)
    assert (c % tdw.T_CH == 0) == (model == 2)


def _dw_zeros(n, hw, c):
    return (torch.zeros(n, hw, c), torch.zeros(9, c), torch.zeros(c)) + tuple(
        torch.zeros(hw, c) for _ in range(4))


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("shape,w,limit", [((2, 128, 48), 64, "w <= 32"),
                                           ((65536, 1, 1), 1, "N <= 65535")],
                         ids=["grid_wider_than_32", "too_many_samples"])
def test_dw_split_refuses_what_the_route_cannot_take(direction, shape, w, limit):
    """The split route's two limits: a grid more than 32 wide and more than
    65,535 samples (a grid dimension); refused before anything is built or
    launched, naming the limit."""
    n, hw, c = shape
    assert not tdw.split_ok(hw, c, w, n)
    ops = _dw_zeros(n, hw, c)
    call = (tdw.split_forward(*ops, None, w, 0.0, (4, 1)) if direction == "forward" else
            tdw.split_backward(*ops, None, torch.zeros(n, hw, c), w, 0.0, (4, 1)))
    with pytest.raises(ValueError, match=limit):
        tdw.run_split([call])


def test_dw_share_needs_the_model_group():
    ops = [torch.zeros(2, 64, 32), torch.zeros(9, 32), torch.zeros(32)] + [
        torch.zeros(64, 32) for _ in range(4)]
    with pytest.raises(ValueError, match="needs the mesh's model group"):
        tdw.fused_dw_chain_plain(*ops, 0, 8, 0.0, model=(2, 0))
