"""Kernels #11/#12 (``conv_ln_gelu`` and its backward) under tensor
parallelism, through their plain versions on the CPU (what the wrappers
take for CPU tensors), against the whole call and the JAX package.

(a) on two gloo ranks (``tests/_torch_port_mp_worker.py``'s ``conv_split``
    job, spawned once for the module), the conv FFN's two stages, each
    rank on its share: fc1 column-parallel (w's, b's, scale's and bias2's
    Cout channels; the whole-sample LayerNorm over both ranks'), fc2
    row-parallel (``rows=True``: x's and w's Cin channels; the partial
    products summed over the ranks before b). Through the wrapper and
    through the plain version under autograd, the output and every
    gradient against the whole plain call's and against the JAX package's
    Pallas kernels in interpret mode, in f32 within 1e-5 of the largest
    value of each: fc1's output, dw, db, dscale, dbias2 the whole call's
    channel slices and its dx the two ranks' partial sums added up; fc2's
    dx and dw the whole call's slices and its output, db, dscale, dbias2
    the whole call's on each rank (replicated parameters: a rank that
    summed them over the group would be off by a factor of 2);
(b) the limits of the tiled route's steps (a rank's Cout a multiple of 16,
    HW a multiple of 16), named before anything is launched, and a share
    without the mesh's model group.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptr_tpu.ops import fused_conv_ln as jcl
from vptr_tpu_torch.ops import conv_ln_gelu as tcl
from vptr_tpu_torch.ops._split import run_split

from _torch_port_mp_worker import Launch
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
WORLD = 2
OUTS = ("y", "dx", "dw", "db", "dscale", "dbias2")
# case -> (rows: fc2 row-parallel, samples, positions, Cin, Cout, seed)
CASES = {"fc1_64": (False, 3, 64, 32, 64, 41), "fc2_64": (True, 3, 64, 64, 32, 42),
         "fc1_16": (False, 5, 16, 48, 96, 43), "fc2_16": (True, 5, 16, 96, 48, 44)}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max |err| {err:.3e} > {bound:.3e}"


def _case(name):
    rows, n, hw, cin, cout, seed = CASES[name]
    rng = np.random.default_rng(seed)
    args = [a.astype(np.float32) for a in (
        rng.standard_normal((n, hw, cin)), rng.standard_normal((cin, cout)) * cin ** -0.5,
        rng.standard_normal(cout) * 0.1, 1 + 0.1 * rng.standard_normal((hw, cout)),
        0.1 * rng.standard_normal((hw, cout)))]
    g = rng.standard_normal((n, hw, cout)).astype(np.float32)
    return {"args": args, "g": g, "rows": rows}


@pytest.fixture(scope="module")
def conv_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("conv_split")
    cases = {name: _case(name) for name in CASES}
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    launch = Launch("conv_split", out, world=WORLD)
    yield cases, launch
    for p in launch.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _whole_plain(case):
    ops = [torch.from_numpy(a).requires_grad_() for a in case["args"]]
    y = tcl.conv_ln_gelu_plain(*ops)
    return [y.detach().numpy()] + [d.numpy() for d in
                                   torch.autograd.grad(y, ops, torch.from_numpy(case["g"]))]


def _whole_jax(case):
    jargs = [jnp.asarray(a) for a in case["args"]]
    y, vjp = jax.vjp(lambda *a: jcl.conv_ln_gelu(*a, 1e-5, True), *jargs)
    return [np.asarray(y)] + [np.asarray(d) for d in vjp(jnp.asarray(case["g"]))]


def _share(a, axis, r):
    n = a.shape[axis] // WORLD
    return np.take(a, range(r * n, (r + 1) * n), axis)


def _check(got_ranks, whole, rows, what):
    """Every rank's (y, dx, dw, db, dscale, dbias2) against the whole
    call's ``whole``, as the module notes say."""
    for r, got in enumerate(got_ranks):
        if rows:     # dx, dw: the rank's Cin channels; the rest whole
            wants = [whole[0], _share(whole[1], -1, r), _share(whole[2], 0, r)] + whole[3:]
        else:        # the rank's Cout channels; dx summed below
            wants = [_share(whole[0], -1, r), None, _share(whole[2], 1, r)] + [
                _share(whole[i], -1, r) for i in (3, 4, 5)]
        for i, want in enumerate(wants):
            if want is not None:
                _close(got[i], want, TOL, f"rank {r} {OUTS[i]} vs {what}")
    if not rows:
        _close(sum(np.asarray(got[1], np.float64) for got in got_ranks), whole[1], TOL,
               f"dx summed over the ranks vs {what}")


@pytest.mark.parametrize("route", ["wrapper", "plain"])
@pytest.mark.parametrize("name", list(CASES))
def test_conv_split_matches_the_whole_call(conv_ranks, name, route):
    cases, launch = conv_ranks
    case = cases[name]
    got = [res[name][route] for res in launch.results()]
    _check(got, _whole_plain(case), case["rows"], "the whole plain call")
    _check(got, _whole_jax(case), case["rows"], "JAX's interpret-mode kernels")


# -------------------------------------------------------------- (b) limits

def _ops(n, hw, cin, cout):
    return (torch.zeros(n, hw, cin), torch.zeros(cin, cout), torch.zeros(cout),
            torch.zeros(hw, cout), torch.zeros(hw, cout))


@pytest.mark.parametrize("shape,model", [((2, 64, 528, 264), (8, 1)),
                                         ((2, 36, 528, 1056), (2, 0))])
def test_conv_split_refuses_a_shape_the_steps_do_not_take(shape, model):
    """far_mnist's hidden 2112 over mesh.model 8 (264 channels a rank, not
    whole 16-column tiles) and a 6 x 6 latent (HW 36): refused by name,
    before anything is launched, column- and row-parallel alike."""
    ops = _ops(*shape)
    with pytest.raises(ValueError, match="multiples of 16"):
        run_split([tcl.split_forward(*ops, model)])
    n, hw, cin, cout = shape
    rows_ops = _ops(n, hw, cout, cin)
    with pytest.raises(ValueError, match="runs the tiled route's steps"):
        run_split([tcl.rows_forward(*rows_ops, model)])


def test_conv_share_needs_the_model_group():
    with pytest.raises(ValueError, match="needs the mesh's model group"):
        tcl.conv_ln_gelu_plain(*_ops(2, 16, 16, 16), model=(2, 0))
    with pytest.raises(ValueError, match="needs the mesh's model group"):
        tcl.conv_ln_gelu_backward_plain(*_ops(2, 16, 16, 16), torch.zeros(2, 16, 16),
                                        model=(2, 1), rows=True)
