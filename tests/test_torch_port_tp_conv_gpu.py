"""Kernels #11/#12 under tensor parallelism on the card: the tiled route's
steps as the conv FFN's column-parallel fc1 (``split_forward`` /
``split_backward``) and row-parallel fc2 (``rows_forward`` /
``rows_backward``), M ranks run in step in one process
(``ops/_split.py::run_split``: the exchange stacks their partials where a
mesh gathers them over the model group), against their plain versions on
the whole call and against the whole tiled call.

* at M 1 the steps are the whole tiled call: bit for bit the single-call
  forward and backward where ``kernel_route`` names the tiled route
  (nar_kth_128's 16 x 16 latent);
* fc1 on 2 and 4 ranks at far_mnist's 8 x 8 latent (where the whole call
  takes the cluster route) and at 16 x 16: each rank's output, dw, db,
  dscale, dbias2 against the plain call's slices, dx summed over the
  ranks against its dx;
* fc2 on 2 and 4 ranks: every rank's output and db, dscale, dbias2 the
  same bits, against the plain call's (not summed over the ranks), dx and
  dw against its slices;
* the launch counters by route.

Marked ``gpu``: each test skips when ``torch.cuda.is_available()`` is false
(decided inside the fixture). Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_port_tp_conv_gpu.py

Tolerances (chip_smoke's phase 3): forwards bf16 2^-4, f32 1e-3;
backwards relative to the largest magnitude of each gradient, bf16 2^-5,
f32 1e-4; a sum over the ranks twice those.
"""

import pytest
import torch

from vptr_tpu_torch.ops import conv_ln_gelu as tcl
from vptr_tpu_torch.ops._split import run_split

BF, F32 = torch.bfloat16, torch.float32
TOL = {F32: 1e-3, BF: 6.25e-2}
BWD_TOL = {F32: 1e-4, BF: 2 ** -5}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())).item()


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _ops(cuda, dtype, n, hw, cin, cout, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, std=1.0: torch.randn(*s, generator=g) * std
    return ((r(n, hw, cin).to(cuda, dtype), r(cin, cout, std=cin ** -0.5).to(cuda, dtype),
             r(cout, std=0.1).to(cuda), (1 + r(hw, cout, std=0.1)).to(cuda),
             r(hw, cout, std=0.1).to(cuda)), r(n, hw, cout).to(cuda, dtype))


def _cols(a, m, mm, dim=-1):
    k = a.shape[dim] // mm
    return a.narrow(dim, m * k, k).contiguous()


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("cin,cout", [(528, 2112), (2112, 528)])
def test_steps_at_one_rank_are_the_whole_tiled_call(cuda, dtype, cin, cout):
    """nar_kth_128's 16 x 16 latent, where the single call takes the tiled
    route: the steps at M 1 (split and rows alike) give its bits."""
    ops, g = _ops(cuda, dtype, 6, 256, cin, cout, 2601)
    assert tcl.kernel_route(256, cin, cout, dtype) == "tiled"
    whole, wgrads = tcl._forward_kernel(*ops), tcl._backward_kernel(*ops, g)
    split = run_split([tcl.split_forward(*ops, (1, 0))])[0]
    rows, u, st = run_split([tcl.rows_forward(*ops, (1, 0))])[0]
    assert torch.equal(split, whole) and torch.equal(rows, whole)
    for grads in (run_split([tcl.split_backward(*ops, g, (1, 0))])[0],
                  tcl.rows_backward(*ops, g, u, st)):
        assert all(torch.equal(a, b) for a, b in zip(grads, wgrads))


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("mm", [2, 4])
@pytest.mark.parametrize("hw", [64, 256])
def test_fc1_column_parallel(cuda, dtype, mm, hw):
    ops, g = _ops(cuda, dtype, 12, hw, 528, 2112, 2602 + mm)
    share = lambda m: (ops[0],) + tuple(_cols(t, m, mm) for t in ops[1:])
    before = dict(tcl.conv_ln_gelu.launches_by_route), dict(tcl.conv_ln_gelu.bwd_launches_by_route)
    outs = run_split([tcl.split_forward(*share(m), (mm, m)) for m in range(mm)])
    bwds = run_split([tcl.split_backward(*share(m), _cols(g, m, mm), (mm, m))
                      for m in range(mm)])
    assert tcl.conv_ln_gelu.launches_by_route["tiled_split"] == before[0]["tiled_split"] + mm
    assert tcl.conv_ln_gelu.bwd_launches_by_route["tiled_split"] == before[1]["tiled_split"] + mm
    plain = tcl.conv_ln_gelu_plain(*ops)
    pg = tcl.conv_ln_gelu_backward_plain(*ops, g)
    for m in range(mm):
        assert _max_err(outs[m], _cols(plain, m, mm)) <= TOL[dtype]
        assert _rel_err(bwds[m][1], _cols(pg[1], m, mm)) <= BWD_TOL[dtype]
        for got, want in zip(bwds[m][2:], pg[2:]):
            assert _rel_err(got, _cols(want, m, mm)) <= BWD_TOL[dtype]
    dx = sum(b[0].float() for b in bwds)
    assert _rel_err(dx, pg[0]) <= 2 * BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("mm", [2, 4])
@pytest.mark.parametrize("hw", [64, 256])
def test_fc2_row_parallel(cuda, dtype, mm, hw):
    ops, g = _ops(cuda, dtype, 12, hw, 2112, 528, 2612 + mm)
    share = lambda m: (_cols(ops[0], m, mm), _cols(ops[1], m, mm, 0)) + ops[2:]
    fwds = run_split([tcl.rows_forward(*share(m), (mm, m)) for m in range(mm)])
    bwds = [tcl.rows_backward(*share(m), g, *fwds[m][1:]) for m in range(mm)]
    plain = tcl.conv_ln_gelu_plain(*ops)
    pg = tcl.conv_ln_gelu_backward_plain(*ops, g)
    for m in range(mm):
        assert torch.equal(fwds[m][0], fwds[0][0])
        assert all(torch.equal(a, b) for a, b in zip(bwds[m][2:], bwds[0][2:]))
        assert _max_err(fwds[m][0], plain) <= TOL[dtype]
        assert _rel_err(bwds[m][0], _cols(pg[0], m, mm)) <= BWD_TOL[dtype]
        assert _rel_err(bwds[m][1], _cols(pg[1], m, mm, 0)) <= BWD_TOL[dtype]
        for got, want in zip(bwds[m][2:], pg[2:]):
            assert _rel_err(got, want) <= BWD_TOL[dtype]


def test_wrapper_under_a_model_axis_refuses_a_shape_the_steps_do_not_take(cuda):
    """A rank's 264 hidden channels (far_mnist's 2112 over 8) are not whole
    16-column tiles: raised, naming the limit, never the plain version."""
    ops, _ = _ops(cuda, BF, 2, 64, 528, 264, 2620)
    with pytest.raises(ValueError, match="multiples of 16"):
        run_split([tcl.split_forward(*ops, (8, 0))])
