"""Kernels #7-#10 under tensor parallelism against their plain versions and
the whole call, on the card: #7/#8 on the hidden halves and quarters of
far_mnist's fused-FFN step (12,160 rows, C 528, 1056 and 528 of 2112
hidden columns), #9/#10's tiled route split at its statistics on two
ranks' halves of the channels at far_mnist's step (190 samples of 8 x 8 x
1056 a rank) and nar_kth_128's (80 of 16 x 16 x 1056), and on four ranks'
quarters whose last tile of a grid row is partial (far_mnist's 528 a rank:
16 tiles and 16 lanes; 40 of 160: one tile and 8 lanes), the ranks run in
step in one process (``fused_dw_chain.run_split``: the exchange stacks
their partials where a mesh gathers them over the model group).

Marked ``gpu``: each test skips when ``torch.cuda.is_available()`` is false
(decided inside the fixture). Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_port_tp_fused_gpu.py

Tolerances (chip_smoke's phase 3): forwards bf16 2^-4, f32 1e-3;
backwards relative to the largest magnitude of each gradient, bf16 2^-5,
f32 1e-4; a sum of the shares twice those. The split route's merges take
the whole call's partials in its order where the shares are whole
32-channel tiles, so each rank's output and gradients are the whole tiled
call's slice, bit for bit; a share that ends in a partial tile merges
tiles of two sizes, so it is held to the whole tiled call's slice within
the tolerances above, and two calls give the same bits.
"""

import pytest
import torch

from vptr_tpu_torch.ops import fused_dw_chain as tdw
from vptr_tpu_torch.ops import fused_ffn as tff

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


def _seed(cuda):
    return torch.tensor([2525], dtype=torch.int32, device=cuda)


def _halves(ops, m, hl):
    """#7's operands for hidden columns m hl .. (m + 1) hl: w1's columns,
    b1's and w2's rows, b2 zero (a half, or any share of hl columns)."""
    x, w1, b1, w2, b2, ls, lb = ops
    cols = slice(m * hl, (m + 1) * hl)
    return (x, w1[:, cols].contiguous(), b1[cols].contiguous(), w2[cols].contiguous(),
            torch.zeros_like(b2), ls, lb)


def _ffn_shares(cuda, dtype, rate, parts):
    """#7/#8 on ``parts`` equal shares of far_mnist's 2112 hidden columns,
    each against its plain version, and the shares together against the
    whole call."""
    g = torch.Generator().manual_seed(25)
    s, c, h = (12160, 528, 2112) if dtype == BF else (1216, 528, 2112)
    r = lambda *sh, std=1.0: (torch.randn(*sh, generator=g) * std).to(cuda)
    ops = (r(s, c).to(dtype), r(c, h, std=c ** -0.5).to(dtype), r(h, std=0.1),
           r(h, c, std=h ** -0.5).to(dtype), r(c, std=0.1), 1 + r(c, std=0.1), r(c, std=0.1))
    gout = r(s, c).to(dtype)
    seed, hl = _seed(cuda), h // parts
    outs, grads = [], []
    for m in range(parts):
        sub = _halves(ops, m, hl)
        kw = dict(mask_cols=h, col0=m * hl)
        got = tff.fused_ffn(*sub, seed, rate, **kw)
        want = tff.fused_ffn_plain(*sub, seed, rate, **kw)
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
        kg = tff.fused_ffn_backward(*sub, seed, gout, rate, **kw)
        pg = tff.fused_ffn_backward_plain(*sub, seed, gout, rate, **kw)
        for a, b in zip(kg, pg):
            assert _rel_err(a, b) <= BWD_TOL[dtype]
        outs.append(got)
        grads.append(kg)
    whole = tff.fused_ffn(*ops, seed, rate)
    summed = sum(o.float() for o in outs) + ops[4]
    assert (summed - whole.float()).abs().max().item() <= 2 * TOL[dtype]
    wg = tff.fused_ffn_backward(*ops, seed, gout, rate)
    for i in (0, 5, 6):                       # dx, dls, dlb: the shares' partial sums
        assert _rel_err(sum(gr[i].float() for gr in grads), wg[i]) <= 2 * BWD_TOL[dtype]
    for i, dim in ((1, 1), (2, 0), (3, 0)):   # dw1, db1, dw2: the shares
        assert _rel_err(torch.cat([gr[i] for gr in grads], dim), wg[i]) <= BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_hidden_halves(cuda, dtype, rate):
    _ffn_shares(cuda, dtype, rate, 2)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_hidden_quarters(cuda, dtype, rate):
    """far_mnist over mesh.model 4: 528 hidden columns a rank (2.75 of
    #7's 192-column chunks)."""
    _ffn_shares(cuda, dtype, rate, 4)


def _dw_operands(g, n, hw, c, dtype, cuda):
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    return (r(n, hw, c).to(dtype), r(9, c, std=0.3), r(c, std=0.1),
            1 + r(hw, c, std=0.1), r(hw, c, std=0.1), 1 + r(hw, c, std=0.1),
            r(hw, c, std=0.1))


def _grad_slices(grads, cols):
    """(dx, dtaps, ddwb, ds1, db1, ds2, db2) at channels ``cols``."""
    return [grads[0][..., cols], grads[1][:, cols], grads[2][cols]] + [d[:, cols]
                                                                        for d in grads[3:]]


def _share(ops, m, cl):
    cols = slice(m * cl, (m + 1) * cl)
    return tuple(o[..., cols].contiguous() for o in ops)


@pytest.mark.parametrize("shape", [(190, 64, 8, 2112), (80, 256, 16, 2112), (12, 64, 8, 256)],
                         ids=["far_mnist", "nar_kth_128", "small"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_dw_split_is_the_whole_tiled_calls_slice(cuda, shape, dtype):
    n, hw, w, c = shape
    if dtype == F32 and c > 256:
        pytest.skip("f32 at the small shape only (the plain version's f32 intermediates)")
    g = torch.Generator().manual_seed(26)
    ops = _dw_operands(g, n, hw, c, dtype, cuda)
    gout = (torch.randn(n, hw, c, generator=g)).to(cuda, dtype)
    seed, rate, cl = _seed(cuda), 0.1, c // 2
    whole = tdw._forward_kernel(*ops, seed, w, rate, route="tiled")
    wgr = tdw._backward_kernel(*ops, seed, gout, w, rate, route="tiled")
    plain = tdw.fused_dw_chain_plain(*ops, seed, w, rate)
    before = (tdw.fused_dw_chain.launches_by_route["tiled_split"],
              tdw.fused_dw_chain.bwd_launches_by_route["tiled_split"])
    shares = [_share(ops, m, cl) for m in range(2)]
    outs = tdw.run_split([tdw.split_forward(*shares[m], seed, w, rate, (2, m))
                          for m in range(2)])
    gshares = [gout[..., m * cl:(m + 1) * cl].contiguous() for m in range(2)]
    bwds = tdw.run_split([tdw.split_backward(*shares[m], seed, gshares[m], w, rate, (2, m))
                          for m in range(2)])
    torch.cuda.synchronize()
    assert (tdw.fused_dw_chain.launches_by_route["tiled_split"],
            tdw.fused_dw_chain.bwd_launches_by_route["tiled_split"]) == (before[0] + 2,
                                                                         before[1] + 2)
    for m in range(2):
        cols = slice(m * cl, (m + 1) * cl)
        assert torch.equal(outs[m], whole[..., cols])
        assert (outs[m].float() - plain[..., cols].float()).abs().max().item() <= TOL[dtype]
        for a, b in zip(bwds[m], _grad_slices(wgr, cols)):
            assert torch.equal(a, b)
    del plain
    pg = tdw.fused_dw_chain_backward_plain(*ops, seed, gout, w, rate)
    for m in range(2):
        cols = slice(m * cl, (m + 1) * cl)
        for a, b in zip(bwds[m], _grad_slices(pg, cols)):
            assert _rel_err(a, b) <= BWD_TOL[dtype]



@pytest.mark.parametrize("shape", [(190, 64, 8, 2112), (12, 64, 8, 160)],
                         ids=["far_mnist", "small"])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_dw_split_on_partial_tiles(cuda, shape, dtype):
    """Four ranks' quarters, each ending its grid rows in a partial tile
    (far_mnist: 528 = 16 tiles + 16 lanes; small: 40 = 1 tile + 8): every
    share against the plain version's slice and the whole tiled call's
    within the tolerances, two calls bit-equal, and the counts."""
    n, hw, w, c = shape
    if dtype == F32 and c > 256:
        pytest.skip("f32 at the small shape only (the plain version's f32 intermediates)")
    g = torch.Generator().manual_seed(27)
    ops = _dw_operands(g, n, hw, c, dtype, cuda)
    gout = (torch.randn(n, hw, c, generator=g)).to(cuda, dtype)
    seed, rate, m_, cl = _seed(cuda), 0.1, 4, c // 4
    assert cl % tdw.T_CH and tdw.split_ok(hw, cl, w, n)
    shares = [_share(ops, m, cl) for m in range(m_)]
    gshares = [gout[..., m * cl:(m + 1) * cl].contiguous() for m in range(m_)]
    before = (tdw.fused_dw_chain.launches_by_route["tiled_split"],
              tdw.fused_dw_chain.bwd_launches_by_route["tiled_split"])

    def run():
        outs = tdw.run_split([tdw.split_forward(*shares[m], seed, w, rate, (m_, m))
                              for m in range(m_)])
        bwds = tdw.run_split([tdw.split_backward(*shares[m], seed, gshares[m], w, rate,
                                                 (m_, m)) for m in range(m_)])
        return outs, bwds

    outs, bwds = run()
    again = run()
    torch.cuda.synchronize()
    assert (tdw.fused_dw_chain.launches_by_route["tiled_split"],
            tdw.fused_dw_chain.bwd_launches_by_route["tiled_split"]) == (before[0] + 2 * m_,
                                                                         before[1] + 2 * m_)
    for m in range(m_):
        assert torch.equal(outs[m], again[0][m])
        assert all(torch.equal(a, b) for a, b in zip(bwds[m], again[1][m]))
    del again
    whole = tdw._forward_kernel(*ops, seed, w, rate, route="tiled")
    wgr = tdw._backward_kernel(*ops, seed, gout, w, rate, route="tiled")
    plain = tdw.fused_dw_chain_plain(*ops, seed, w, rate)
    for m in range(m_):
        cols = slice(m * cl, (m + 1) * cl)
        assert (outs[m].float() - whole[..., cols].float()).abs().max().item() <= TOL[dtype]
        assert (outs[m].float() - plain[..., cols].float()).abs().max().item() <= TOL[dtype]
        for a, b in zip(bwds[m], _grad_slices(wgr, cols)):
            assert _rel_err(a, b) <= BWD_TOL[dtype]
    del plain, whole, wgr
    pg = tdw.fused_dw_chain_backward_plain(*ops, seed, gout, w, rate)
    for m in range(m_):
        for a, b in zip(bwds[m], _grad_slices(pg, slice(m * cl, (m + 1) * cl))):
            assert _rel_err(a, b) <= BWD_TOL[dtype]
