"""Kernels #9-#12 on their tiled routes against their plain versions, on
the card: nar_kth_128's 16 x 16 latents (HW 256; 80 samples: 8 clips of 10
frames) at the hidden width 2112 of the fused-FFN route (#9/#10) and at
both stages of the conv-FFN route (#11/#12: 528 -> 2112, 2112 -> 528), and
smaller shapes forced onto the tiled routes (grids 5 to 32 wide, C from 64;
HW 80 to 1024, Cout that the cluster route does not split).

Marked ``gpu``: each test skips when ``torch.cuda.is_available()`` is false
(decided inside the fixture). Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_port_kth128_gpu.py

Tolerances (chip_smoke's phase 3): forwards bf16 2^-4 (one bf16 ulp of
outputs up to 8), f32 1e-3; backwards relative to the largest magnitude of
each gradient, bf16 2^-5, f32 1e-4. The routes' sums are in a fixed order,
so two calls give the same bits.
"""

import pytest
import torch

from vptr_tpu_torch.ops import conv_ln_gelu as tcl
from vptr_tpu_torch.ops import fused_dw_chain as tdw

BF, F32 = torch.bfloat16, torch.float32
TOL = {F32: 1e-3, BF: 6.25e-2}
BWD_TOL = {F32: 1e-4, BF: 2 ** -5}
DW_GRADS = ("dx", "dtaps", "ddwb", "ds1", "db1", "ds2", "db2")
CONV_GRADS = ("dx", "dw", "db", "dscale", "dbias2")


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
    return torch.tensor([2323], dtype=torch.int32, device=cuda)


def _dw_operands(g, n, hw, c, dtype, cuda):
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    return (r(n, hw, c).to(dtype), r(9, c, std=0.3), r(c, std=0.1),
            1 + r(hw, c, std=0.1), r(hw, c, std=0.1), 1 + r(hw, c, std=0.1),
            r(hw, c, std=0.1))


def _conv_operands(g, n, hw, cin, cout, dtype, cuda):
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    return (r(n, hw, cin).to(dtype), r(cin, cout, std=cin ** -0.5).to(dtype),
            r(cout, std=0.1), 1 + r(hw, cout, std=0.1), r(hw, cout, std=0.1))


def _check_dw(args, seed, dout, w, rate, forced=False):
    """#9 and #10 on the tiled route (forced onto it, or named by the route
    functions) against the plain versions; two calls of each give the same
    bits; one launch a call, on the tiled route."""
    fwd = (lambda: tdw._forward_kernel(*args, seed, w, rate, route="tiled")) if forced else (
        lambda: tdw.fused_dw_chain(*args, seed, w, rate))
    bwd = (lambda: tdw._backward_kernel(*args, seed, dout, w, rate, route="tiled")) \
        if forced else (lambda: tdw.fused_dw_chain_backward(*args, seed, dout, w, rate))
    before = (tdw.fused_dw_chain.launches_by_route["tiled"],
              tdw.fused_dw_chain.bwd_launches_by_route["tiled"])
    got, again = fwd(), fwd()
    want = tdw.fused_dw_chain_plain(*args, seed, w, rate)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[args[0].dtype]
    assert torch.equal(got, again)
    del got, again, want
    grads, grads2 = bwd(), bwd()
    want = tdw.fused_dw_chain_backward_plain(*args, seed, dout, w, rate)
    torch.cuda.synchronize()
    assert (tdw.fused_dw_chain.launches_by_route["tiled"],
            tdw.fused_dw_chain.bwd_launches_by_route["tiled"]) == (before[0] + 2, before[1] + 2)
    for name, a, b, a2 in zip(DW_GRADS, grads, want, grads2):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[args[0].dtype], name
        assert torch.equal(a, a2), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_dw_chain_tiled_route_at_nar_kth_128(cuda, dtype, rate):
    """80 samples of 16 x 16 x 2112, the route kernel_route and
    backward_route name in both dtypes."""
    assert tdw.kernel_route(256, 2112, dtype, 16) == "tiled"
    assert tdw.backward_route(256, 2112, dtype, 16) == "tiled"
    g = torch.Generator().manual_seed(40)
    args = _dw_operands(g, 80, 256, 2112, dtype, cuda)
    dout = torch.randn(80, 256, 2112, generator=g).to(cuda, dtype)
    _check_dw(args, _seed(cuda), dout, 16, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("n,hw,w,c", [(7, 64, 8, 2112), (5, 40, 5, 96), (3, 32, 32, 64),
                                      (9, 48, 16, 128), (1, 256, 16, 64), (11, 12, 4, 32)])
def test_fused_dw_chain_tiled_route_on_other_grids(cuda, dtype, n, hw, w, c):
    """Shapes forced onto the tiled route: far_mnist's 8 x 8 x 2112, grids
    5, 32 (every thread's four positions), 16 and 4 wide, one sample (one
    sample group), C from 32 up; dropout 0.1."""
    g = torch.Generator().manual_seed(41)
    args = _dw_operands(g, n, hw, c, dtype, cuda)
    dout = torch.randn(n, hw, c, generator=g).to(cuda, dtype)
    _check_dw(args, _seed(cuda), dout, w, 0.1, forced=True)


@pytest.mark.gpu
def test_fused_dw_chain_tiled_route_refusals(cuda):
    """A grid wider than 32 is refused by the tiled route, and by name."""
    g = torch.Generator().manual_seed(42)
    args = _dw_operands(g, 2, 128, 64, BF, cuda)
    assert not tdw.tiled_ok(128, 64, 64)
    with pytest.raises(ValueError, match="not a shape it takes"):
        tdw._forward_kernel(*args, None, 64, 0.0, route="tiled")
    with pytest.raises(ValueError, match="not a shape it takes"):
        tdw._backward_kernel(*args, None, args[0], 64, 0.0, route="tiled")


def _check_conv(args, dout, route):
    before = (tcl.conv_ln_gelu.launches_by_route[route],
              tcl.conv_ln_gelu.bwd_launches_by_route[route])
    got, again = tcl.conv_ln_gelu(*args), tcl.conv_ln_gelu(*args)
    want = tcl.conv_ln_gelu_plain(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[args[0].dtype]
    assert torch.equal(got, again)
    del got, again, want
    grads, grads2 = (tcl.conv_ln_gelu_backward(*args, dout) for _ in range(2))
    want = tcl.conv_ln_gelu_backward_plain(*args, dout)
    torch.cuda.synchronize()
    assert (tcl.conv_ln_gelu.launches_by_route[route],
            tcl.conv_ln_gelu.bwd_launches_by_route[route]) == (before[0] + 2, before[1] + 2)
    for name, a, b, a2 in zip(CONV_GRADS, grads, want, grads2):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[args[0].dtype], name
        assert torch.equal(a, a2), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("cin,cout", [(528, 2112), (2112, 528)])
def test_conv_ln_gelu_tiled_route_at_nar_kth_128(cuda, dtype, cin, cout):
    """80 samples of 256 positions at both stages of the conv FFN."""
    assert tcl.kernel_route(256, cin, cout, dtype) == "tiled"
    g = torch.Generator().manual_seed(43)
    args = _conv_operands(g, 80, 256, cin, cout, dtype, cuda)
    dout = torch.randn(80, 256, cout, generator=g).to(cuda, dtype)
    _check_conv(args, dout, "tiled")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("n,hw,cin,cout", [(5, 80, 80, 368), (3, 128, 48, 96),
                                           (4, 64, 48, 592), (2, 1024, 64, 128),
                                           (37, 96, 2112, 528)])
def test_conv_ln_gelu_tiled_route_edge_shapes(cuda, dtype, n, hw, cin, cout):
    """HW 80 (a partial 128-row tile of the products), Cin 80 (a partial K
    step), Cout 368 and 592 (partial 176-column groups; 592 does not split
    into cluster slabs, so HW 64 takes the tiled route too), HW 1024, 37
    samples."""
    assert tcl.kernel_route(hw, cin, cout, dtype) == "tiled"
    g = torch.Generator().manual_seed(44)
    args = _conv_operands(g, n, hw, cin, cout, dtype, cuda)
    dout = torch.randn(n, hw, cout, generator=g).to(cuda, dtype)
    _check_conv(args, dout, "tiled")


@pytest.mark.gpu
@pytest.mark.parametrize("hw,cin,cout", [(64, 528, 2112), (256, 528, 2112), (256, 2112, 528),
                                         (16, 48, 96), (36, 48, 48), (64, 48, 592),
                                         (4096, 16, 16), (4112, 16, 16), (80, 24, 48),
                                         (256, 528, 2120), (0, 16, 16)])
def test_conv_ln_gelu_route_is_the_librarys(cuda, hw, cin, cout):
    """kernel_route, a pure function of the shapes, names the route the
    library's vptr_conv_ln_gelu_route names (None where it names none), in
    both dtypes."""
    lib = tcl._lib()
    for dtype in (F32, BF):
        code = lib.vptr_conv_ln_gelu_route(hw, cin, cout, tcl._DTYPES[dtype])
        assert tcl.kernel_route(hw, cin, cout, dtype) == (None if code < 0 else tcl.ROUTES[code])
