"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips when ``torch.cuda.is_available()`` is false
(decided inside the fixture, never at import). This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerances: f32 — kernel and plain differ in summation order only (528-long
dot products); bf16 — one bf16 ulp of outputs of magnitude <= 8, since
roundings at intermediates (xn, q/k/v, softmax weights) may flip.
"""

import pytest
import torch

from vptr_tpu_torch.ops import attention_core as tac
from vptr_tpu_torch.ops import fused_window_attention as tfw

TOL = {torch.float32: 1e-3, torch.bfloat16: 6.25e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _causal(n, device):
    return torch.full((n, n), -1e30, device=device).triu(1)[None]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,bias_heads", [(20, 20, 1), (19, 19, 8),
                                              (10, 20, 8), (32, 7, 0)])
def test_attention_core_kernel_matches_plain(cuda, dtype, tq, tk, bias_heads):
    g = torch.Generator().manual_seed(4)
    q = torch.randn(96, 8, tq, 66, generator=g).to(cuda, dtype)
    k = torch.randn(96, 8, tk, 66, generator=g).to(cuda, dtype)
    v = torch.randn(96, 8, tk, 66, generator=g).to(cuda, dtype)
    bias = (None if bias_heads == 0 else
            torch.randn(bias_heads, tq, tk, generator=g).to(cuda))
    before = tac.attention_core.launches
    got = tac.attention_core(q, k, v, bias)
    want = tac.attention_core_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert tac.attention_core.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def _heads(b, h, t, d, strided, g, device, dtype):
    """Random (b, h, t, d) attention operand: contiguous, or (strided) the
    (B, H, T, D) view of a contiguous (B, T, H*D) tensor, as the attention
    layer's projections give it."""
    if strided:
        return torch.randn(b, t, h * d, generator=g).to(device, dtype).view(
            b, t, h, d).transpose(1, 2)
    return torch.randn(b, h, t, d, generator=g).to(device, dtype)


def _core_bias(kind, h, tq, tk, g, device):
    if kind == "none":
        return None
    if kind == "causal":   # keys past the query masked; rectangular too
        return torch.full((tq, tk), -1e30, device=device).triu(1)[None]
    return torch.randn(1 if kind == "one" else h, tq, tk, generator=g).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", ["none", "one", "heads", "causal"])
@pytest.mark.parametrize("hd", [66, 33])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("tq,tk", [(2, 2), (10, 10), (16, 16), (19, 19), (20, 20),
                                   (32, 32), (10, 20), (32, 7), (10, 2)])
def test_attention_core_mma_route_matches_plain(cuda, tq, tk, strided, hd, bias_kind,
                                                rate):
    g = torch.Generator().manual_seed(40)
    q, k, v = (_heads(37, 8, t, hd, strided, g, cuda, torch.bfloat16)
               for t in (tq, tk, tk))
    bias = _core_bias(bias_kind, 8, tq, tk, g, cuda)
    seed = _seed(cuda)
    assert tac.kernel_route(q.dtype, 8, tq, tk, hd) == "mma"
    before = tac.attention_core.launches
    got = tac.attention_core(q, k, v, bias, seed, rate)
    want = tac.attention_core_plain(q, k, v, bias, seed, rate)
    torch.cuda.synchronize()
    assert tac.attention_core.launches == before + 1
    assert got.stride() == q.stride()                  # written in q's layout
    assert (got.float() - want.float()).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,tq,tk,hd", [(torch.float32, 8, 20, 20, 66),
                                             (torch.bfloat16, 4, 10, 3, 3)])
def test_attention_core_fma_route_takes_both_layouts(cuda, dtype, h, tq, tk, hd):
    g = torch.Generator().manual_seed(41)
    assert tac.kernel_route(dtype, h, tq, tk, hd) == "fma"
    for strided in (False, True):
        q, k, v = (_heads(24, h, t, hd, strided, g, cuda, dtype) for t in (tq, tk, tk))
        got = tac.attention_core(q, k, v, None, _seed(cuda), 0.1)
        want = tac.attention_core_plain(q, k, v, None, _seed(cuda), 0.1)
        torch.cuda.synchronize()
        assert got.stride() == q.stride()
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("tq,tk", [(20, 20), (19, 19), (10, 10), (10, 2)])
def test_attention_core_mma_route_is_deterministic(cuda, tq, tk):
    g = torch.Generator().manual_seed(42)
    q, k, v = (_heads(640, 8, t, 66, True, g, cuda, torch.bfloat16) for t in (tq, tk, tk))
    bias = _core_bias("causal", 8, tq, tk, g, cuda)
    a = tac.attention_core(q, k, v, bias, _seed(cuda), 0.1)
    b = tac.attention_core(q, k, v, bias, _seed(cuda), 0.1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_core_strided_gradients_equal_contiguous(cuda, rate):
    """Autograd through the strided forward (the layer's route) gives the
    gradients of the contiguous one: both backward routes compute the same
    arithmetic in either layout."""
    g = torch.Generator().manual_seed(43)
    views = [_heads(96, 8, 19, 66, True, g, cuda, torch.bfloat16) for _ in range(3)]
    bias0 = torch.randn(8, 19, 19, generator=g).to(cuda)
    gout = torch.randn(96, 8, 19, 66, generator=g).to(cuda, torch.bfloat16)
    grads, outs = [], []
    for ops in (views, [x.contiguous() for x in views]):
        ins = [x.detach().clone().requires_grad_() for x in ops]   # strides kept
        bias = bias0.clone().requires_grad_()
        out = tac.attention_core(*ins, bias, _seed(cuda), rate)
        grads.append(torch.autograd.grad(out, ins + [bias], gout))
        outs.append(out)
    torch.cuda.synchronize()
    assert tac.layout(views[0]) == 1 and tac.layout(outs[0]) == 1
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens,res", [(16, False), (16, True), (19, False),
                                        (32, True)])
def test_fused_attention_ln_kernel_matches_plain(cuda, dtype, tokens, res):
    g = torch.Generator().manual_seed(5)
    c, bw = 528, 48
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    w = [r(c, c, std=c ** -0.5).to(dtype) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    args = (r(bw, tokens, c).to(dtype), w[0], b[0], w[1], b[1], w[2], b[2],
            w[3], b[3], 1 + r(c, std=0.1), r(c, std=0.1), r(tokens, c),
            _causal(tokens, cuda))
    scale = torch.rand(bw, generator=g).to(cuda) * 2
    if res:
        got = tfw.fused_attention_ln_res(*args, scale, num_heads=8)
    else:
        got = tfw.fused_attention_ln(*args, num_heads=8)
    want = tfw.fused_attention_ln_plain(*args, num_heads=8,
                                        scale=scale if res else None, res=res)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
def test_kernels_refuse_unsupported_shapes(cuda):
    q = torch.zeros(1, 1, 161, 8, device=cuda)
    with pytest.raises(ValueError, match="Tq, Tk <= 160 with D <= 80"):
        tac.attention_core(q, q, q)
    q = q[:, :, :33]
    x = torch.zeros(1, 40, 16, device=cuda)
    w, c = torch.zeros(16, 16, device=cuda), torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="L <= 32"):
        tfw.fused_attention_ln(x, w, c, w, c, w, c, w, c, c, c, num_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        tac.attention_core(q[..., :4, :].transpose(2, 3),
                           q[..., :4, :].transpose(2, 3),
                           q[..., :4, :].transpose(2, 3))


# ---- dropout and the backward kernels (training slice)
#
# Backward tolerances, relative to the larger of 1 and the largest
# magnitude of each gradient: f32 1e-4 (summation order; the weight
# gradients sum 12,160 rows at the training shapes); bf16 2^-5 (the
# outputs are rounded to bf16, 2^-8, and a rounding of an intermediate --
# xn, q/k/v, the dropped weights -- that falls the other way moves the
# terms it feeds by one bf16 ulp; the weight gradients are cast to bf16 at
# the end).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())).item()


def _seed(cuda):
    return torch.tensor([12345], dtype=torch.int32, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("tq,tk,bias_heads", [(19, 19, 1), (10, 20, 8), (19, 19, 0)])
def test_attention_core_backward_kernel_matches_plain(cuda, dtype, rate, tq, tk,
                                                      bias_heads):
    g = torch.Generator().manual_seed(6)
    r = lambda *s: torch.randn(*s, generator=g).to(cuda, dtype)
    q, k, v, dout = r(640, 8, tq, 66), r(640, 8, tk, 66), r(640, 8, tk, 66), r(640, 8, tq, 66)
    bias = None
    if bias_heads == 1:
        bias = _causal(tq, cuda)
    elif bias_heads:
        bias = torch.randn(bias_heads, tq, tk, generator=g).to(cuda)
    seed = _seed(cuda)
    fwd = tac.attention_core(q, k, v, bias, seed, rate)
    fwd_plain = tac.attention_core_plain(q, k, v, bias, seed, rate)
    assert (fwd.float() - fwd_plain.float()).abs().max().item() <= TOL[dtype]
    before = tac.attention_core.bwd_launches
    got = tac.attention_core_backward(q, k, v, bias, seed, dout, rate)
    want = tac.attention_core_backward_plain(q, k, v, bias, seed, dout, rate)
    torch.cuda.synchronize()
    assert tac.attention_core.bwd_launches == before + 1
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        if b is None:
            assert a is None
            continue
        assert _rel_err(a, b) <= BWD_TOL[dtype], name


def _check_core_backward(q, k, v, bias, seed, dout, rate, tol):
    """The backward kernel against the plain version: one launch, dq, dk and
    dv with q's, k's and v's strides, every gradient (dbias where the bias
    is given) within ``tol`` of the plain version's largest magnitude."""
    before = tac.attention_core.bwd_launches
    got = tac.attention_core_backward(q, k, v, bias, seed, dout, rate)
    want = tac.attention_core_backward_plain(q, k, v, bias, seed, dout, rate)
    torch.cuda.synchronize()
    assert tac.attention_core.bwd_launches == before + 1
    for name, a, b, x in zip(("dq", "dk", "dv", "dbias"), got, want, (q, k, v, bias)):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.stride() == x.stride(), name
        assert _rel_err(a, b) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", ["none", "one", "heads", "causal"])
@pytest.mark.parametrize("hd", [66, 33])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("tq,tk", [(2, 2), (10, 10), (16, 16), (19, 19), (20, 20),
                                   (32, 32), (10, 20), (32, 7), (10, 2)])
def test_attention_core_backward_mma_route_matches_plain(cuda, tq, tk, strided, hd,
                                                         bias_kind, rate):
    g = torch.Generator().manual_seed(60)
    q, k, v, dout = (_heads(37, 8, t, hd, strided, g, cuda, torch.bfloat16)
                     for t in (tq, tk, tk, tq))
    bias = _core_bias(bias_kind, 8, tq, tk, g, cuda)
    assert tac.backward_route(q.dtype, 8, tq, tk, hd) == "mma"
    _check_core_backward(q, k, v, bias, _seed(cuda), dout, rate, BWD_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("layouts", [(1, 0, 1, 0), (0, 1, 0, 1), (0, 0, 0, 1), (1, 1, 1, 0)])
@pytest.mark.parametrize("tq,tk,hd", [(19, 19, 66), (10, 20, 33), (10, 2, 66)])
def test_attention_core_backward_mma_route_mixed_layouts(cuda, tq, tk, hd, layouts):
    """q, k, v and g each in its own layout (dq moves from g's into q's)."""
    g = torch.Generator().manual_seed(61)
    q, k, v, dout = (_heads(29, 8, t, hd, bool(lay), g, cuda, torch.bfloat16)
                     for t, lay in zip((tq, tk, tk, tq), layouts))
    assert tuple(tac.layout(x) for x in (q, k, v, dout)) == layouts
    bias = _core_bias("heads", 8, tq, tk, g, cuda)
    _check_core_backward(q, k, v, bias, _seed(cuda), dout, 0.1, BWD_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,tq,tk,hd", [(torch.float32, 8, 19, 19, 66),
                                             (torch.bfloat16, 4, 10, 3, 3),
                                             (torch.bfloat16, 8, 32, 32, 128)])
def test_attention_core_backward_fma_route_takes_both_layouts(cuda, dtype, h, tq, tk, hd):
    g = torch.Generator().manual_seed(62)
    assert tac.backward_route(dtype, h, tq, tk, hd) == "fma"
    for strided in (False, True):
        q, k, v, dout = (_heads(24, h, t, hd, strided, g, cuda, dtype)
                         for t in (tq, tk, tk, tq))
        bias = _core_bias("causal", h, tq, tk, g, cuda)
        _check_core_backward(q, k, v, bias, _seed(cuda), dout, 0.1, BWD_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("tq,tk,bias_kind", [(19, 19, "causal"), (19, 19, "heads"),
                                             (10, 10, "none"), (10, 20, "one")])
def test_attention_core_backward_mma_route_is_deterministic(cuda, tq, tk, bias_kind):
    g = torch.Generator().manual_seed(63)
    q, k, v, dout = (_heads(640, 8, t, 66, True, g, cuda, torch.bfloat16)
                     for t in (tq, tk, tk, tq))
    bias = _core_bias(bias_kind, 8, tq, tk, g, cuda)
    a = tac.attention_core_backward(q, k, v, bias, _seed(cuda), dout, 0.1)
    b = tac.attention_core_backward(q, k, v, bias, _seed(cuda), dout, 0.1)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.gpu
def test_attention_core_backward_route_is_the_librarys(cuda):
    lib = tac._lib()
    for dtype in (torch.float32, torch.bfloat16):
        for h, tq, tk, hd in ((8, 19, 19, 66), (8, 10, 10, 66), (8, 32, 32, 96),
                              (8, 32, 32, 128), (1, 7, 7, 33), (4, 10, 3, 3),
                              (16, 32, 32, 64), (8, 20, 20, 33), (3, 5, 9, 8),
                              (8, 160, 160, 66), (8, 160, 32, 66), (8, 33, 2, 80)):
            want = tac._ROUTES[tac.backward_route(dtype, h, tq, tk, hd)]
            got = lib.vptr_attention_core_bwd_route(h, tq, tk, hd, tac._DTYPES[dtype])
            assert got == want, (dtype, h, tq, tk, hd)


# ---- the long route (Tq or Tk past 32: TSLMA's space-time windows)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", ["none", "one", "heads", "causal"])
@pytest.mark.parametrize("hd", [66, 33])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tq,tk", [(160, 160), (160, 32), (33, 33), (40, 160), (150, 7)])
def test_attention_core_long_route_matches_plain(cuda, tq, tk, dtype, strided, hd,
                                                 bias_kind, rate):
    """Forward and backward on the long route against the plain versions:
    one launch of each, counted under "long"; the output in q's layout,
    dq, dk, dv in q's, k's and v's; dbias where the bias is given."""
    g = torch.Generator().manual_seed(64)
    q, k, v, dout = (_heads(12, 8, t, hd, strided, g, cuda, dtype) for t in (tq, tk, tk, tq))
    bias = _core_bias(bias_kind, 8, tq, tk, g, cuda)
    seed = _seed(cuda)
    assert tac.kernel_route(dtype, 8, tq, tk, hd) == "long"
    assert tac.backward_route(dtype, 8, tq, tk, hd) == "long"
    before = tac.attention_core.launches_by_route["long"]
    got = tac.attention_core(q, k, v, bias, seed, rate)
    want = tac.attention_core_plain(q, k, v, bias, seed, rate)
    torch.cuda.synchronize()
    assert tac.attention_core.launches_by_route["long"] == before + 1
    assert got.stride() == q.stride()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    before = tac.attention_core.bwd_launches_by_route["long"]
    _check_core_backward(q, k, v, bias, seed, dout, rate, BWD_TOL[dtype])
    assert tac.attention_core.bwd_launches_by_route["long"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,batch", [(torch.bfloat16, 64), (torch.float32, 16)])
@pytest.mark.parametrize("tk", [160, 32])
def test_attention_core_long_route_at_tslma_shapes(cuda, dtype, batch, tk):
    """nar_mnist's (64 windows, 8 heads, 160 x 160, 66) and nar_bair's 160 x
    32 as TSLMA's layer hands them over (the projections' layout), dropout
    0.1, forward and backward; two calls give the same bits."""
    g = torch.Generator().manual_seed(65)
    q, k, v, dout = (_heads(batch, 8, t, 66, True, g, cuda, dtype) for t in (160, tk, tk, 160))
    seed = _seed(cuda)
    got = tac.attention_core(q, k, v, None, seed, 0.1)
    want = tac.attention_core_plain(q, k, v, None, seed, 0.1)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(got, tac.attention_core(q, k, v, None, seed, 0.1))
    _check_core_backward(q, k, v, None, seed, dout, 0.1, BWD_TOL[dtype])
    a = tac.attention_core_backward(q, k, v, None, seed, dout, 0.1)
    b = tac.attention_core_backward(q, k, v, None, seed, dout, 0.1)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("layouts", [(1, 0, 1, 0), (0, 1, 0, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_core_long_route_mixed_layouts(cuda, dtype, layouts):
    g = torch.Generator().manual_seed(66)
    q, k, v, dout = (_heads(6, 8, t, 66, bool(lay), g, cuda, dtype)
                     for t, lay in zip((160, 48, 48, 160), layouts))
    bias = _core_bias("heads", 8, 160, 48, g, cuda)
    got = tac.attention_core(q, k, v, bias, _seed(cuda), 0.1)
    want = tac.attention_core_plain(q, k, v, bias, _seed(cuda), 0.1)
    torch.cuda.synchronize()
    assert got.stride() == q.stride()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    _check_core_backward(q, k, v, bias, _seed(cuda), dout, 0.1, BWD_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_layer_gradients_strided_equal_contiguous(cuda, rate, monkeypatch):
    """A training step's gradients through MultiHeadAttention (bf16, the
    fused core, causal bias, dropout): the core on heads()'s views, its
    backward on g as autograd delivers it, all in the projections' layout
    and dq, dk, dv returned in it (so heads()'s backward copies nothing);
    equal to the gradients with q, k and v copied to contiguous before the
    core (its output, and so dq, dk, dv, then contiguous; g still in the
    layer's layout)."""
    from vptr_tpu_torch.models import layers

    torch.manual_seed(64)
    m = layers.MultiHeadAttention(528, 8, fused=True, dtype=torch.bfloat16,
                                  dropout=0.1).to(cuda).train()
    x = torch.randn(64, 19, 528, generator=torch.Generator().manual_seed(65)).to(cuda)
    gout = torch.randn(64, 19, 528, generator=torch.Generator().manual_seed(66)).to(cuda)
    bias = _causal(19, cuda)
    real, seen = layers.attention_core, []

    def contiguous_core(q, k, v, *args):
        return real(q.contiguous(), k.contiguous(), v.contiguous(), *args)

    real_bwd = tac.attention_core_backward

    def spy(q, k, v, bias, seed, g, *args):
        got = real_bwd(q, k, v, bias, seed, g, *args)
        seen.append(tuple(tac.layout(z) for z in (q, k, v, g, *got[:3])))
        return got

    monkeypatch.setattr(tac, "attention_core_backward", spy)
    grads = []
    for core in (real, contiguous_core):
        monkeypatch.setattr(layers, "attention_core", core)
        m.zero_grad()
        xi = x.clone().requires_grad_()
        out = m(xi, xi, xi, bias=bias, generator=torch.Generator(cuda).manual_seed(7))
        out.float().backward(gout)
        grads.append([xi.grad] + [p.grad.clone() for p in m.parameters()])
    torch.cuda.synchronize()
    assert seen == [(1,) * 7, (0, 0, 0, 1, 0, 0, 0)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("tokens,res,bias_heads", [(16, False, 0), (16, True, 8),
                                                   (19, False, 1)])
def test_fused_attention_ln_backward_kernel_matches_plain(cuda, dtype, rate, tokens,
                                                          res, bias_heads):
    g = torch.Generator().manual_seed(7)
    c, bw = 528, 96
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    w = [r(c, c, std=c ** -0.5).to(dtype) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    bias = None
    if bias_heads == 1:
        bias = _causal(tokens, cuda)
    elif bias_heads:
        bias = r(bias_heads, tokens, tokens)
    scale = (torch.rand(bw, generator=g) * 2).to(cuda) if res else None
    args = (r(bw, tokens, c).to(dtype), w[0], b[0], w[1], b[1], w[2], b[2], w[3],
            b[3], 1 + r(c, std=0.1), r(c, std=0.1), r(tokens, c), bias)
    seed = _seed(cuda)
    fwd = (tfw.fused_attention_ln_res(*args, scale, seed, 8, rate) if res else
           tfw.fused_attention_ln(*args, seed, 8, rate))
    fwd_plain = tfw.fused_attention_ln_plain(*args, seed, 8, rate, scale, res)
    assert (fwd.float() - fwd_plain.float()).abs().max().item() <= TOL[dtype]
    dout = r(bw, tokens, c).to(dtype)
    before = tfw.fused_attention_ln.bwd_launches
    got = tfw.fused_attention_ln_backward(*args, seed, dout, 8, rate, scale, res)
    want = tfw.fused_attention_ln_backward_plain(*args, seed, dout, 8, rate, scale,
                                                 res)
    torch.cuda.synchronize()
    assert tfw.fused_attention_ln.bwd_launches == before + 1
    names = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo", "dls",
             "dlb", "dbias")
    for name, a, bb in zip(names, got, want):
        if bb is None:
            assert a is None
            continue
        assert a.dtype == bb.dtype and a.shape == bb.shape, name
        assert _rel_err(a, bb) <= BWD_TOL[dtype], name


@pytest.mark.gpu
def test_autograd_runs_the_backward_kernels(cuda):
    """Gradients through the wrappers on CUDA tensors launch the backward
    kernels once per call."""
    g = torch.Generator().manual_seed(8)
    q = torch.randn(64, 8, 19, 66, generator=g).to(cuda).requires_grad_()
    before = tac.attention_core.bwd_launches
    tac.attention_core(q, q.detach(), q.detach(), _causal(19, cuda)).sum().backward()
    assert tac.attention_core.bwd_launches == before + 1
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_ln_backward_generic_route(cuda, dtype):
    """A width that is not a multiple of 8 (C = 100, 4 heads of 25) takes
    the backward's generic product route in bf16 too."""
    g = torch.Generator().manual_seed(9)
    c, bw, tokens = 100, 40, 16
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    w = [r(c, c, std=c ** -0.5).to(dtype) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    args = (r(bw, tokens, c).to(dtype), w[0], b[0], w[1], b[1], w[2], b[2], w[3],
            b[3], 1 + r(c, std=0.1), r(c, std=0.1), r(tokens, c), _causal(tokens, cuda))
    seed, dout = _seed(cuda), r(bw, tokens, c).to(dtype)
    got = tfw.fused_attention_ln_backward(*args, seed, dout, 4, 0.1)
    want = tfw.fused_attention_ln_backward_plain(*args, seed, dout, 4, 0.1)
    torch.cuda.synchronize()
    for a, bb in zip(got, want):
        if bb is not None:
            assert _rel_err(a, bb) <= BWD_TOL[dtype]


# ---- the NAR slice: kernels #5 / #6 (two input streams, no LN) and #1 / #3
# with the 8-head relative-position bias and its gradient

def _rpe_bias(g, heads, tokens, cuda):
    """An (H, L, L) bias gathered from a (7 x 7, H) table, like the RPE."""
    table = torch.randn(49, heads, generator=g) * 0.5
    idx = torch.randint(0, 49, (tokens * tokens,), generator=g)
    return table[idx].reshape(tokens, tokens, heads).permute(2, 0, 1).contiguous().to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_heads", [0, 1, 8])
def test_fused_attention_kernels_match_plain(cuda, dtype, rate, bias_heads):
    g = torch.Generator().manual_seed(10)
    c, bw, tokens = 528, 97, 16          # a ragged last block of windows
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    w = [r(c, c, std=c ** -0.5).to(dtype) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    bias = (None if bias_heads == 0 else _rpe_bias(g, 8, tokens, cuda)
            if bias_heads == 8 else r(1, tokens, tokens))
    x_v = r(bw, tokens, c).to(dtype)
    x_qk = (x_v.float() + r(bw, tokens, c, std=0.5)).to(dtype)
    args = (x_qk, x_v, w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3], bias)
    seed = _seed(cuda)
    before = (tfw.fused_attention.launches, tfw.fused_attention.bwd_launches)
    fwd = tfw.fused_attention(*args, seed, 8, rate)
    want = tfw.fused_attention_plain(*args, seed, 8, rate)
    assert (fwd.float() - want.float()).abs().max().item() <= TOL[dtype]
    dout = r(bw, tokens, c).to(dtype)
    got = tfw.fused_attention_backward(*args, seed, dout, 8, rate)
    want = tfw.fused_attention_backward_plain(*args, seed, dout, 8, rate)
    torch.cuda.synchronize()
    assert (tfw.fused_attention.launches, tfw.fused_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    names = ("dx_qk", "dx_v", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo",
             "dbo", "dbias")
    for name, a, bb in zip(names, got, want):
        if bb is None:
            assert a is None
            continue
        assert a.dtype == bb.dtype and a.shape == bb.shape, name
        assert _rel_err(a, bb) <= BWD_TOL[dtype], name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_backward_generic_route(cuda, dtype):
    """C = 100 (4 heads of 25): the FMA forward and the generic product
    route of the backward, in bf16 too."""
    g = torch.Generator().manual_seed(11)
    c, bw, tokens = 100, 40, 16
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    w = [r(c, c, std=c ** -0.5).to(dtype) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    args = (r(bw, tokens, c).to(dtype), r(bw, tokens, c).to(dtype), w[0], b[0],
            w[1], b[1], w[2], b[2], w[3], b[3], r(4, tokens, tokens))
    seed, dout = _seed(cuda), r(bw, tokens, c).to(dtype)
    fwd = tfw.fused_attention(*args, seed, 4, 0.1)
    assert (fwd.float() - tfw.fused_attention_plain(*args, seed, 4, 0.1).float()
            ).abs().max().item() <= TOL[dtype]
    got = tfw.fused_attention_backward(*args, seed, dout, 4, 0.1)
    want = tfw.fused_attention_backward_plain(*args, seed, dout, 4, 0.1)
    torch.cuda.synchronize()
    for a, bb in zip(got, want):
        assert _rel_err(a, bb) <= BWD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_attention_ln_with_rpe_bias(cuda, dtype, rate):
    """Kernels #1 / #3 as the NAR encoder runs them: the 8-head RPE bias,
    no position table, the bias gradient."""
    g = torch.Generator().manual_seed(12)
    c, bw, tokens = 528, 96, 16
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    w = [r(c, c, std=c ** -0.5).to(dtype) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    args = (r(bw, tokens, c).to(dtype), w[0], b[0], w[1], b[1], w[2], b[2], w[3],
            b[3], 1 + r(c, std=0.1), r(c, std=0.1), None,
            _rpe_bias(g, 8, tokens, cuda))
    seed = _seed(cuda)
    fwd = tfw.fused_attention_ln(*args, seed, 8, rate)
    want = tfw.fused_attention_ln_plain(*args, seed, 8, rate)
    assert (fwd.float() - want.float()).abs().max().item() <= TOL[dtype]
    dout = r(bw, tokens, c).to(dtype)
    got = tfw.fused_attention_ln_backward(*args, seed, dout, 8, rate)
    want = tfw.fused_attention_ln_backward_plain(*args, seed, dout, 8, rate)
    torch.cuda.synchronize()
    assert got[-1] is not None and got[-1].shape == (8, tokens, tokens)
    for a, bb in zip(got, want):
        assert _rel_err(a, bb) <= BWD_TOL[dtype]


# ---- the fused feed-forward route: kernels #7 / #8 (fused_ffn) and #9 / #10
# (fused_dw_chain) at the far_mnist widths (C 528, hidden 2112, 8 x 8
# latents), dropout 0 and 0.1, with the tolerances above

def _ffn_operands(g, rows, dtype, cuda, c=528, h=2112):
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    return (r(rows, c).to(dtype), r(c, h, std=c ** -0.5).to(dtype), r(h, std=0.1),
            r(h, c, std=h ** -0.5).to(dtype), r(c, std=0.1), 1 + r(c, std=0.1),
            r(c, std=0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows,c,h", [(12800, 528, 2112), (12160, 528, 2112),
                                      (1236, 528, 2112), (64, 528, 2112), (1, 528, 2112),
                                      (100, 176, 192), (1236, 576, 2112), (100, 168, 200),
                                      (100, 172, 196)])
def test_fused_ffn_kernels_match_plain(cuda, dtype, rate, rows, c, h):
    """12,800 rows: the far_rip predict's; 12,160: the training step's; 1,236
    and 100: a ragged last row tile; 64 and 1: one row tile, the second of
    the backward's 128-row tiles past the rows; C 176, H 192: one hidden
    chunk, y columns for one warpgroup; C 576: the widest the forward's
    bf16 route takes (192 y columns a warpgroup); C 168, H 200: the
    backward's bf16 route with the last 16-deep slice of both products
    half past the data (the forward's FMA route); C 172, H 196: the
    backward's FMA route in bf16 (C not a multiple of 8). Each route is
    asserted per shape. Forward and backward give the same bits on two
    calls."""
    from vptr_tpu_torch.ops import fused_ffn as tff

    g = torch.Generator().manual_seed(13)
    args = _ffn_operands(g, rows, dtype, cuda, c, h)
    seed = _seed(cuda)
    bf = dtype == torch.bfloat16
    assert tff.kernel_route(c, h, dtype) == (
        "wgmma" if bf and c % 16 == 0 and h % 16 == 0 else "fma")
    assert tff.backward_route(c, h, dtype) == (
        "wgmma" if bf and c % 8 == 0 and h % 8 == 0 else "fma")
    before = (tff.fused_ffn.launches, tff.fused_ffn.bwd_launches)
    fwd = tff.fused_ffn(*args, seed, rate)
    fwd2 = tff.fused_ffn(*args, seed, rate)
    want = tff.fused_ffn_plain(*args, seed, rate)
    assert (fwd.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(fwd, fwd2)
    dout = torch.randn(rows, c, generator=g).to(cuda, dtype)
    got = tff.fused_ffn_backward(*args, seed, dout, rate)
    want = tff.fused_ffn_backward_plain(*args, seed, dout, rate)
    again = tff.fused_ffn_backward(*args, seed, dout, rate)
    torch.cuda.synchronize()
    assert (tff.fused_ffn.launches, tff.fused_ffn.bwd_launches) == (
        before[0] + 2, before[1] + 2)
    for name, a, b, a2 in zip(("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"),
                              got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[dtype], name
        assert torch.equal(a, a2), name          # no atomics: the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("rows,m,n", [(12160, 528, 2112), (1236, 528, 2112), (1, 528, 2112),
                                      (100, 168, 200)])
def test_ffn_weight_product_matches_matmul(cuda, transposed, rows, m, n):
    """Kernel #8's weight-gradient product alone: a^T (b_hi + b_lo) over K =
    rows on the shared wgmma product (both operands MN-major, in #8's K
    chunks, their f32 partials summed in order), written as (m, n) as dW1
    is or transposed, (n, m), as dW2 is; 12,160 rows: the training step's,
    1,236 and 1 a ragged K. Against an f32 matmul of the same bf16
    operands: they differ in summation order only."""
    from vptr_tpu_torch.ops import fused_ffn as tff

    g = torch.Generator().manual_seed(17)
    a = torch.randn(rows, m, generator=g).to(cuda, torch.bfloat16)
    b = torch.randn(rows, n, generator=g).to(cuda)
    hi = b.to(torch.bfloat16)
    lo = (b - hi.float()).to(torch.bfloat16)
    got = tff.weight_product(a, hi, lo, transposed)
    want = a.float().t() @ (hi.float() + lo.float())
    if transposed:
        want = want.t()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(528, 2112), (528, 64), (576, 192), (16, 16), (80, 176)])
def test_ffn_fc1_product_matches_matmul(cuda, k, n):
    """Kernel #7's fc1 product alone (wgmma m64n64k16, b MN-major as w1 is
    stored) against an f32 matmul of the same bf16 operands: they differ
    in summation order only."""
    from vptr_tpu_torch.ops import fused_ffn as tff

    g = torch.Generator().manual_seed(16)
    a = torch.randn(64, k, generator=g).to(cuda, torch.bfloat16)
    b = torch.randn(k, n, generator=g).to(cuda, torch.bfloat16)
    got = tff.fc1_product(a, b)
    want = a.float() @ b.float()
    torch.cuda.synchronize()
    assert got.shape == (64, n)
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


def _dw_operands(g, n, dtype, cuda, hw=64, c=2112):
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    return (r(n, hw, c).to(dtype), r(9, c, std=0.3), r(c, std=0.1),
            1 + r(hw, c, std=0.1), r(hw, c, std=0.1), 1 + r(hw, c, std=0.1),
            r(hw, c, std=0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n", [190, 13])
def test_fused_dw_chain_kernels_match_plain(cuda, dtype, rate, n):
    """190 samples: the training step's (#10 in bf16 on its persistent
    route, in f32 on 16 sample groups of up to 12); 13: one sample a
    cluster or a group."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    g = torch.Generator().manual_seed(14)
    args = _dw_operands(g, n, dtype, cuda)
    seed = _seed(cuda)
    before = (tdw.fused_dw_chain.launches, tdw.fused_dw_chain.bwd_launches)
    fwd = tdw.fused_dw_chain(*args, seed, 8, rate)
    want = tdw.fused_dw_chain_plain(*args, seed, 8, rate)
    assert (fwd.float() - want.float()).abs().max().item() <= TOL[dtype]
    dout = torch.randn(n, 64, 2112, generator=g).to(cuda, dtype)
    got = tdw.fused_dw_chain_backward(*args, seed, dout, 8, rate)
    want = tdw.fused_dw_chain_backward_plain(*args, seed, dout, 8, rate)
    again = tdw.fused_dw_chain_backward(*args, seed, dout, 8, rate)
    torch.cuda.synchronize()
    assert (tdw.fused_dw_chain.launches, tdw.fused_dw_chain.bwd_launches) == (
        before[0] + 1, before[1] + 2)
    for name, a, b, a2 in zip(("dx", "dtaps", "ddwb", "ds1", "db1", "ds2", "db2"),
                              got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[dtype], name
        assert torch.equal(a, a2), name


# #9's routes: bf16 on persistent 16-block clusters, f32 and the shapes that
# route refuses on a cluster of 8 blocks a sample

@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n", [1, 13, 200, 389])
def test_fused_dw_chain_persistent_route_matches_plain(cuda, rate, n):
    """The bf16 route at 1, 13, 200 (far_rip's) and 389 samples (more than
    two rounds of the resident clusters); two calls give the same bits."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    bf = torch.bfloat16
    clusters = tdw.persistent_clusters(64, 2112)
    assert tdw.kernel_route(64, 2112, bf) == "persistent" and clusters >= 1
    assert n != 389 or n > 2 * clusters
    g = torch.Generator().manual_seed(16)
    args = _dw_operands(g, n, bf, cuda)
    seed = _seed(cuda)
    before = tdw.fused_dw_chain.launches
    got = tdw.fused_dw_chain(*args, seed, 8, rate)
    again = tdw.fused_dw_chain(*args, seed, 8, rate)
    want = tdw.fused_dw_chain_plain(*args, seed, 8, rate)
    torch.cuda.synchronize()
    assert tdw.fused_dw_chain.launches == before + 2
    assert got.dtype == bf and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[bf]
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("hw,w,c", [(32, 16, 1088), (56, 8, 128), (8, 8, 64), (40, 5, 192),
                                    (16, 4, 4096), (16, 16, 2112), (72, 8, 128), (64, 2, 1024)])
def test_fused_dw_chain_persistent_route_on_other_grids(cuda, hw, w, c):
    """Grids of 2 x 16 (64 points past the first 512 pair-columns), 7 x 8,
    1 x 8, 8 x 5, 4 x 4 (a 256-channel slice), 1 x 16 at C = 2112 (544
    points: two for some threads), 9 x 8 and 32 x 2, C from 64 up, dropout
    0.1."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    bf = torch.bfloat16
    assert tdw.kernel_route(hw, c, bf, w) == "persistent"
    g = torch.Generator().manual_seed(17)
    args = _dw_operands(g, 7, bf, cuda, hw=hw, c=c)
    got = tdw.fused_dw_chain(*args, _seed(cuda), w, 0.1)
    want = tdw.fused_dw_chain_plain(*args, _seed(cuda), w, 0.1)
    assert (got.float() - want.float()).abs().max().item() <= TOL[bf]


@pytest.mark.gpu
@pytest.mark.parametrize("hw,w,c", [(64, 8, 2112), (256, 16, 2112), (64, 8, 64), (64, 8, 32),
                                    (64, 8, 2144), (64, 8, 2176), (16, 16, 2112),
                                    (16, 4, 4096), (16, 4, 8192), (72, 8, 64),
                                    (64, 12, 2112), (32, 16, 1088)])
def test_fused_dw_chain_route_is_the_librarys(cuda, hw, w, c):
    """kernel_route, a pure function of the shapes, names the route the
    library's vptr_fused_dw_chain_route names, in both dtypes."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    lib = tdw._lib()
    for dtype in (torch.float32, torch.bfloat16):
        want = tdw.ROUTES[lib.vptr_fused_dw_chain_route(hw, w, c, tdw._DTYPES[dtype])]
        assert tdw.kernel_route(hw, c, dtype, w) == want
    assert (tdw.persistent_clusters(hw, c, w) > 0) == (
        tdw.kernel_route(hw, c, torch.bfloat16, w) == "persistent")


@pytest.mark.gpu
@pytest.mark.parametrize("c,dtype", [(2112, torch.float32), (2144, torch.bfloat16),
                                     (96, torch.bfloat16)])
def test_fused_dw_chain_per_sample_route(cuda, c, dtype):
    """f32, and a C that is not a multiple of 64, take the per-sample
    kernel; forcing the persistent route on them raises."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    assert tdw.kernel_route(64, c, dtype) == "per_sample"
    g = torch.Generator().manual_seed(18)
    args = _dw_operands(g, 5, dtype, cuda, c=c)
    got = tdw.fused_dw_chain(*args, _seed(cuda), 8, 0.1)
    want = tdw.fused_dw_chain_plain(*args, _seed(cuda), 8, 0.1)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    with pytest.raises(ValueError, match="not a shape it takes"):
        tdw._forward_kernel(*args, None, 8, 0.0, route="persistent")


# #10's routes: bf16 on persistent 16-block clusters, f32 and the shapes that
# route refuses on clusters of 8 blocks over sample groups

_DW_GRADS = ("dx", "dtaps", "ddwb", "ds1", "db1", "ds2", "db2")


def _check_dw_backward(tdw, args, seed, dout, w, rate, route):
    before = tdw.fused_dw_chain.bwd_launches
    got = tdw.fused_dw_chain_backward(*args, seed, dout, w, rate)
    again = tdw.fused_dw_chain_backward(*args, seed, dout, w, rate)
    want = tdw.fused_dw_chain_backward_plain(*args, seed, dout, w, rate)
    torch.cuda.synchronize()
    assert tdw.fused_dw_chain.bwd_launches == before + 2
    assert tdw.backward_route(args[0].shape[1], args[0].shape[2], args[0].dtype, w) == route
    for name, a, b, a2 in zip(_DW_GRADS, got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[args[0].dtype], name
        assert torch.equal(a, a2), name


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n", [1, 13, 190, 389])
def test_fused_dw_chain_backward_persistent_route_matches_plain(cuda, rate, n):
    """The bf16 route at 1, 13, 190 (the FAR step's) and 389 samples (more
    than two rounds of the resident clusters): every gradient against the
    plain version; two calls give the same bits."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    bf = torch.bfloat16
    clusters = tdw.backward_clusters(64, 2112)
    assert tdw.backward_route(64, 2112, bf) == "persistent" and clusters >= 1
    assert n != 389 or n > 2 * clusters
    g = torch.Generator().manual_seed(19)
    args = _dw_operands(g, n, bf, cuda)
    dout = torch.randn(n, 64, 2112, generator=g).to(cuda, bf)
    _check_dw_backward(tdw, args, _seed(cuda), dout, 8, rate, "persistent")


@pytest.mark.gpu
@pytest.mark.parametrize("hw,w,c", [(32, 16, 1088), (56, 8, 128), (8, 8, 64), (32, 4, 1024),
                                    (16, 4, 4096), (16, 16, 2112), (72, 8, 128), (64, 2, 1024)])
def test_fused_dw_chain_backward_persistent_route_on_other_grids(cuda, hw, w, c):
    """Grids of 2 x 16, 7 x 8, 1 x 8, 8 x 4, 4 x 4 (a 256-channel slice),
    1 x 16 at C = 2112 (1,056 pair-columns: a third round of 32), 9 x 8 (the
    transpose's generic row loop) and 32 x 2, C from 64 up, dropout 0.1."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(20)
    args = _dw_operands(g, 7, bf, cuda, hw=hw, c=c)
    dout = torch.randn(7, hw, c, generator=g).to(cuda, bf)
    _check_dw_backward(tdw, args, _seed(cuda), dout, w, 0.1, "persistent")


@pytest.mark.gpu
@pytest.mark.parametrize("hw,w,c", [(64, 8, 2112), (256, 16, 2112), (64, 8, 64), (64, 8, 32),
                                    (64, 8, 2144), (64, 8, 2176), (16, 16, 2112),
                                    (16, 4, 4096), (16, 4, 8192), (72, 8, 64),
                                    (64, 12, 2112), (40, 5, 192), (64, 64, 64),
                                    (32, 16, 1088)])
def test_fused_dw_chain_backward_route_is_the_librarys(cuda, hw, w, c):
    """backward_route, a pure function of the shapes, names the route the
    library's vptr_fused_dw_chain_bwd_route names, in both dtypes."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    lib = tdw._lib_bwd()
    for dtype in (torch.float32, torch.bfloat16):
        want = tdw.BWD_ROUTES[lib.vptr_fused_dw_chain_bwd_route(hw, w, c, tdw._DTYPES[dtype])]
        assert tdw.backward_route(hw, c, dtype, w) == want
    assert (tdw.backward_clusters(hw, c, w) > 0) == (
        tdw.backward_route(hw, c, torch.bfloat16, w) == "persistent")


@pytest.mark.gpu
@pytest.mark.parametrize("hw,w,c,dtype", [(64, 8, 2112, torch.float32),
                                          (64, 8, 2144, torch.bfloat16),
                                          (40, 5, 192, torch.bfloat16)])
def test_fused_dw_chain_backward_groups_route(cuda, hw, w, c, dtype):
    """f32, a C that is not a multiple of 64 and a grid 5 wide take the
    group kernel; forcing the persistent route on them raises."""
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    g = torch.Generator().manual_seed(21)
    args = _dw_operands(g, 5, dtype, cuda, hw=hw, c=c)
    dout = torch.randn(5, hw, c, generator=g).to(cuda, dtype)
    _check_dw_backward(tdw, args, _seed(cuda), dout, w, 0.1, "groups")
    with pytest.raises(ValueError, match="not a shape it takes"):
        tdw._backward_kernel(*args, _seed(cuda), dout, w, 0.1, route="persistent")


# ---- the conv-FFN route: kernels #11 / #12 (conv_ln_gelu) at both stages of
# the far_mnist conv FFN (fc1 528 -> 2112, fc2 2112 -> 528, 8 x 8 latents),
# and #1 / #3 at the folded temporal sublayer's shape (T = 20 predict, 19
# step, the causal bias and the position table)

def _conv_operands(g, n, cin, cout, dtype, cuda, hw=64):
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    return (r(n, hw, cin).to(dtype), r(cin, cout, std=cin ** -0.5).to(dtype),
            r(cout, std=0.1), 1 + r(hw, cout, std=0.1), r(hw, cout, std=0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(528, 2112), (2112, 528)])
@pytest.mark.parametrize("n", [190, 13])
def test_conv_ln_gelu_kernels_match_plain(cuda, dtype, cin, cout, n):
    """190 samples: the training step's; 13: fewer sample groups than the
    backward's clusters hold."""
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl

    g = torch.Generator().manual_seed(15)
    args = _conv_operands(g, n, cin, cout, dtype, cuda)
    before = (tcl.conv_ln_gelu.launches, tcl.conv_ln_gelu.bwd_launches)
    fwd = tcl.conv_ln_gelu(*args)
    want = tcl.conv_ln_gelu_plain(*args)
    assert fwd.dtype == dtype and fwd.shape == want.shape
    assert (fwd.float() - want.float()).abs().max().item() <= TOL[dtype]
    dout = torch.randn(n, 64, cout, generator=g).to(cuda, dtype)
    got = tcl.conv_ln_gelu_backward(*args, dout)
    want = tcl.conv_ln_gelu_backward_plain(*args, dout)
    again = tcl.conv_ln_gelu_backward(*args, dout)
    torch.cuda.synchronize()
    assert (tcl.conv_ln_gelu.launches, tcl.conv_ln_gelu.bwd_launches) == (
        before[0] + 1, before[1] + 2)
    for name, a, b, a2 in zip(("dx", "dw", "db", "dscale", "dbias2"), got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[dtype], name
        assert torch.equal(a, a2), name          # no atomics: the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("cols,k", [(176, 528), (176, 2112), (352, 528), (528, 80),
                                    (96, 2112)])
def test_wgmma_product_matches_matmul(cuda, cols, k):
    """#11's bf16 product on its own: the wgmma ring (TMA boxes, swizzled
    descriptors, a partial last K step where K is not a multiple of 64, one
    to three warpgroups, columns past `cols` left out) against an f32
    matmul of the same bf16 operands. The two differ in summation order
    only."""
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl

    g = torch.Generator().manual_seed(18)
    a = torch.randn(64, k, generator=g).to(cuda, torch.bfloat16)
    bt = torch.randn(cols, k, generator=g).to(cuda, torch.bfloat16)
    got = tcl.wgmma_product(a, bt)
    want = torch.matmul(a.float(), bt.float().t())
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("k,m,n", [(64, 64, 176), (1024, 528, 2112), (896, 2112, 528),
                                   (80, 80, 368), (16, 192, 96), (200, 40, 24)])
def test_wgmma_product_mn_matches_matmul(cuda, k, m, n):
    """#12's weight-gradient product on its own: wgmma with both operands
    MN-major (the transpose flags, MN-major descriptors over TMA boxes of 64
    M or N values by 64 rows), a partial last K step where K is not a
    multiple of 64, M past one block's 192 rows and N past one 176-column
    group, their edges left out; against an f32 matmul of the same bf16
    operands. The two differ in summation order only."""
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl

    g = torch.Generator().manual_seed(22)
    a = torch.randn(k, m, generator=g).to(cuda, torch.bfloat16)
    b = torch.randn(k, n, generator=g).to(cuda, torch.bfloat16)
    got = tcl.wgmma_product_mn(a, b)
    want = torch.matmul(a.float().t(), b.float())
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("hw,cin,cout", [(16, 528, 2112), (32, 2112, 528), (48, 528, 2112),
                                         (64, 80, 96), (48, 80, 96), (64, 96, 368)])
def test_conv_ln_gelu_bf16_edge_shapes(cuda, hw, cin, cout):
    """#11 in bf16 where its tiles are partly empty: HW below wgmma's 64 rows
    (the rows past HW read zero and are left out of the statistics and the
    store), Cin = 80 (a partial last K step), Cout = 368 (one slab of 23
    column tiles: three warpgroups, the last partly past Cout)."""
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl

    g = torch.Generator().manual_seed(19)
    args = _conv_operands(g, 21, cin, cout, torch.bfloat16, cuda, hw=hw)
    got = tcl.conv_ln_gelu(*args)
    want = tcl.conv_ln_gelu_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(528, 2112), (2112, 528)])
def test_conv_ln_gelu_forward_is_deterministic(cuda, cin, cout):
    """Two forward calls on the same inputs give the same bits: the
    statistics are summed in a fixed order, no atomics."""
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl

    g = torch.Generator().manual_seed(20)
    args = _conv_operands(g, 190, cin, cout, torch.bfloat16, cuda)
    first = tcl.conv_ln_gelu(*args)
    second = tcl.conv_ln_gelu(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [16, 32, 48, 64])
@pytest.mark.parametrize("n", [1, 37])
def test_conv_ln_gelu_backward_edge_shapes(cuda, dtype, hw, n):
    """#12 where its tiles are partly empty: HW below wgmma's 64 rows, Cin =
    80 (a partial K step of the dx product and a partial 176-column group),
    Cout = 368 (one slab of three column groups, the last partly past Cout);
    one sample, and 37 (prime: not a multiple of the clusters the card
    holds, so the persistent clusters' last round is partly empty). The
    same bits on a second call."""
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl

    g = torch.Generator().manual_seed(21)
    args = _conv_operands(g, n, 80, 368, dtype, cuda, hw=hw)
    dout = torch.randn(n, hw, 368, generator=g).to(cuda, dtype)
    got = tcl.conv_ln_gelu_backward(*args, dout)
    want = tcl.conv_ln_gelu_backward_plain(*args, dout)
    again = tcl.conv_ln_gelu_backward(*args, dout)
    torch.cuda.synchronize()
    for name, a, b, a2 in zip(("dx", "dw", "db", "dscale", "dbias2"), got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_TOL[dtype], name
        assert torch.equal(a, a2), name


@pytest.mark.gpu
def test_conv_ln_gelu_autograd_and_refusals(cuda):
    """The autograd Function launches #11 forward and #12 backward; shapes
    the kernels do not take raise instead of falling back."""
    from vptr_tpu_torch.ops import conv_ln_gelu as tcl

    g = torch.Generator().manual_seed(16)
    args = [a.requires_grad_() for a in _conv_operands(g, 6, 48, 96, torch.float32, cuda)]
    before = (tcl.conv_ln_gelu.launches, tcl.conv_ln_gelu.bwd_launches)
    tcl.conv_ln_gelu(*args).square().sum().backward()
    torch.cuda.synchronize()
    assert (tcl.conv_ln_gelu.launches, tcl.conv_ln_gelu.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in args)
    bad = _conv_operands(g, 2, 24, 48, torch.float32, cuda)   # Cin not 16k
    with pytest.raises(ValueError, match="multiples of 16"):
        tcl.conv_ln_gelu(*bad)
    bad = _conv_operands(g, 2, 48, 48, torch.float32, cuda, hw=36)
    with pytest.raises(ValueError, match="HW a multiple of 16"):
        tcl.conv_ln_gelu(*bad)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("tokens", [20, 19, 10])
def test_fused_attention_ln_temporal_shape(cuda, dtype, rate, tokens):
    """#1 and #3 as the folded temporal sublayer calls them: columns of T
    tokens (20: far_rip predict, 19: the FAR step, 10: NAR), the causal
    bias (FAR) or none (NAR), the temporal position table on q/k."""
    g = torch.Generator().manual_seed(17)
    c, cols = 528, 160
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    w = [r(c, c, std=c ** -0.5).to(dtype) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    bias = None if tokens == 10 else _causal(tokens, cuda)
    args = (r(cols, tokens, c).to(dtype), w[0], b[0], w[1], b[1], w[2], b[2],
            w[3], b[3], 1 + r(c, std=0.1), r(c, std=0.1), r(tokens, c, std=0.5), bias)
    seed = _seed(cuda)
    got = tfw.fused_attention_ln(*args, seed, 8, rate)
    want = tfw.fused_attention_ln_plain(*args, seed, 8, rate)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    dout = torch.randn(cols, tokens, c, generator=g).to(cuda, dtype)
    got = tfw.fused_attention_ln_backward(*args, seed, dout, 8, rate)
    want = tfw.fused_attention_ln_backward_plain(*args, seed, dout, 8, rate)
    torch.cuda.synchronize()
    for name, a, bb in zip(("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo",
                            "dbo", "dls", "dlb"), got, want):
        assert _rel_err(a, bb) <= BWD_TOL[dtype], name


# ---- kernels #3 / #6 on the wgmma route: its products alone against f32
# matmuls of the same bf16 operands (they differ in summation order only),
# the backwards at edge shapes against their plain versions, two calls
# bit-equal

@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["mn", "k", "k2"])
@pytest.mark.parametrize("rows,k,n", [(12160, 528, 528), (592, 528, 528), (37, 64, 96),
                                      (1, 1584, 528), (247, 96, 64)])
def test_window_rows_product_matches_matmul(cuda, mode, rows, k, n):
    """The backward's row-tiled wgmma product alone: "mn" as the projections
    run it (B = W (K, N) read MN-major as stored), "k" as d(attn) (B^T (N,
    K) K-major as stored), "k2" as d(xn) (A as its hi and lo halves, two
    terms); 12,160 rows: the FAR step's; ragged row tiles and depths."""
    g = torch.Generator().manual_seed(21)
    a32 = torch.randn(rows, k, generator=g).to(cuda)
    a = a32.to(torch.bfloat16)
    a_lo = (a32 - a.float()).to(torch.bfloat16) if mode == "k2" else None
    b = torch.randn(*((k, n) if mode == "mn" else (n, k)), generator=g).to(cuda, torch.bfloat16)
    got = tfw.rows_product(a, b, a_lo, b_mn=mode == "mn")
    bmat = b.float() if mode == "mn" else b.float().t()
    want = (a.float() + (0 if a_lo is None else a_lo.float())) @ bmat
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("rows,c", [(12160, 528), (592, 96), (247, 64), (1, 528)])
def test_window_weight_products_match_matmul(cuda, rows, c):
    """The backward's four weight products in one launch: x_j^T (hi_j +
    lo_j) over K = rows in its chunks (the fourth one term, as dWo over g
    without a scale), against f32 matmuls. Both sum up to 12,160 products
    of unit normals (sums up to ~500) in f32 in different orders: 2e-5 of
    the largest value (one order's f32 rounding over the sum is ~1e-5)."""
    g = torch.Generator().manual_seed(22)
    xs = [torch.randn(rows, c, generator=g).to(cuda, torch.bfloat16) for _ in range(4)]
    ys = [torch.randn(rows, c, generator=g).to(cuda) for _ in range(4)]
    his = [y.to(torch.bfloat16) for y in ys]
    los = [(y - h.float()).to(torch.bfloat16) for y, h in zip(ys[:3], his[:3])] + [None]
    got = tfw.weight_products(xs, his, los)
    torch.cuda.synchronize()
    for j in range(4):
        want = xs[j].float().t() @ (his[j].float() + (0 if los[j] is None else los[j].float()))
        assert (got[j] - want).abs().max().item() <= 2e-5 * max(1.0, want.abs().max().item()), j


def _window_case(g, kind, bw, tokens, c, dtype, cuda):
    """Operands of #3 ("ln": a bias of 8 heads, or causal at 19 tokens;
    "res": with res and a DropPath scale) or #6 ("two": the 8-head bias)."""
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    w = [r(c, c, std=c ** -0.5).to(dtype) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    bias = _causal(tokens, cuda) if tokens == 19 else _rpe_bias(g, 8, tokens, cuda)
    if kind == "two":
        x_v = r(bw, tokens, c).to(dtype)
        return (x_v, r(bw, tokens, c).to(dtype), w[0], b[0], w[1], b[1], w[2], b[2], w[3],
                b[3], bias)
    return (r(bw, tokens, c).to(dtype), w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3],
            1 + r(c, std=0.1), r(c, std=0.1), r(tokens, c, std=0.5), bias)


def _window_backward(kind, args, seed, dout, rate, scale, plain=False):
    if kind == "two":
        fn = tfw.fused_attention_backward_plain if plain else tfw.fused_attention_backward
        return fn(*args, seed, dout, 8, rate)
    fn = tfw.fused_attention_ln_backward_plain if plain else tfw.fused_attention_ln_backward
    return fn(*args, seed, dout, 8, rate, scale, kind == "res")


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("c", [64, 96, 528])
@pytest.mark.parametrize("bw,tokens", [(37, 16), (13, 19), (20, 10)])
@pytest.mark.parametrize("kind", ["ln", "res", "two"])
def test_window_backward_wgmma_edge_shapes(cuda, kind, bw, tokens, c, rate):
    """#3 and #6 on the wgmma route (bf16) at rows that are not a multiple
    of the 128-row tiles (592, 247, 200), widths of one to three column
    groups, 8 heads, against their plain versions."""
    g = torch.Generator().manual_seed(23)
    dtype = torch.bfloat16
    assert tfw.backward_route(tokens, c, dtype, kind != "two") == "wgmma"
    args = _window_case(g, kind, bw, tokens, c, dtype, cuda)
    scale = (torch.rand(bw, generator=g) * 2).to(cuda) if kind == "res" else None
    seed, dout = _seed(cuda), torch.randn(bw, tokens, c, generator=g).to(cuda, dtype)
    got = _window_backward(kind, args, seed, dout, rate, scale)
    want = _window_backward(kind, args, seed, dout, rate, scale, plain=True)
    torch.cuda.synchronize()
    for i, (a, bb) in enumerate(zip(got, want)):
        if bb is None:
            assert a is None
            continue
        assert a.dtype == bb.dtype and a.shape == bb.shape, i
        assert _rel_err(a, bb) <= BWD_TOL[dtype], i


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["res", "two"])
def test_window_backward_is_deterministic(cuda, kind):
    """No float atomics: two calls of #3 / #6 give the same bits."""
    g = torch.Generator().manual_seed(24)
    args = _window_case(g, kind, 96, 16, 528, torch.bfloat16, cuda)
    scale = (torch.rand(96, generator=g) * 2).to(cuda) if kind == "res" else None
    seed, dout = _seed(cuda), torch.randn(96, 16, 528, generator=g).to(cuda, torch.bfloat16)
    first = _window_backward(kind, args, seed, dout, 0.1, scale)
    second = _window_backward(kind, args, seed, dout, 0.1, scale)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
def test_window_backward_routes(cuda):
    """bf16 with C a multiple of 8 takes wgmma; f32, or C = 100, the FMAs."""
    for ln in (True, False):
        assert tfw.backward_route(16, 528, torch.bfloat16, ln) == "wgmma"
        assert tfw.backward_route(19, 64, torch.bfloat16, ln) == "wgmma"
        assert tfw.backward_route(16, 100, torch.bfloat16, ln) == "fma"
        assert tfw.backward_route(16, 528, torch.float32, ln) == "fma"


# ---- kernels #1 / #5 on the wgmma route: its attention pass and its out
# projection alone, the forwards at edge shapes against their plain
# versions, two calls bit-equal, the routes

def _attention_bias(g, kind, heads, tokens, cuda):
    if kind == "none":
        return None
    if kind == "causal":
        return _causal(tokens, cuda)
    return (torch.randn(heads if kind == "heads" else 1, tokens, tokens, generator=g)
            * 0.5).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias", ["none", "one", "heads", "causal"])
@pytest.mark.parametrize("tokens", [2, 10, 16, 19, 20, 32])
@pytest.mark.parametrize("c,heads", [(528, 8), (264, 8)])
def test_window_attention_pass_matches_plain(cuda, c, heads, tokens, bias, rate):
    """The forward's attention pass alone (mma.sync per (window, head)) against
    a plain version built from _heads_attention: the weights rounded after
    dropout, P v in f32 rounded once; 37 windows (a ragged last block at L
    <= 8), heads of 66 and of 33 (odd: two-byte loads)."""
    g = torch.Generator().manual_seed(31)
    bw, bf = 37, torch.bfloat16
    q, k, v = (torch.randn(bw, tokens, c, generator=g).to(cuda, bf) for _ in range(3))
    hb = _attention_bias(g, bias, heads, tokens, cuda)
    seed = _seed(cuda)
    qs, _, _, w_drop, split = tfw._heads_attention(q, k, v, hb, seed, heads, rate)
    want = torch.matmul(w_drop.float(), split(v).float()).to(bf)
    want = want.transpose(1, 2).reshape(bw, tokens, c)
    qs = qs.transpose(1, 2).reshape(bw, tokens, c).contiguous()
    got = tfw.attention_pass(qs, k, v, hb, seed, heads, rate)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got.float()).all())
    assert (got.float() - want.float()).abs().max().item() <= TOL[bf]


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue", ["bo", "scale", "scale_res"])
@pytest.mark.parametrize("rows,tokens,c", [(12800, 16, 528), (592, 16, 64), (247, 19, 96),
                                           (140, 20, 528), (1, 1, 528)])
def test_window_out_projection_matches_matmul(cuda, rows, tokens, c, epilogue):
    """The forward's out projection alone (the row-tiled wgmma product with
    the kRwOutProj epilogue) against an f32 matmul + bo, * scale[row // L],
    + x, rounded once: the two differ in summation order only, so at most
    one bf16 rounding step (2^-7 of the larger of 1 and the value)."""
    g = torch.Generator().manual_seed(32)
    bf = torch.bfloat16
    a = torch.randn(rows, c, generator=g).to(cuda, bf)
    wo = (torch.randn(c, c, generator=g) * c ** -0.5).to(cuda, bf)
    bo = (torch.randn(c, generator=g) * 0.1).to(cuda)
    scale = ((torch.rand(-(-rows // tokens), generator=g) * 2).to(cuda)
             if epilogue != "bo" else None)
    res = torch.randn(rows, c, generator=g).to(cuda, bf) if epilogue == "scale_res" else None
    got = tfw.out_projection(a, wo, bo, tokens, scale, res)
    want = a.float() @ wo.float() + bo
    if scale is not None:
        want = want * scale.repeat_interleave(tokens)[:rows, None]
    if res is not None:
        want = want + res.float()
    want = want.to(bf).float()
    torch.cuda.synchronize()
    assert got.dtype == bf and got.shape == (rows, c)
    assert bool(((got.float() - want).abs() <= 2 ** -7 * want.abs().clamp(min=1.0)).all())


def _forward_case(g, kind, bw, tokens, c, heads, dtype, cuda):
    """Operands of #1 ("ln": the position table and a causal or heads-wide
    bias; "res": with res and a DropPath scale) or #5 ("two": a one-head
    bias)."""
    r = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std).to(cuda)
    w = [r(c, c, std=c ** -0.5).to(dtype) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    if kind == "two":
        x_v = r(bw, tokens, c).to(dtype)
        return (x_v, r(bw, tokens, c).to(dtype), w[0], b[0], w[1], b[1], w[2], b[2], w[3],
                b[3], _attention_bias(g, "one", heads, tokens, cuda))
    bias = _attention_bias(g, "causal" if tokens != 16 else "heads", heads, tokens, cuda)
    return (r(bw, tokens, c).to(dtype), w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3],
            1 + r(c, std=0.1), r(c, std=0.1), r(tokens, c, std=0.5), bias)


def _window_forward(kind, args, seed, heads, rate, scale, plain=False):
    if kind == "two":
        fn = tfw.fused_attention_plain if plain else tfw.fused_attention
        return fn(*args, seed, heads, rate)
    if plain:
        return tfw.fused_attention_ln_plain(*args, seed, heads, rate, scale, kind == "res")
    if kind == "res":
        return tfw.fused_attention_ln_res(*args, scale, seed, heads, rate)
    return tfw.fused_attention_ln(*args, seed, heads, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("c,heads", [(64, 1), (96, 4), (528, 8), (264, 8)])
@pytest.mark.parametrize("bw,tokens", [(37, 16), (13, 19), (7, 20)])
@pytest.mark.parametrize("kind", ["ln", "res", "two"])
def test_window_forward_wgmma_edge_shapes(cuda, kind, bw, tokens, c, heads, rate):
    """#1 and #5 on the wgmma route (bf16) at rows that are not a multiple
    of the 128-row tiles (592, 247, 140), widths of one to three column
    groups, 1, 4 and 8 heads (of 33 columns at C = 264), against their
    plain versions; one launch count a call."""
    g = torch.Generator().manual_seed(33)
    dtype = torch.bfloat16
    assert tfw.kernel_route(tokens, c, dtype) == "wgmma"
    args = _forward_case(g, kind, bw, tokens, c, heads, dtype, cuda)
    scale = (torch.rand(bw, generator=g) * 2).to(cuda) if kind == "res" else None
    seed = _seed(cuda)
    counter = tfw.fused_attention if kind == "two" else tfw.fused_attention_ln
    before = counter.launches
    got = _window_forward(kind, args, seed, heads, rate, scale)
    assert counter.launches == before + 1
    want = _window_forward(kind, args, seed, heads, rate, scale, plain=True)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["res", "two"])
def test_window_forward_is_deterministic(cuda, kind):
    """Two calls of #1 / #5 on the wgmma route give the same bits."""
    g = torch.Generator().manual_seed(34)
    args = _forward_case(g, kind, 96, 16, 528, 8, torch.bfloat16, cuda)
    scale = (torch.rand(96, generator=g) * 2).to(cuda) if kind == "res" else None
    first = _window_forward(kind, args, _seed(cuda), 8, 0.1, scale)
    second = _window_forward(kind, args, _seed(cuda), 8, 0.1, scale)
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_window_forward_routes(cuda):
    """bf16 with C a multiple of 8 takes wgmma at any token count; f32, or
    C = 100, the FMA kernel."""
    for tokens in (2, 10, 16, 19, 20, 32):
        assert tfw.kernel_route(tokens, 528, torch.bfloat16) == "wgmma"
        assert tfw.kernel_route(tokens, 528, torch.float32) == "fma"
    assert tfw.kernel_route(16, 64, torch.bfloat16) == "wgmma"
    assert tfw.kernel_route(16, 100, torch.bfloat16) == "fma"


# ---- float16: #1-#6 on their FMA routes (no f16 tensor-core route)

# f16 gates: the forward 2^-7 absolute (two f16 ulps of outputs of magnitude
# 4 to 8; bf16's is 2^-4), the backward 2^-8 relative to the larger of 1 and
# the largest gradient (bf16's 2^-5): f16 keeps 10 mantissa bits to bf16's 7
F16_TOL, F16_BWD_TOL = 2 ** -7, 2 ** -8


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("tq,tk", [(1, 1), (16, 16), (17, 17), (32, 32), (19, 19), (10, 2)])
def test_attention_core_f16_fma_route_matches_plain(cuda, tq, tk, strided, rate):
    """#2 and #4 in f16 at the FMA route's edge token counts (1, 16, 17,
    32), the FAR step's 19 and a rectangular 10 x 2, head width 66, q, k, v
    and g contiguous or in the layer's strided layout (the wrapper copies
    for the FMA kernels and writes back in each input's layout)."""
    g = torch.Generator().manual_seed(70)
    q, k, v, dout = (_heads(37, 8, t, 66, strided, g, cuda, torch.float16)
                     for t in (tq, tk, tk, tq))
    bias = _core_bias("causal" if tq == tk else "heads", 8, tq, tk, g, cuda)
    seed = _seed(cuda)
    assert tac.kernel_route(torch.float16, 8, tq, tk, 66) == "fma"
    assert tac.backward_route(torch.float16, 8, tq, tk, 66) == "fma"
    fwd, bwd = (dict(d) for d in (tac.attention_core.launches_by_route,
                                  tac.attention_core.bwd_launches_by_route))
    got = tac.attention_core(q, k, v, bias, seed, rate)
    want = tac.attention_core_plain(q, k, v, bias, seed, rate)
    torch.cuda.synchronize()
    assert tac.attention_core.launches_by_route["fma"] == fwd["fma"] + 1
    assert got.dtype == torch.float16 and got.stride() == q.stride()
    assert (got.float() - want.float()).abs().max().item() <= F16_TOL
    _check_core_backward(q, k, v, bias, seed, dout, rate, F16_BWD_TOL)
    assert tac.attention_core.bwd_launches_by_route["fma"] == bwd["fma"] + 1
    assert tac.attention_core.launches_by_route["mma"] == fwd["mma"]
    assert tac.attention_core.bwd_launches_by_route["mma"] == bwd["mma"]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("tokens", [1, 16, 17, 32])
@pytest.mark.parametrize("kind", ["ln", "res", "two"])
def test_window_kernels_f16_fma_route_match_plain(cuda, kind, tokens, rate):
    """#1/#3 ("ln", "res": the residual and the DropPath scale) and #5/#6
    ("two") in f16 at 8 heads of 66 (C 528) and the FMA route's edge token
    counts, forward and backward against their plain versions."""
    g = torch.Generator().manual_seed(71)
    bw, c = 37, 528
    args = _forward_case(g, kind, bw, tokens, c, 8, torch.float16, cuda)
    assert tfw.kernel_route(tokens, c, torch.float16) == "fma"
    assert tfw.backward_route(tokens, c, torch.float16, kind != "two") == "fma"
    scale = (torch.rand(bw, generator=g) * 2).to(cuda) if kind == "res" else None
    seed = _seed(cuda)
    counter = tfw.fused_attention if kind == "two" else tfw.fused_attention_ln
    before = (counter.launches, counter.bwd_launches)
    got = _window_forward(kind, args, seed, 8, rate, scale)
    want = _window_forward(kind, args, seed, 8, rate, scale, plain=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16
    assert (got.float() - want.float()).abs().max().item() <= F16_TOL
    dout = torch.randn(bw, tokens, c, generator=g).to(cuda, torch.float16)
    grads = _window_backward(kind, args, seed, dout, rate, scale)
    plain = _window_backward(kind, args, seed, dout, rate, scale, plain=True)
    torch.cuda.synchronize()
    assert (counter.launches, counter.bwd_launches) == (before[0] + 1, before[1] + 1)
    for i, (a, b) in enumerate(zip(grads, plain)):
        if b is None:
            continue
        assert a.dtype == b.dtype and _rel_err(a, b) <= F16_BWD_TOL, i


@pytest.mark.gpu
def test_f16_refused_before_any_launch(cuda):
    """#2/#4's long route and #7-#12 have no f16 kernel: a CUDA f16 tensor
    raises ValueError naming float16 before any launch; the library's
    backward route for f16 is the FMA route short and none long."""
    from vptr_tpu_torch.ops import fused_ffn as tff

    q = torch.zeros(2, 8, 40, 66, dtype=torch.float16, device=cuda)
    before = (tac.attention_core.launches, tac.attention_core.bwd_launches)
    with pytest.raises(ValueError, match="float16"):
        tac.attention_core(q, q, q)
    with pytest.raises(ValueError, match="float16"):
        tac.attention_core_backward(q, q, q, None, 0, q)
    assert (tac.attention_core.launches, tac.attention_core.bwd_launches) == before
    x = torch.zeros(64, 528, dtype=torch.float16, device=cuda)
    w1 = torch.zeros(528, 2112, dtype=torch.float16, device=cuda)
    w2 = torch.zeros(2112, 528, dtype=torch.float16, device=cuda)
    vec = lambda n: torch.zeros(n, device=cuda)
    n_ffn = tff.fused_ffn.launches
    with pytest.raises(ValueError, match="float16"):
        tff.fused_ffn(x, w1, vec(2112), w2, vec(528), vec(528), vec(528))
    assert tff.fused_ffn.launches == n_ffn
    lib = tac._lib()
    assert lib.vptr_attention_core_bwd_route(8, 19, 19, 66, tac._DTYPES[torch.float16]) == 0
    assert lib.vptr_attention_core_bwd_route(8, 40, 40, 66, tac._DTYPES[torch.float16]) == -1
