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
    q = torch.zeros(1, 1, 33, 8, device=cuda)
    with pytest.raises(ValueError, match="Tq, Tk <= 32"):
        tac.attention_core(q, q, q)
    x = torch.zeros(1, 40, 16, device=cuda)
    w, c = torch.zeros(16, 16, device=cuda), torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="L <= 32"):
        tfw.fused_attention_ln(x, w, c, w, c, w, c, w, c, c, c, num_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        tac.attention_core(q[..., :4, :].transpose(2, 3),
                           q[..., :4, :].transpose(2, 3),
                           q[..., :4, :].transpose(2, 3))
