"""LayerNorm-folded fused attention sublayer over short token sequences.

Counterpart of ``vptr_tpu/ops/fused_window_attention.py::fused_attention_ln``
and ``fused_attention_ln_res`` (one TPU kernel, ``_fused_ln_forward`` /
``_kernel_ln``, ``pl.pallas_call`` at :586):

    out = out_proj(attn(q/k = LN(x) + pos, v = LN(x)))       # _ln
    out = x + scale * out_proj(attn(...))                    # _ln_res

The kernel is ``csrc/fused_window_attention_ln.cu`` (CUDA C++ for sm_90a):
LayerNorm, the q/k/v projections, per-head softmax attention and the output
projection all run inside it. Its source note says what bounds it on the
card and what its design does about that.

* The wrappers launch the kernel for CUDA tensors (or raise) and take
  :func:`fused_attention_ln_plain` for CPU tensors.
* ``fused_attention_ln.launches`` counts launches of the kernel, by either
  wrapper, and nothing else.
* Weights are (C_in, C_out) like the JAX Dense kernels, in the compute
  dtype; biases, the LN affine, ``pos`` and ``scale`` are f32.
* Dropout arrives with the training slice (``seed``/``dropout_rate`` kept).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vptr_tpu_torch.ops import _build
from vptr_tpu_torch.ops.attention_core import _no_dropout, attention_core_plain

MAX_TOKENS = 32
MAX_HEAD_DIM = 128
LN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_ln_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb,
                             pos=None, bias=None, seed=0, num_heads: int = 8,
                             dropout_rate: float = 0.0, scale=None,
                             res: bool = False) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: xn rounded
    to x's dtype, q/k/v rounded after their f32 bias add, the attention as
    :func:`attention_core_plain`, the output projection in f32 plus bo
    (then ``* scale`` per window and ``+ x`` when ``res``), rounded once."""
    _no_dropout(dropout_rate)
    dt = x.dtype
    b, l, c = x.shape
    hd = c // num_heads
    x32 = x.float()
    xn = F.layer_norm(x32, (c,), ls.float(), lb.float(), LN_EPS).to(dt)
    xqk = xn + pos.to(dt) if pos is not None else xn

    def proj(a, w, bb):
        return (torch.matmul(a.float(), w.float()) + bb.float()).to(dt)

    def split(z):  # (B, L, C) -> (B, H, L, hd)
        return z.reshape(b, l, num_heads, hd).transpose(1, 2)

    o = attention_core_plain(split(proj(xqk, wq, bq)), split(proj(xqk, wk, bk)),
                             split(proj(xn, wv, bv)), bias)
    out = torch.matmul(o.transpose(1, 2).reshape(b, l, c).float(), wo.float())
    out = out + bo.float()
    if scale is not None:
        out = out * scale.float()[:, None, None]
    if res:
        out = out + x32
    return out.to(dt)


def fused_attention_ln(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos=None,
                       bias=None, seed=0, num_heads: int = 8,
                       dropout_rate: float = 0.0) -> torch.Tensor:
    """LN-folded attention sublayer over x (B, L, C), L <= 32. ``pos``:
    optional (L, C) table added to q/k only; ``bias``: optional
    (1 | heads, L, L) additive logits."""
    return _forward(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, seed,
                    num_heads, dropout_rate, None, False)


def fused_attention_ln_res(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb,
                           pos=None, bias=None, scale=None, seed=0,
                           num_heads: int = 8,
                           dropout_rate: float = 0.0) -> torch.Tensor:
    """``x + scale * fused_attention_ln(x, ...)`` in one kernel; ``scale``:
    optional (B,) f32 per-window branch factor (the DropPath mask)."""
    return _forward(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, seed,
                    num_heads, dropout_rate, scale, True)


SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90


def kernel_route(tokens: int, channels: int, dtype: torch.dtype) -> str:
    """Which of the kernel's two routes a shape takes: ``"tensor cores"``
    (bf16 WMMA projections) or ``"fma"`` (f32 FMAs on the CUDA cores)."""
    return ("tensor cores" if _lib().vptr_fused_window_attention_ln_route(
        tokens, channels, _DTYPES[dtype]) else "fma")


def _forward(x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias, seed,
             num_heads, dropout_rate, scale, res):
    _no_dropout(dropout_rate)
    if x.device.type == "cpu":
        return fused_attention_ln_plain(
            x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos, bias,
            num_heads=num_heads, scale=scale, res=res)
    if not x.is_cuda:
        raise ValueError(f"fused_attention_ln: unsupported device {x.device}")
    bw, l, c = x.shape
    if c % num_heads or c // num_heads > MAX_HEAD_DIM or l > MAX_TOKENS:
        raise ValueError(f"fused_attention_ln kernel takes L <= {MAX_TOKENS} "
                         f"and a head width <= {MAX_HEAD_DIM} dividing C; got "
                         f"L={l} C={c} heads={num_heads}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_attention_ln kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    lib = _lib()
    smem = lib.vptr_fused_window_attention_ln_smem(l, c, num_heads,
                                                   _DTYPES[x.dtype])
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_attention_ln kernel: L={l}, C={c}, "
                         f"{x.dtype} needs {smem} B of shared memory "
                         f"(> {SMEM_LIMIT})")

    def operand(t, shape, dtype, name, align=1):
        if t is None:
            return None
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused_attention_ln: {name} is "
                             f"{tuple(t.shape)} {t.dtype}, wants {shape} {dtype}")
        if (not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % align):
            raise ValueError(f"fused_attention_ln: {name} must be contiguous "
                             f"on {x.device} ({align}-byte aligned)")
        return t

    f32 = torch.float32
    operand(x, (bw, l, c), x.dtype, "x")
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        operand(w, (c, c), x.dtype, name, align=32)   # whole wmma tiles
    for name, v in (("bq", bq), ("bk", bk), ("bv", bv), ("bo", bo),
                    ("ls", ls), ("lb", lb)):
        operand(v, (c,), f32, name)
    operand(pos, (l, c), f32, "pos")
    operand(scale, (bw,), f32, "scale")
    bias_heads = 0
    if bias is not None:
        bias = bias.to(device=x.device, dtype=f32).contiguous()
        if tuple(bias.shape) not in ((1, l, l), (num_heads, l, l)):
            raise ValueError(f"fused_attention_ln: bias {tuple(bias.shape)} "
                             f"is not (1|{num_heads}, {l}, {l})")
        bias_heads = bias.shape[0]

    out = torch.empty_like(x)
    p = _build.ptr
    err = lib.vptr_fused_window_attention_ln(
        p(x), p(wq), p(bq), p(wk), p(bk), p(wv), p(bv), p(wo), p(bo), p(ls),
        p(lb), p(pos), p(bias), p(scale), p(out), bw, l, c, num_heads,
        bias_heads, int(res), (c // num_heads) ** -0.5, LN_EPS,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "fused_attention_ln")
    fused_attention_ln.launches += 1
    return out


fused_attention_ln.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_window_attention_ln")
    fn = lib.vptr_fused_window_attention_ln
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 15 + [i] * 6 + [f, f, i, p]
        fn.restype = ctypes.c_int
        for name, n in (("smem", 4), ("route", 3)):
            g = getattr(lib, f"vptr_fused_window_attention_ln_{name}")
            g.argtypes = [i] * n
            g.restype = ctypes.c_long
    return lib
