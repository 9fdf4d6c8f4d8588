"""Attention core for short sequences: softmax(q k^T * D^-1/2 + bias) v.

Counterpart of ``vptr_tpu/ops/attention_core.py::attention_core`` (the TPU
kernel ``_core_forward``/``_kernel``, ``pl.pallas_call`` at :188). The
kernel is ``csrc/attention_core.cu`` (CUDA C++ for sm_90a); its source note
says what bounds it on the card and what its design does about that.

* :func:`attention_core` is the wrapper. A CUDA tensor launches the kernel
  (or raises); a CPU tensor takes :func:`attention_core_plain`, the same
  function in plain PyTorch with the same rounding points.
* ``attention_core.launches`` counts kernel launches, and nothing else.
* Attention-weight dropout (the counter-hash mask of the TPU kernel) comes
  with the training slice; ``seed`` and ``dropout_rate`` stay in the
  signature so that slice adds it without changing the API.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vptr_tpu_torch.ops import _build

MAX_TOKENS = 32
MAX_DEPTH = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _no_dropout(dropout_rate: float) -> None:
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention-weight dropout arrives with the FAR training slice; "
            "the serving path runs with dropout_rate=0")


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, seed: int = 0,
                         dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version (mirrors ``_reference_core``): q * scale is
    rounded to q's dtype, logits and softmax are f32, the weights are
    rounded to q's dtype before the f32-accumulated value product."""
    _no_dropout(dropout_rate)
    dt = q.dtype
    qs = q * (q.shape[-1] ** -0.5)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(dt)
    return torch.matmul(weights.float(), v.float()).to(dt)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, seed: int = 0,
                   dropout_rate: float = 0.0) -> torch.Tensor:
    """q: (B, H, Tq, D), k/v: (B, H, Tk, D), Tq/Tk <= 32, D <= 128;
    ``bias``: None or (1 | H, Tq, Tk) additive logits (a causal mask as
    -1e30). Returns (B, H, Tq, D) in q's dtype."""
    _no_dropout(dropout_rate)
    if q.device.type == "cpu":
        return attention_core_plain(q, k, v, bias)
    if not q.is_cuda:
        raise ValueError(f"attention_core: unsupported device {q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"attention_core: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if not (tq <= MAX_TOKENS and tk <= MAX_TOKENS and d <= MAX_DEPTH):
        raise ValueError(f"attention_core kernel takes Tq, Tk <= {MAX_TOKENS} "
                         f"and D <= {MAX_DEPTH}, got Tq={tq} Tk={tk} D={d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention_core kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"attention_core: {name} must be contiguous on "
                             f"{q.device} (16-byte aligned)")
    bias_heads = 0
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
        if bias.shape not in ((1, tq, tk), (h, tq, tk)):
            raise ValueError(f"attention_core: bias {tuple(bias.shape)} is "
                             f"not (1|{h}, {tq}, {tk})")
        bias_heads = bias.shape[0]
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.vptr_attention_core(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(bias),
        out.data_ptr(), b, h, tq, tk, d, bias_heads, d ** -0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "attention_core")
    attention_core.launches += 1
    return out


attention_core.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention_core")
    fn = lib.vptr_attention_core
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib
