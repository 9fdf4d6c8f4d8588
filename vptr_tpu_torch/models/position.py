"""Sinusoidal position embeddings (1D temporal, 2D window, 3D
spatio-temporal) as tensors.

Counterpart of ``vptr_tpu/models/position.py:17-88``: the tables are built
in float64 numpy (same math, DETR-style interleaved sin/cos) and handed to
torch once; models keep them as buffers. The 3D table feeds TSLMA.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _sine_embed(positions: np.ndarray, dim: int, temperature: float) -> np.ndarray:
    """Channel 2i = sin(p / temp^(2i/dim)), channel 2i+1 = cos(same)."""
    dim_t = np.arange(dim, dtype=np.float64)
    dim_t = temperature ** (2.0 * np.floor(dim_t / 2.0) / dim)
    ang = positions[..., None] / dim_t
    out = np.empty(ang.shape, dtype=np.float64)
    out[..., 0::2] = np.sin(ang[..., 0::2])
    out[..., 1::2] = np.cos(ang[..., 1::2])
    return out


def position_embedding_1d(length: int, dim: int, temperature: float = 10000.0,
                          normalize: bool = False,
                          dtype=torch.float32) -> torch.Tensor:
    """1D temporal embedding, shape (length, dim); positions count from 1."""
    pos = np.arange(1, length + 1, dtype=np.float64)
    if normalize:
        pos = pos / (length + 1e-6) * (2 * math.pi)
    return torch.from_numpy(_sine_embed(pos, dim, temperature)).to(dtype)


def position_embedding_2d(height: int, width: int, dim: int,
                          temperature: float = 10000.0, normalize: bool = False,
                          dtype=torch.float32) -> torch.Tensor:
    """2D embedding, shape (height, width, dim); the first dim//2 channels
    encode y, the rest x."""
    if dim % 2:
        raise ValueError(f"embedding size must be even, got {dim}")
    y = np.arange(1, height + 1, dtype=np.float64)
    x = np.arange(1, width + 1, dtype=np.float64)
    if normalize:
        y = y / (height + 1e-6) * (2 * math.pi)
        x = x / (width + 1e-6) * (2 * math.pi)
    ey = _sine_embed(y, dim // 2, temperature)
    ex = _sine_embed(x, dim // 2, temperature)
    ey = np.broadcast_to(ey[:, None, :], (height, width, dim // 2))
    ex = np.broadcast_to(ex[None, :, :], (height, width, dim // 2))
    return torch.from_numpy(np.concatenate([ey, ex], axis=-1)).to(dtype)


def position_embedding_3d(length: int, height: int, width: int, dim: int,
                          temperature: float = 10000.0, normalize: bool = False,
                          dtype=torch.float32) -> torch.Tensor:
    """3D (t, y, x) embedding, shape (length, height, width, dim): channels
    laid out (t-part, y-part, x-part), each dim // 3 wide; dim must divide
    by 3."""
    if dim % 3:
        raise ValueError(f"embedding size must be divisible by 3, got {dim}")
    d3 = dim // 3
    t = np.arange(1, length + 1, dtype=np.float64)
    y = np.arange(1, height + 1, dtype=np.float64)
    x = np.arange(1, width + 1, dtype=np.float64)
    if normalize:
        t = t / (length + 1e-6) * (2 * math.pi)
        y = y / (height + 1e-6) * (2 * math.pi)
        x = x / (width + 1e-6) * (2 * math.pi)
    shape = (length, height, width, d3)
    et = np.broadcast_to(_sine_embed(t, d3, temperature)[:, None, None, :], shape)
    ey = np.broadcast_to(_sine_embed(y, d3, temperature)[None, :, None, :], shape)
    ex = np.broadcast_to(_sine_embed(x, d3, temperature)[None, None, :, :], shape)
    return torch.from_numpy(np.concatenate([et, ey, ex], axis=-1)).to(dtype)
