"""Window partitioning for local spatial attention, on (..., H, W, C) tensors.

Counterpart of ``vptr_tpu/ops/window.py:18-90``: static reshape/permutes
with the same token and window order (row-major (ph, pw) inside a window,
row-major (qh, qw) over windows, batch leading), and the temporal (TSLMA)
partition that gathers one spatial window's tokens over every frame.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_to_window(x: torch.Tensor, window: int
                  ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Center-pad (..., H, W, C) so H and W divide by ``window``.

    Returns the padded tensor and the (top, left) offsets used to undo it.
    """
    h, w = x.shape[-3], x.shape[-2]
    pad_h = (-h) % window
    pad_w = (-w) % window
    if pad_h == 0 and pad_w == 0:
        return x, (0, 0)
    # F.pad lists pads from the last dim backwards: (C, W, H)
    x = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                  pad_h // 2, pad_h - pad_h // 2))
    return x, (pad_h // 2, pad_w // 2)


def unpad_from_window(x: torch.Tensor, orig_hw: Tuple[int, int],
                      offsets: Tuple[int, int]) -> torch.Tensor:
    """Undo :func:`pad_to_window` on (..., H_pad, W_pad, C)."""
    h, w = orig_hw
    top, left = offsets
    if x.shape[-3] == h and x.shape[-2] == w:
        return x
    return x[..., top:top + h, left:left + w, :]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nWh * nWw, window*window, C)."""
    b, h, w, c = x.shape
    nh, nw = h // window, w // window
    x = x.reshape(b, nh, window, nw, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (b, nh, nw, ph, pw, c)
    return x.reshape(b * nh * nw, window * window, c)


def window_reverse(x: torch.Tensor, window: int,
                   hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`window_partition`: (B*nW, win*win, C) -> (B, H, W, C)."""
    h, w = hw
    nh, nw = h // window, w // window
    b = x.shape[0] // (nh * nw)
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (b, nh, ph, nw, pw, c)
    return x.reshape(b, h, w, c)


def temporal_window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B * nWh * nWw, T * window * window, C): each
    spatial window's tokens over all T frames as one sequence, ordered
    (t, ph, pw), batch-major. H and W must divide by ``window``."""
    b, t, h, w, c = x.shape
    if h % window or w % window:
        raise ValueError(f"({h}, {w}) is not a multiple of the window {window}")
    nh, nw = h // window, w // window
    x = x.reshape(b, t, nh, window, nw, window, c)
    x = x.permute(0, 2, 4, 1, 3, 5, 6)  # (b, nh, nw, t, ph, pw, c)
    return x.reshape(b * nh * nw, t * window * window, c)


def temporal_window_reverse(x: torch.Tensor, window: int, t: int,
                            hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`temporal_window_partition`: (B*nW, T*win*win, C) ->
    (B, T, H, W, C)."""
    h, w = hw
    nh, nw = h // window, w // window
    b = x.shape[0] // (nh * nw)
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, t, window, window, c)
    x = x.permute(0, 3, 1, 4, 2, 5, 6)  # (b, t, nh, ph, nw, pw, c)
    return x.reshape(b, t, h, w, c)
