"""Per-clip transforms on numpy arrays (T, H, W, C), float32 in [0, 1].

The port's copy of ``vptr_tpu/data/transforms.py`` (numpy in, numpy out,
the same values); :class:`ReNormalize` also takes a torch tensor, on any
device, since the eval harness renormalises on the card.

Replaces the reference's list-of-PIL torchvision pipeline
(reference: utils/dataset.py:360-480). Flips make ONE decision per clip,
matching VidRandomHorizontal/VerticalFlip (utils/dataset.py:393-413).
Normalization stats are per-dataset constants carried in DataConfig.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def center_crop(clip: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    th, tw = size
    h, w = clip.shape[1:3]
    top = (h - th) // 2
    left = (w - tw) // 2
    return clip[:, top:top + th, left:left + tw, :]


def resize(clip: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize via PIL (matches torchvision Resize defaults)."""
    from PIL import Image

    th, tw = size
    t, h, w, c = clip.shape
    if (h, w) == (th, tw):
        return clip
    out = np.empty((t, th, tw, c), dtype=clip.dtype)
    for i in range(t):
        for ch in range(c):
            img = Image.fromarray((clip[i, :, :, ch] * 255).astype(np.uint8))
            out[i, :, :, ch] = np.asarray(
                img.resize((tw, th), Image.BILINEAR), dtype=np.float32) / 255.0
    return out


def crop(clip: np.ndarray, top: int, left: int,
         height: int, width: int) -> np.ndarray:
    """Fixed-position crop (reference: VidCrop, utils/dataset.py:382-391)."""
    return clip[:, top:top + height, left:left + width, :]


def pad(clip: np.ndarray, padding: int, fill: float = 0.0) -> np.ndarray:
    """Symmetric spatial pad (reference: VidPad, utils/dataset.py:468-480;
    upstream notes a mask must accompany padded inputs — the shipped configs
    never pad, so none is wired here either)."""
    cfg = ((0, 0), (padding, padding), (padding, padding), (0, 0))
    return np.pad(clip, cfg, constant_values=fill)


def random_flip(clip: np.ndarray, rng: np.random.Generator,
                p_horizontal: float = 0.5,
                p_vertical: float = 0.5) -> np.ndarray:
    if p_horizontal > 0 and rng.random() < p_horizontal:
        clip = clip[:, :, ::-1, :]
    if p_vertical > 0 and rng.random() < p_vertical:
        clip = clip[:, ::-1, :, :]
    return np.ascontiguousarray(clip)


class Normalize:
    """(x - mean) / std per channel (reference: VidNormalize,
    utils/dataset.py:426-438)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        return (clip - self.mean) / self.std


class ReNormalize:
    """Inverse of :class:`Normalize` (reference: VidReNormalize,
    utils/dataset.py:440-466). Works on numpy arrays and on torch tensors
    (f32 statistics on the tensor's device)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, clip):
        if isinstance(clip, torch.Tensor):
            std = torch.from_numpy(self.std).to(clip.device)
            return clip * std + torch.from_numpy(self.mean).to(clip.device)
        return clip * self.std + self.mean


class ClipTransform:
    """Composed train/eval transform pipeline for one clip.

    Order matches the reference compositions (utils/dataset.py:25-26,38,53):
    crop -> resize -> flips (train only) -> normalize.
    """

    def __init__(self, crop: Optional[Tuple[int, int]] = None,
                 size: Optional[Tuple[int, int]] = None,
                 mean: Sequence[float] = (0.0,),
                 std: Sequence[float] = (1.0,),
                 flips: bool = False):
        self.crop = crop
        self.size = size
        self.normalize = Normalize(mean, std)
        self.flips = flips

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        if self.crop is not None:
            clip = center_crop(clip, self.crop)
        if self.size is not None:
            clip = resize(clip, self.size)
        if self.flips and rng is not None:
            clip = random_flip(clip, rng)
        return self.normalize(clip).astype(np.float32)
