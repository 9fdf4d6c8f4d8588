"""Datasets: MovingMNIST npz, KTH/BAIR frame folders, synthetic generator.

The port's copy of ``vptr_tpu/data/datasets.py``: the same clips, bit for
bit, for the same split, index and rng (PIL is imported only where frames
are decoded or glyphs drawn).

Index-addressable numpy datasets (``__len__`` / ``get(i, rng)``) feeding the
prefetching loader. Splits and clip-chopping match the reference
(reference: utils/dataset.py:81-357).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vptr_tpu_torch.data.transforms import ClipTransform

KTH_ACTIONS = ("boxing", "handclapping", "handwaving", "jogging_no_empty",
               "running_no_empty", "walking_no_empty")  # utils/dataset.py:88


class ClipDataset:
    """Generic clip dataset over lists of frame image paths
    (reference: utils/dataset.py:220-269)."""

    def __init__(self, clips: List[List[Path]], num_past: int, num_future: int,
                 transform: ClipTransform, color_mode: str = "grey_scale"):
        self.clips = clips
        self.num_past = num_past
        self.num_future = num_future
        self.transform = transform
        self.color_mode = color_mode

    def __len__(self) -> int:
        return len(self.clips)

    def get(self, index: int,
            rng: Optional[np.random.Generator] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        frames = []
        for p in self.clips[index]:
            img = Image.open(p)
            img = img.convert("RGB" if self.color_mode == "RGB" else "L")
            arr = np.asarray(img, np.float32) / 255.0
            if arr.ndim == 2:
                arr = arr[..., None]
            frames.append(arr)
        clip = self.transform(np.stack(frames), rng)
        return clip[:self.num_past], clip[-self.num_future:]

    def visualize_clip(self, clip: np.ndarray, file_name: str,
                       fps: int = 10) -> str:
        """Save a (T, H, W, C) clip as a video file (reference:
        utils/dataset.py:270-288). Returns the path written (MJPEG .avi when
        no ffmpeg exists — see data.preprocessing.visualize_clip)."""
        from vptr_tpu_torch.data.preprocessing import visualize_clip

        return visualize_clip(clip, file_name, fps=fps)


def chop_clips(folder: Path, clip_length: int) -> List[List[Path]]:
    """Chop a frame folder into non-overlapping clips, centering the kept
    range (reference: utils/dataset.py:138-148)."""
    img_files = sorted(folder.glob("*"))
    n = len(img_files) // clip_length
    rem = len(img_files) % clip_length
    img_files = img_files[rem // 2: rem // 2 + n * clip_length]
    return [img_files[i * clip_length:(i + 1) * clip_length]
            for i in range(n)]


def kth_dataset(root: str, transform: ClipTransform, split: str = "train",
                num_past: int = 10, num_future: int = 10,
                val_person_ids: Optional[Sequence[int]] = None,
                actions: Sequence[str] = KTH_ACTIONS,
                rng: Optional[np.random.Generator] = None):
    """KTH: persons 1-16 train (one held out for val), 17-25 test
    (reference: utils/dataset.py:107-116). Returns ClipDataset, or
    (train, val) pair for split='train'."""
    root = Path(root)
    if split == "test":
        person_ids = list(range(17, 26))
    else:
        person_ids = list(range(1, 17))
        if val_person_ids is None:
            rng = rng or np.random.default_rng()
            val_person_ids = [int(rng.integers(1, 17))]
        person_ids = [p for p in person_ids if p not in val_person_ids]

    def folders_for(ids):
        out = []
        for a in actions:
            apath = root / a
            if not apath.exists():
                continue
            for s in sorted(os.listdir(apath)):
                if ".avi" in s:
                    continue
                try:
                    pid = int(s.strip().split("_")[0][-2:])
                except ValueError:
                    continue
                if pid in ids:
                    out.append(apath / s)
        return sorted(out)

    clip_len = num_past + num_future

    def build(ids):
        clips = []
        for f in folders_for(ids):
            clips.extend(chop_clips(f, clip_len))
        return ClipDataset(clips, num_past, num_future, transform,
                           "grey_scale")

    if split == "test":
        return build(person_ids)
    return build(person_ids), build(list(val_person_ids))


def bair_dataset(root: str, transform: ClipTransform, split: str = "train",
                 num_past: int = 2, num_future: int = 10,
                 train_val_ratio: float = 0.95, seed: int = 2021):
    """BAIR: pre-split train/test folders of example_*/NNNN.png; train gets a
    seeded 95/5 train/val split (reference: utils/dataset.py:55-64)."""
    root = Path(root) / ("train" if split != "test" else "test")
    clip_len = num_past + num_future
    clips: List[List[Path]] = []
    for folder in sorted(root.iterdir()):
        if folder.is_dir():
            clips.extend(chop_clips(folder, clip_len))
    if split == "test":
        return ClipDataset(clips, num_past, num_future, transform, "RGB")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(clips))
    n_train = int(len(clips) * train_val_ratio)
    train = ClipDataset([clips[i] for i in perm[:n_train]], num_past,
                        num_future, transform, "RGB")
    val = ClipDataset([clips[i] for i in perm[n_train:]], num_past,
                      num_future, transform, "RGB")
    return train, val


class MovingMNISTNpz:
    """MovingMNIST .npz with ``clips`` index array + ``input_raw_data`` frames
    (reference: utils/dataset.py:290-344). Frames stored (N, C, H, W)."""

    def __init__(self, path: str, transform: ClipTransform):
        arr = np.load(path)
        self.clips_index = arr["clips"]          # (2, num_clips, 2)
        self.frames = arr["input_raw_data"]      # (total, C, H, W)
        self.transform = transform

    def __len__(self) -> int:
        return self.clips_index.shape[1]

    def get(self, index: int, rng: Optional[np.random.Generator] = None):
        ci = self.clips_index[:, index, :]
        psi, plen = int(ci[0, 0]), int(ci[0, 1])
        fsi, flen = int(ci[1, 0]), int(ci[1, 1])
        past = self.frames[psi:psi + plen]
        future = self.frames[fsi:fsi + flen]
        clip = np.concatenate([past, future], axis=0).astype(np.float32)
        clip = clip.transpose(0, 2, 3, 1)        # -> (T, H, W, C)
        clip = self.transform(clip, rng)
        return clip[:plen], clip[-flen:]


class SyntheticMovingMNIST:
    """Procedural bouncing-digits clips — shape/statistics compatible stand-in
    when the real MovingMNIST npz is absent (benchmarks, CI, smoke tests).

    Deterministic per (seed, index). Two motion models:

    * ``motion="linear"`` — the canonical generator: glyphs bounce linearly
      with pixel-max compositing. Trivially extrapolatable, so trained
      models saturate within an epoch (useful for smoke tests only).
    * ``motion="dynamic"`` — the quality-evaluation task: per-digit constant
      acceleration (random direction) curves every trajectory, initial
      velocities are angle-drawn, speed is clamped, digits collide
      elastically (velocity swap when approaching within 0.75*digit) and
      occlude under max-compositing, and optional per-frame uniform pixel
      noise (``noise``) sets an intrinsic denoising floor. Future frames
      depend on latent state (velocity, acceleration, impending collisions)
      that must be inferred from the past — so rollout error accumulates
      and the FAR/NAR rollout modes separate, unlike the linear task.
    """

    _GLYPH_CACHE = {}  # digit_size -> rendered 0-9 bitmaps

    def __init__(self, num_clips: int = 2048, num_past: int = 10,
                 num_future: int = 10, size: int = 64, digit_size: int = 20,
                 num_digits: int = 2, seed: int = 0, channels: int = 1,
                 transform: Optional[ClipTransform] = None,
                 motion: str = "linear", noise: float = 0.0):
        self.num_clips = num_clips
        self.num_past = num_past
        self.num_future = num_future
        self.size = size
        self.channels = channels
        self.digit_size = min(digit_size, max(4, size // 2))
        self.num_digits = num_digits
        self.seed = seed
        self.transform = transform
        assert motion in ("linear", "dynamic"), motion
        self.motion = motion
        self.noise = float(noise)
        if self.digit_size not in self._GLYPH_CACHE:
            self._GLYPH_CACHE[self.digit_size] = self._render_glyphs(
                self.digit_size)
        self.glyphs = self._GLYPH_CACHE[self.digit_size]

    @staticmethod
    def _render_glyphs(size: int) -> np.ndarray:
        from PIL import Image, ImageDraw, ImageFont

        font = ImageFont.load_default()
        glyphs = []
        for d in range(10):
            img = Image.new("L", (16, 16), 0)
            ImageDraw.Draw(img).text((4, 2), str(d), fill=255, font=font)
            img = img.resize((size, size), Image.BILINEAR)
            glyphs.append(np.asarray(img, np.float32) / 255.0)
        return np.stack(glyphs)

    def __len__(self) -> int:
        return self.num_clips

    def get(self, index: int, rng: Optional[np.random.Generator] = None):
        r = np.random.default_rng((self.seed, index))
        t_total = self.num_past + self.num_future
        canvas = np.zeros((t_total, self.size, self.size, self.channels),
                          np.float32)
        lim = self.size - self.digit_size
        if self.motion == "dynamic":
            self._render_dynamic(canvas, r, t_total, lim)
        else:
            self._render_linear(canvas, r, t_total, lim)
            if self.noise > 0.0:
                # the noise knob composes with any motion flavor; linear
                # renders digit-major, so noise is a post pass (dynamic is
                # time-major and draws it inside its state loop)
                canvas += r.uniform(-self.noise, self.noise,
                                    size=canvas.shape).astype(np.float32)
                np.clip(canvas, 0.0, 1.0, out=canvas)
        if self.transform is not None:
            canvas = self.transform(canvas, rng)
        return canvas[:self.num_past], canvas[-self.num_future:]

    def _stamp(self, frame, glyph, tint, y: float, x: float):
        yi, xi = int(round(y)), int(round(x))
        region = frame[yi:yi + self.digit_size, xi:xi + self.digit_size, :]
        np.maximum(region, glyph[:, :, None] * tint, out=region)

    def _render_linear(self, canvas, r, t_total: int, lim: float):
        for _ in range(self.num_digits):
            glyph = self.glyphs[r.integers(10)]
            tint = (r.uniform(0.5, 1.0, size=self.channels)
                    if self.channels > 1 else np.ones(1))
            pos = r.uniform(0, lim, size=2)
            vel = r.uniform(2.0, 5.0, size=2) * r.choice([-1, 1], size=2)
            for t in range(t_total):
                self._stamp(canvas[t], glyph, tint, pos[0], pos[1])
                pos += vel
                for k in range(2):  # bounce
                    if pos[k] < 0:
                        pos[k] = -pos[k]
                        vel[k] = -vel[k]
                    if pos[k] > lim:
                        pos[k] = 2 * lim - pos[k]
                        vel[k] = -vel[k]

    def _render_dynamic(self, canvas, r, t_total: int, lim: float):
        """Accelerated + colliding digits, time-major (states interact)."""
        nd = self.num_digits
        glyphs = [self.glyphs[r.integers(10)] for _ in range(nd)]
        tints = [(r.uniform(0.5, 1.0, size=self.channels)
                  if self.channels > 1 else np.ones(1)) for _ in range(nd)]
        pos = r.uniform(0, lim, size=(nd, 2))
        ang = r.uniform(0, 2 * np.pi, size=nd)
        speed = r.uniform(1.5, 4.0, size=nd)
        vel = np.stack([speed * np.cos(ang), speed * np.sin(ang)], axis=1)
        aang = r.uniform(0, 2 * np.pi, size=nd)
        amag = r.uniform(0.05, 0.18, size=nd)
        acc = np.stack([amag * np.cos(aang), amag * np.sin(aang)], axis=1)
        coll_dist = 0.75 * self.digit_size
        for t in range(t_total):
            for d in range(nd):
                self._stamp(canvas[t], glyphs[d], tints[d],
                            pos[d, 0], pos[d, 1])
            if self.noise > 0.0:
                canvas[t] += r.uniform(-self.noise, self.noise,
                                       size=canvas[t].shape).astype(np.float32)
                np.clip(canvas[t], 0.0, 1.0, out=canvas[t])
            vel += acc
            sp = np.sqrt((vel ** 2).sum(axis=1, keepdims=True))
            np.divide(vel * 6.0, sp, out=vel, where=sp > 6.0)
            pos += vel
            for d in range(nd):
                for k in range(2):
                    if pos[d, k] < 0:
                        pos[d, k] = -pos[d, k]
                        vel[d, k] = -vel[d, k]
                    if pos[d, k] > lim:
                        pos[d, k] = 2 * lim - pos[d, k]
                        vel[d, k] = -vel[d, k]
            # elastic velocity swap for approaching near pairs (fixed order)
            for i in range(nd):
                for j in range(i + 1, nd):
                    dc = pos[i] - pos[j]
                    if (dc ** 2).sum() < coll_dist ** 2 and \
                            ((vel[i] - vel[j]) * dc).sum() < 0:
                        vel[[i, j]] = vel[[j, i]]

    def get_batch(self, indices, rng: Optional[np.random.Generator] = None):
        """Batch fast-path via the native renderer (native/clipgen.cpp);
        returns None to signal fallback to per-index ``get``.

        Native and Python generators draw different (both deterministic)
        trajectories — do not mix paths within one experiment.
        """
        from vptr_tpu_torch.data.native import normalize_f32, render_clips

        t_total = self.num_past + self.num_future
        clips = render_clips(self.glyphs, self.seed,
                             np.asarray(indices, np.int64), t_total,
                             self.size, self.channels, self.num_digits,
                             self.motion, self.noise)
        if clips is None:
            return None
        tf_ = self.transform
        if tf_ is not None:
            if tf_.flips and rng is not None:
                from vptr_tpu_torch.data.transforms import random_flip

                for i in range(clips.shape[0]):
                    clips[i] = random_flip(clips[i], rng)
            out = normalize_f32(clips, tf_.normalize.mean, tf_.normalize.std)
            clips = out if out is not None else tf_.normalize(clips)
        return clips[:, :self.num_past], clips[:, -self.num_future:]
