"""Offline data preparation utilities.

The port's copy of ``vptr_tpu/data/preprocessing.py``. ffmpeg, TensorFlow
and detectron2 are reached only by the functions that need them, as there.

Parity with the reference's L0 layer (reference: utils/pre_processing.py,
utils/read_BAIR_tfrecords.py):

* video <-> frame-folder conversion via the ffmpeg binary;
* BAIR tfrecord -> example_N/NNNN.png extraction (needs tensorflow, which is
  baked into this image but gated at import so the rest of the package never
  depends on it);
* dataset mean/std estimation (reference: utils/dataset.py:482-531).

The KTH person-filter (reference: utils/pre_processing.py:118-176) is
implemented detector-agnostically: :func:`person_run_filter` /
:func:`human_detector` take any per-frame person signal (the reference's
detectron2 predictor is available import-gated when that package exists) and
produce the same ``*_no_empty_<idx>`` folder layout the KTH loader consumes.

Clip -> video export (:func:`visualize_clip`) writes MP4 via ffmpeg when the
binary exists, else MJPEG AVI through a from-scratch RIFF muxer — this image
ships neither ffmpeg, cv2, nor pyav.
"""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def vid2frames(video_path: str, frames_dir: str, fps: Optional[int] = None):
    """Extract video frames to ``frames_dir/%04d.png`` with ffmpeg
    (reference: utils/pre_processing.py:34-50)."""
    out = Path(frames_dir)
    out.mkdir(parents=True, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-i", str(video_path)]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += [str(out / "%04d.png")]
    subprocess.run(cmd, check=True, capture_output=True)


def frames2vid(frames_dir: str, video_path: str, fps: int = 10,
               pattern: str = "%04d.png"):
    """Assemble frames back into a video (reference:
    utils/pre_processing.py:52-64)."""
    cmd = ["ffmpeg", "-y", "-framerate", str(fps),
           "-i", str(Path(frames_dir) / pattern),
           "-pix_fmt", "yuv420p", str(video_path)]
    subprocess.run(cmd, check=True, capture_output=True)


def subsample_frames(frames_dir: str, out_dir: str, keep_every: int = 2):
    """Keep every k-th frame (reference: utils/pre_processing.py:66-76)."""
    import shutil

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = sorted(Path(frames_dir).glob("*"))
    for i, f in enumerate(files[::keep_every]):
        shutil.copy(f, out / f"{i:04d}{f.suffix}")


def read_bair_tfrecords(tfrecord_dir: str, out_dir: str,
                        image_key: str = "image_aux1",
                        frames_per_traj: int = 30):
    """Convert BAIR push tfrecords into ``example_N/0000.png`` frame folders
    (reference: utils/read_BAIR_tfrecords.py:10-52). Requires tensorflow."""
    import tensorflow as tf  # gated: only this function needs TF
    from PIL import Image

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = sorted(Path(tfrecord_dir).glob("*.tfrecord*"))
    example_idx = 0
    for fpath in files:
        for record in tf.data.TFRecordDataset(str(fpath)):
            ex = tf.train.Example()
            ex.ParseFromString(record.numpy())
            folder = out / f"example_{example_idx}"
            folder.mkdir(exist_ok=True)
            for t in range(frames_per_traj):
                key = f"{t}/{image_key}/encoded"
                if key not in ex.features.feature:
                    break
                raw = ex.features.feature[key].bytes_list.value[0]
                arr = np.frombuffer(raw, np.uint8).reshape(64, 64, 3)
                Image.fromarray(arr).save(folder / f"{t:04d}.png")
            example_idx += 1
    return example_idx


def mean_std_compute(dataset, color_mode: str = "RGB",
                     max_items: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate per-channel mean/std over a dataset of (past, future) clips
    (reference: utils/dataset.py:482-531). std = sqrt(E[x^2] - E[x]^2)."""
    sum_img = None
    sq_img = None
    n = 0
    total = len(dataset) if max_items is None else min(len(dataset),
                                                       max_items)
    for i in range(total):
        past, future = dataset.get(i)
        clip = np.concatenate([past, future], axis=0).astype(np.float64)
        n += clip.shape[0]
        s = clip.sum(axis=0)
        if sum_img is None:
            sum_img, sq_img = s, np.square(clip).sum(axis=0)
        else:
            sum_img += s
            sq_img += np.square(clip).sum(axis=0)
    mean_img = sum_img / n
    mean_sq = sq_img / n
    if color_mode == "RGB":
        mean = mean_img.mean(axis=(0, 1))
        std = np.sqrt(mean_sq.mean(axis=(0, 1)) - np.square(mean))
    else:
        mean = np.array([mean_img.mean()])
        std = np.sqrt(np.array([mean_sq.mean()]) - np.square(mean))
    return mean.astype(np.float32), std.astype(np.float32)


# ---------------------------------------------------------------------------
# KTH human-presence filtering (reference: utils/pre_processing.py:118-176)
# ---------------------------------------------------------------------------

def person_run_filter(person_present, min_run: int = 20):
    """Consecutive-run extraction: given per-frame person-present booleans,
    return the lists of frame indices forming runs of >= ``min_run``
    consecutive person frames (reference: utils/pre_processing.py:147-165,
    the groupby-on-index-offset trick, re-derived with a plain scan).

    Detector-agnostic: the booleans can come from any bbox/score source
    (detectron2, a TPU-side detector, hand labels, ...).
    """
    runs, current = [], []
    for i, present in enumerate(person_present):
        if present:
            current.append(i)
        else:
            if len(current) >= min_run:
                runs.append(current)
            current = []
    if len(current) >= min_run:
        runs.append(current)
    return runs


def _detectron2_person_detector(score_threshold: float = 0.5):
    """The reference's detector (detectron2 Faster-RCNN, COCO person=0;
    reference: utils/pre_processing.py:125-131). Import-gated — detectron2
    is not in this image; supply your own ``detector`` callable instead."""
    from detectron2 import model_zoo  # noqa: gated import
    from detectron2.config import get_cfg
    from detectron2.engine import DefaultPredictor

    cfg = get_cfg()
    cfg.merge_from_file(model_zoo.get_config_file(
        "COCO-Detection/faster_rcnn_X_101_32x8d_FPN_3x.yaml"))
    cfg.MODEL.WEIGHTS = model_zoo.get_checkpoint_url(
        "COCO-Detection/faster_rcnn_X_101_32x8d_FPN_3x.yaml")
    cfg.INPUT.FORMAT = "RGB"
    predictor = DefaultPredictor(cfg)

    def detect(img: np.ndarray) -> bool:
        scores = predictor(img)["instances"].scores.cpu().numpy()
        return len(scores) > 0 and scores[0] > score_threshold

    return detect


def human_detector(frames_root: str, save_dir: str, detector=None,
                   min_run: int = 20, pattern: str = "*"):
    """KTH cleanup: keep only >= ``min_run``-frame consecutive runs in which
    a person is detected; copy each run to ``<folder>_no_empty_<idx>``
    (reference: utils/pre_processing.py:118-176).

    ``detector``: callable(np.uint8 HWC RGB image) -> bool. Defaults to the
    reference's detectron2 predictor when that package is installed;
    otherwise pass any bbox source (the run logic is detector-agnostic).
    Returns {folder_name: number_of_runs_written}.
    """
    import shutil

    from PIL import Image

    detector = detector or _detectron2_person_detector()
    out_root = Path(save_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    written = {}
    for folder in sorted(p for p in Path(frames_root).glob(pattern)
                         if p.is_dir()):
        img_files = sorted(f for f in folder.iterdir() if f.is_file())
        present = [detector(np.asarray(Image.open(f).convert("RGB")))
                   for f in img_files]
        runs = person_run_filter(present, min_run)
        for idx, run in enumerate(runs):
            new_folder = out_root / f"{folder.name}_no_empty_{idx}"
            new_folder.mkdir(parents=True, exist_ok=True)
            for f_id in run:
                shutil.copy(img_files[f_id], new_folder)
        written[folder.name] = len(runs)
    return written


# ---------------------------------------------------------------------------
# Clip -> video export (reference: utils/dataset.py:270-288 visualize_clip,
# which writes MP4 via cv2 — neither cv2 nor ffmpeg exists in this image, so
# the fallback is a from-scratch MJPEG-in-AVI muxer: PIL-encoded JPEG frames
# in a hand-written RIFF container, playable everywhere)
# ---------------------------------------------------------------------------

def _have_ffmpeg() -> bool:
    import shutil

    return shutil.which("ffmpeg") is not None


def _to_uint8_frames(clip: np.ndarray) -> np.ndarray:
    """(T, H, W, C) float [0,1] or uint8 -> (T, H, W, 3) uint8."""
    clip = np.asarray(clip)
    if clip.dtype != np.uint8:
        clip = (np.clip(clip, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if clip.shape[-1] == 1:
        clip = np.repeat(clip, 3, axis=-1)
    return clip


def write_mjpeg_avi(clip: np.ndarray, path: str, fps: int = 10,
                    quality: int = 90) -> None:
    """Write (T, H, W, C) frames as an MJPEG AVI (RIFF muxer from scratch)."""
    import io
    import struct

    from PIL import Image

    frames = _to_uint8_frames(clip)
    t, h, w = frames.shape[:3]
    jpegs = []
    for fr in frames:
        buf = io.BytesIO()
        Image.fromarray(fr).save(buf, format="JPEG", quality=quality)
        data = buf.getvalue()
        if len(data) % 2:
            data += b"\x00"             # RIFF chunks are even-sized
        jpegs.append(data)

    le32 = lambda v: struct.pack("<I", v & 0xFFFFFFFF)
    le16 = lambda v: struct.pack("<H", v & 0xFFFF)

    avih = (le32(1_000_000 // fps) + le32(sum(map(len, jpegs)) * fps)
            + le32(0) + le32(0x10)      # AVIF_HASINDEX
            + le32(t) + le32(0) + le32(1) + le32(max(map(len, jpegs)))
            + le32(w) + le32(h) + le32(0) * 4)
    strh = (b"vids" + b"MJPG" + le32(0) + le16(0) + le16(0) + le32(0)
            + le32(1) + le32(fps) + le32(0) + le32(t)
            + le32(max(map(len, jpegs))) + le32(0xFFFFFFFF) + le32(0)
            + le16(0) + le16(0) + le16(w) + le16(h))
    strf = (le32(40) + le32(w) + le32(h) + le16(1) + le16(24) + b"MJPG"
            + le32(w * h * 3) + le32(0) * 4)

    chunk = lambda tag, body: tag + le32(len(body)) + body
    lst = lambda kind, body: b"LIST" + le32(len(body) + 4) + kind + body

    strl = lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf))
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl)

    movi_body = b"movi"
    idx = b""
    for data in jpegs:
        # idx1 offsets count from the 'movi' fourcc (first chunk at 4)
        idx += b"00dc" + le32(0x10) + le32(len(movi_body)) + le32(len(data))
        movi_body += chunk(b"00dc", data)
    movi = b"LIST" + le32(len(movi_body)) + movi_body
    riff_body = b"AVI " + hdrl + movi + chunk(b"idx1", idx)

    with open(path, "wb") as f:
        f.write(b"RIFF" + le32(len(riff_body)) + riff_body)


def visualize_clip(clip: np.ndarray, file_name: str, fps: int = 10) -> str:
    """Save a (T, H, W, C) clip as a video file (reference:
    utils/dataset.py:270-288). Uses ffmpeg for .mp4 when the binary exists;
    otherwise writes MJPEG AVI (the extension is adjusted to .avi) — the
    capability, clip -> playable video, is what the reference exposes.
    Returns the path actually written."""
    import tempfile

    from PIL import Image

    path = Path(file_name)
    frames = _to_uint8_frames(clip)
    if _have_ffmpeg():
        with tempfile.TemporaryDirectory() as td:
            for i, fr in enumerate(frames):
                Image.fromarray(fr).save(Path(td) / f"{i:04d}.png")
            frames2vid(td, str(path), fps=fps)
        return str(path)
    path = path.with_suffix(".avi")
    write_mjpeg_avi(frames, str(path), fps=fps)
    return str(path)
