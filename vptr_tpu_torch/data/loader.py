"""Batched, prefetching, host-sharded data loader.

The port's copy of ``vptr_tpu/data/loader.py``: the same batches for the
same seed, epoch and host. An iterator abandoned mid-epoch (closed, or
dropped) cancels its pending batch builds.

Replaces torch DataLoader + DistributedSampler (reference:
utils/dataset.py:21-79, train_FAR_mp.py:71-77): a thread-pool assembles
(past, future) numpy batches while the accelerator trains, and each host
iterates its own shard of the index space (global batch // num_hosts rows
per host, like the reference's batch // world_size split).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class ClipLoader:
    """Iterate (past, future) numpy batches of shape (B, T, H, W, C).

    Args:
        dataset: object with ``__len__`` and ``get(index, rng)``.
        batch_size: per-host batch size.
        shuffle: reshuffle indices each epoch (seeded, reproducible).
        drop_last: drop the trailing partial batch (the reference's
            DataLoader(drop_last=True) for train/val).
        host_id / num_hosts: shard the index space across hosts.
        prefetch: number of batches to stage ahead on a worker thread.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, host_id: int = 0,
                 num_hosts: int = 1, prefetch: int = 2,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.epoch = 0

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        # contiguous host shard, padded so every host sees the same count
        per_host = -(-n // self.num_hosts)
        padded = np.resize(idx, per_host * self.num_hosts)
        return padded[self.host_id * per_host:(self.host_id + 1) * per_host]

    def __len__(self) -> int:
        per_host = -(-len(self.dataset) // self.num_hosts)
        if self.drop_last:
            return per_host // self.batch_size
        return -(-per_host // self.batch_size)

    def _make_batch(self, indices: np.ndarray,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        if hasattr(self.dataset, "get_batch"):
            batch = self.dataset.get_batch(indices, rng)
            if batch is not None:
                return batch
        pasts, futures = [], []
        for i in indices:
            p, f = self.dataset.get(int(i), rng)
            pasts.append(p)
            futures.append(f)
        return np.stack(pasts), np.stack(futures)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        indices = self._epoch_indices()
        epoch = self.epoch
        self.epoch += 1
        nb = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        if not self.drop_last:
            rem = indices[nb * self.batch_size:]
            if len(rem):
                batches.append(rem)

        def make(bi: int, b: np.ndarray):
            # per-batch keyed rng: augmentation streams stay deterministic
            # under any worker-thread scheduling (torch DataLoader gives the
            # same guarantee via per-worker seeds)
            rng = np.random.default_rng(
                (self.seed, epoch, self.host_id, bi))
            return self._make_batch(b, rng)

        if self.prefetch <= 0 or self.num_workers <= 0:
            for bi, b in enumerate(batches):
                yield make(bi, b)
            return

        # thread pool: PIL decode / native render release the GIL, so
        # batches assemble in parallel while the accelerator trains
        from concurrent.futures import ThreadPoolExecutor

        from collections import deque

        ex = ThreadPoolExecutor(self.num_workers)
        try:
            inflight: deque = deque()
            it = iter(enumerate(batches))
            for _ in range(self.prefetch + self.num_workers):
                nxt = next(it, None)
                if nxt is None:
                    break
                inflight.append(ex.submit(make, *nxt))
            while inflight:
                yield inflight.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    inflight.append(ex.submit(make, *nxt))
            ex.shutdown(wait=True)
        except BaseException:
            # early consumer exit (steps_per_epoch break / exception /
            # GeneratorExit): cancel pending batch builds instead of
            # blocking on up to prefetch+num_workers in-flight futures
            ex.shutdown(wait=False, cancel_futures=True)
            raise


def build_dataset(cfg, *, split: str = "train", seed: int = 0):
    """Dataset factory from a DataConfig (reference: get_dataloader,
    utils/dataset.py:21-79). Falls back to the synthetic generator when
    data_dir is empty or missing."""
    from pathlib import Path

    from vptr_tpu_torch.data.datasets import (
        MovingMNISTNpz,
        SyntheticMovingMNIST,
        bair_dataset,
        kth_dataset,
    )
    from vptr_tpu_torch.data.transforms import ClipTransform

    train = split == "train"
    name = cfg.dataset.lower()
    if name == "synthetic" or not cfg.data_dir or \
            not Path(cfg.data_dir).exists():
        # no data on disk -> deterministic synthetic stand-in matching the
        # requested geometry (any dataset name). The stand-in honors the
        # NAMED dataset's transform recipe: BAIR's is ToTensor+Normalize
        # only — no flip augmentation (reference: utils/dataset.py:52-55)
        # — while MNIST/KTH train transforms flip (utils/dataset.py:25,38),
        # so a surrogate "bair" run must not train with an augmentation the
        # real recipe lacks.
        tf = ClipTransform(mean=cfg.mean, std=cfg.std,
                           flips=train and cfg.random_flip
                           and name != "bair")
        num_clips = {"train": 4096, "val": 256, "test": 256}[split]
        num_past = (cfg.num_past_frames if split != "test"
                    else cfg.test_past_frames)
        num_future = (cfg.num_future_frames if split != "test"
                      else cfg.test_future_frames)
        return SyntheticMovingMNIST(
            num_clips=num_clips, num_past=num_past, num_future=num_future,
            size=cfg.img_size, channels=cfg.img_channels,
            num_digits=cfg.synthetic_digits,
            motion=cfg.synthetic_motion, noise=cfg.synthetic_noise,
            seed={"train": 0, "val": 1, "test": 2}[split] + 10 * seed,
            transform=tf)

    if name == "mnist":
        tf = ClipTransform(mean=cfg.mean, std=cfg.std,
                           flips=train and cfg.random_flip)
        fname = {"train": "moving-mnist-train.npz",
                 "val": "moving-mnist-valid.npz",
                 "test": "moving-mnist-test.npz"}[split]
        return MovingMNISTNpz(str(Path(cfg.data_dir) / fname), tf)

    if name == "kth":
        # KTH: center-crop 120 then resize 64 (utils/dataset.py:25-26)
        tf = ClipTransform(crop=(120, 120), size=(cfg.img_size, cfg.img_size),
                           mean=cfg.mean, std=cfg.std,
                           flips=train and cfg.random_flip)
        if split == "test":
            return kth_dataset(cfg.data_dir, tf, "test",
                               cfg.test_past_frames, cfg.test_future_frames)
        tr, va = kth_dataset(cfg.data_dir, tf, "train", cfg.num_past_frames,
                             cfg.num_future_frames,
                             rng=np.random.default_rng(seed))
        return tr if split == "train" else va

    if name == "bair":
        tf = ClipTransform(mean=cfg.mean, std=cfg.std, flips=False)
        if split == "test":
            return bair_dataset(cfg.data_dir, tf, "test",
                                cfg.test_past_frames, cfg.test_future_frames)
        tr, va = bair_dataset(cfg.data_dir, tf, "train",
                              cfg.num_past_frames, cfg.num_future_frames)
        return tr if split == "train" else va

    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def build_loader(cfg, *, split: str = "train", seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1) -> ClipLoader:
    ds = build_dataset(cfg, split=split, seed=seed)
    per_host = max(1, cfg.batch_size // num_hosts)
    return ClipLoader(ds, per_host, shuffle=(split != "test"),
                      drop_last=(split != "test"), seed=seed,
                      host_id=host_id, num_hosts=num_hosts,
                      prefetch=cfg.prefetch, num_workers=cfg.num_workers)
