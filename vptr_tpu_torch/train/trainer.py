"""The experiment loop: build the modules, create or restore the train state,
run the epoch loop, on one card or on W ranks.

Counterpart of ``vptr_tpu/train/trainer.py`` (the reference's five train
scripts, train_AutoEncoder.py / train_FAR.py / train_NAR.py and their
``_mp`` twins): the stage comes from the config (``ae``, ``far``, ``nar``),
and ``Trainer(cfg).train()`` runs it:

* the modules are built on ``device`` from ``cfg.seed`` and the step
  factories of :mod:`vptr_tpu_torch.train.steps` make the train and eval
  steps; a stage-2 run loads the frozen autoencoder from ``cfg.ae_ckpt``;
* each batch is cast to the compute dtype on the host (half the bytes in
  bf16 and f16), pinned, and copied to the card without blocking;
* the step metrics stay on the card and are read in chunks of 128 steps
  (one host synchronisation a chunk, not one a step);
* with ``cfg.resume`` a run continues from the latest checkpoint under
  ``<ckpt_dir>/ckpt``: the whole state (the generator too), the history,
  and the loaders' epoch counts, so a resumed run equals an unbroken one;
* validation every ``val_per_epochs`` epochs, checkpoints every
  ``ckpt_per_epochs`` (the final epoch of a ``train()`` call always
  saves), GIFs of the last validation batch, scalars to
  ``tb/scalars.jsonl``, the log to ``train_log.log``;
* ``profile_dir``: a ``torch.profiler`` trace of ``profile_steps`` steps
  from the third step of the first epoch, written to
  ``<profile_dir>/trace.json`` and kept as ``Trainer.profiler``; the host
  spans ``trainer.loader_wait``, ``trainer.put_batch``, ``trainer.step``
  and ``trainer.fetch_metrics`` split the loop's wall
  (``scripts/torch_port_profile.py --trainer`` reads them).

Data, tensor and sequence parallelism (the reference's ``_mp`` drivers,
the JAX Trainer's (data, model) mesh): under a process group of W ranks
(``torchrun``, see :func:`vptr_tpu_torch.parallel.init_distributed`),
``mesh.data`` x ``mesh.model`` = W (``mesh.data`` -1: W / ``mesh.model``;
:func:`~vptr_tpu_torch.parallel.make_mesh`). With ``mesh.model`` M > 1 the
transformer is built whole from the seed on every rank and cut to the
rank's shares (``shard_transformer``: heads and hidden channels; with
``transformer.sequence_parallel`` also the temporal columns), where the
JAX Trainer replicates unless its caller passes TP out-shardings; the M
ranks of a data group load the same rows. Each data rank loads its shard
of every epoch, ``data.batch_size // W`` rows a batch (W here the data
ranks)
(a ``batch_size`` that W does not divide raises, as does a batch of other
than that many rows in :meth:`Trainer.put_batch`), and the steps are the
one-process steps at the global batch (:mod:`vptr_tpu_torch.train.steps`).
The logger, the summary writer, the GIFs and the profiler run on rank 0
only and checkpoints are written by rank 0; validation runs over the
sharded val loader with the metrics' global means; the steps/s of an epoch
is the slowest rank's, so every rank keeps the same history and
``train()`` returns the same state on every rank.

``steps_per_dispatch`` K > 1 runs the K
steps of a group one after another with the same metrics: there is no
``lax.scan`` to fold them into. ``debug_nans`` turns on
``torch.autograd.set_detect_anomaly`` for the run: a backward that produces
a NaN raises, naming the forward operation (forward NaNs are not checked,
where the JAX package's ``jax_debug_nans`` checks every operation).
"""

from __future__ import annotations

import logging
import time
from contextlib import closing
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from vptr_tpu_torch.config import ExperimentConfig
from vptr_tpu_torch.data.loader import build_loader
from vptr_tpu_torch.data.transforms import ReNormalize
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.discriminator import build_discriminator
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.parallel.mesh import make_mesh, max_over_ranks
from vptr_tpu_torch.train.checkpoint import CheckpointManager, load_ae_modules
from vptr_tpu_torch.train.optim import build_optimizer
from vptr_tpu_torch.train.state import create_ae_train_state, create_far_train_state
from vptr_tpu_torch.train.steps import (
    make_ae_eval_step,
    make_ae_train_step,
    make_far_eval_step,
    make_far_train_step,
    make_nar_eval_step,
    make_nar_train_step,
)
from vptr_tpu_torch.train.summary import (
    SummaryWriter,
    setup_logging,
    visualize_batch_clips,
)
from vptr_tpu_torch.utils.device import resolve_device
from vptr_tpu_torch.utils.misc import (
    AverageMeters,
    count_params,
    nar_step_flops,
    set_seed,
    transformer_step_flops,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
FETCH_EVERY = 128     # steps whose metrics are read from the card at once


def _dtype_of(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)} in the port, "
                         f"got {name!r}")
    return _DTYPES[name]


def _waited(batches):
    """The batches, each wait for the next one a ``trainer.loader_wait``
    span of a profile."""
    it = iter(batches)
    while True:
        with record_function("trainer.loader_wait"):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


def fetch_metrics(metrics: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """Step metric dicts (0-d tensors on one device) as Python floats, read
    with one copy to the host."""
    if not metrics:
        return []
    keys = list(metrics[0])
    flat = torch.stack([torch.as_tensor(m[k]).float() for m in metrics for k in keys])
    values = flat.tolist()
    return [dict(zip(keys, values[i * len(keys):(i + 1) * len(keys)]))
            for i in range(len(metrics))]


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device="cuda",
                 write_outputs: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _dtype_of(cfg.dtype)
        if cfg.ckpt_per_epochs < 1:
            # the cadence is a modulus; 0 is NOT "never" — disable
            # checkpoints with write_outputs=False instead
            raise ValueError(
                f"ckpt_per_epochs must be >= 1, got {cfg.ckpt_per_epochs}")
        if cfg.stage not in ("ae", "far", "nar"):
            raise ValueError(f"unknown stage {cfg.stage!r}")
        if self.dtype == torch.float16 and cfg.mesh.model > 1:
            raise ValueError(f"dtype float16 under mesh.model {cfg.mesh.model} is queued "
                             f"(ROADMAP.md §1); float16 trains with mesh.model 1")
        self.mesh = make_mesh(cfg.mesh.data, cfg.mesh.model)
        if cfg.data.batch_size % self.mesh.data:
            raise ValueError(f"data.batch_size {cfg.data.batch_size} does not split "
                             f"over {self.mesh.data} ranks")
        self.local_batch = cfg.data.batch_size // self.mesh.data
        self.renorm = ReNormalize(cfg.data.mean, cfg.data.std)
        self._build_models()
        self._build_steps()
        # checkpoints on every rank (rank 0 writes, all restore); the logs,
        # scalars and GIFs on rank 0 only (reference: train_FAR_mp.py's
        # rank == 0 gates)
        host0 = self.mesh.rank == 0
        self.ckpt = (CheckpointManager(str(Path(cfg.ckpt_dir) / "ckpt"),
                                       keep=cfg.ckpt_keep)
                     if write_outputs else None)
        if write_outputs and host0:
            self.logger = setup_logging(cfg.ckpt_dir)
            self.writer = SummaryWriter(str(Path(cfg.ckpt_dir) / "tb"))
        else:
            self.logger = logging.getLogger("vptr_tpu_torch.silent")
            self.writer = None
        self.write_outputs = write_outputs and host0
        self.history: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    def _build_models(self):
        cfg = self.cfg
        gen = set_seed(cfg.seed)
        self.enc, self.dec = build_autoencoder(cfg.ae, self.dtype, self.device, gen)
        self.use_gan = cfg.loss.lam_gan is not None
        self.disc = (build_discriminator(cfg.disc, self.dtype, self.device, gen)
                     if self.use_gan else None)
        self.transformer = (build_transformer(cfg.transformer, self.dtype,
                                              self.device, gen, mesh=self.mesh)
                            if cfg.stage in ("far", "nar") else None)
        self.g_opt = build_optimizer(cfg.optim, d_model=cfg.transformer.d_model)
        self.d_opt = build_optimizer(cfg.optim_d) if self.use_gan else None

    def _build_steps(self):
        cfg = self.cfg
        gan = {"disc": self.disc, "d_optimizer": self.d_opt}
        if cfg.stage == "ae":
            self.train_step = make_ae_train_step(self.enc, self.dec, self.disc,
                                                 self.g_opt, self.d_opt, cfg.loss)
            self.eval_step = make_ae_eval_step(self.enc, self.dec, self.disc,
                                               cfg.loss)
        elif cfg.stage == "far":
            self.train_step = make_far_train_step(
                self.enc, self.dec, self.transformer, self.g_opt, cfg.loss, **gan,
                remat_decoder=cfg.transformer.remat)
            self.eval_step = make_far_eval_step(self.enc, self.dec,
                                                self.transformer, cfg.loss)
        else:
            self.train_step = make_nar_train_step(
                self.enc, self.dec, self.transformer, self.g_opt, cfg.loss, **gan,
                remat_decoder=cfg.transformer.remat)
            self.eval_step = make_nar_eval_step(self.enc, self.dec,
                                                self.transformer, cfg.loss)
        # 0 = auto: 1 (the JAX package's TPU choice of 8 folds steps into
        # one lax.scan dispatch, which has no counterpart here)
        self.steps_per_dispatch = cfg.steps_per_dispatch or 1

    # ------------------------------------------------------------------
    def init_state(self):
        """A fresh train state (step 0, the generator seeded with
        ``cfg.seed``, zero optimizer states) over the trainer's modules as
        they are; a stage-2 state first loads the frozen autoencoder from
        ``cfg.ae_ckpt`` when it is set (reference: train_FAR.py:210)."""
        cfg = self.cfg
        if cfg.stage == "ae":
            return create_ae_train_state(self.enc, self.dec, self.disc, self.g_opt,
                                         self.d_opt, seed=cfg.seed)
        if cfg.ae_ckpt:
            load_ae_modules(cfg.ae_ckpt, self.enc, self.dec)
        return create_far_train_state(self.enc, self.dec, self.transformer,
                                      self.g_opt, seed=cfg.seed, disc=self.disc,
                                      d_optimizer=self.d_opt)

    def param_counts(self, state) -> Dict[str, int]:
        out = {"enc": count_params(state.enc), "dec": count_params(state.dec)}
        if getattr(state, "transformer", None) is not None:
            out["transformer"] = count_params(state.transformer)
        if state.disc is not None:
            out["disc"] = count_params(state.disc)
        return out

    def _stage(self, arr) -> torch.Tensor:
        # cast on the host (round to nearest even, as a cast on the card
        # would): half the bytes to copy in bf16 and f16
        t = torch.as_tensor(arr).to(self.dtype)
        if self.device.type != "cuda":
            return t
        # a fresh pinned buffer a batch: the caching host allocator keeps it
        # from reuse until its asynchronous copy has landed
        return t.pin_memory().to(self.device, non_blocking=True)

    def put_batch(self, past, future, ragged_ok: bool = False):
        """(past, future) numpy batches -> tensors on the trainer's device in
        the compute dtype. Under W > 1 ranks a batch of other than
        ``batch_size // W`` rows raises ValueError unless ``ragged_ok``: the
        steps weigh every rank's means alike, so unequal shares would not be
        the global batch's means (the JAX Trainer raises on a ragged batch
        under multi-host, ``trainer.py:265-284``)."""
        if (not ragged_ok and self.mesh.data > 1
                and np.shape(past)[0] != self.local_batch):
            raise ValueError(
                f"ragged batch of {np.shape(past)[0]} rows on rank {self.mesh.rank}: "
                f"each of the {self.mesh.data} ranks takes {self.local_batch} "
                f"(data.batch_size // W); use drop_last batches")
        return self._stage(past), self._stage(future)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def train(self, state=None, epochs: Optional[int] = None):
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        epochs = epochs if epochs is not None else cfg.epochs
        self.logger.info("param counts: %s", self.param_counts(state))

        start_epoch = 0
        if self.ckpt is not None and cfg.resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state = self.ckpt.restore(state)
                self.history = self.ckpt.load_history()
                start_epoch = int(self.history.get("epoch", 0))
                self.logger.info("resumed from step %s (epoch %d)",
                                 latest, start_epoch)

        # each rank iterates its shard of the index space (the reference's
        # DistributedSampler for train and val, train_FAR_mp.py:71-77)
        shard = {"host_id": self.mesh.data_rank, "num_hosts": self.mesh.data}
        train_loader = build_loader(cfg.data, split="train", seed=cfg.seed, **shard)
        val_loader = build_loader(cfg.data, split="val", seed=cfg.seed, **shard)
        # the loaders' epoch counts (their shuffles and augmentation draws)
        # go on from where the saved run stopped
        train_loader.epoch = start_epoch
        val_loader.epoch = start_epoch // cfg.val_per_epochs
        if self.steps_per_dispatch > 1:
            self.logger.info("steps_per_dispatch %d: the port runs the steps of "
                             "a group one after another", self.steps_per_dispatch)
        if self.mesh.data > 1:
            self.logger.info("data parallel over %d ranks, %d rows a rank",
                             self.mesh.data, self.local_batch)
        if self.mesh.model > 1:
            self.logger.info("tensor parallel over %d model ranks%s", self.mesh.model,
                             ", sequence parallel temporal columns"
                             if cfg.transformer.sequence_parallel else "")

        with torch.autograd.set_detect_anomaly(cfg.debug_nans):
            for epoch in range(start_epoch + 1, start_epoch + epochs + 1):
                epoch_start = datetime.now()
                profile = (bool(cfg.profile_dir) and epoch == start_epoch + 1
                           and self.mesh.rank == 0)
                state, avg = self._train_epoch(state, train_loader, profile)
                if self.writer is not None:
                    self.writer.write_scalars(epoch, avg, prefix="train/")
                self.logger.info("epoch %d train: %s", epoch,
                                 {k: round(v, 5) for k, v in avg.items()})
                self._update_history("train", epoch, avg)

                if epoch % cfg.val_per_epochs == 0:
                    self._validate(state, val_loader, epoch)

                last = epoch == start_epoch + epochs
                if self.ckpt is not None and (last or
                                              epoch % cfg.ckpt_per_epochs == 0):
                    self.history["epoch"] = epoch
                    self.ckpt.save(state.step, state, config_json=cfg.to_json(),
                                   history=self.history)
                self.logger.info("epoch %d took %s", epoch,
                                 datetime.now() - epoch_start)
        return state

    def _train_epoch(self, state, loader, profile: bool):
        """One epoch of train steps; returns (state, the averaged metrics
        with steps_per_sec and, in stage 2, transformer_tflops_per_sec)."""
        cfg = self.cfg
        meters = AverageMeters()
        pending = []            # the steps' metrics, still on the card
        prof = None
        t0, n_steps = time.perf_counter(), 0
        with closing(iter(loader)) as batches:
            for bi, (past, future) in enumerate(_waited(batches)):
                if cfg.steps_per_epoch is not None and bi >= cfg.steps_per_epoch:
                    break
                if profile and bi == 2:
                    prof = self._start_profile()
                elif prof is not None and bi == 2 + cfg.profile_steps:
                    self._stop_profile(prof)
                    prof = None
                with record_function("trainer.put_batch"):
                    batch = self.put_batch(past, future)
                with record_function("trainer.step"):
                    state, m = self.train_step(state, *batch)
                pending.append(m)
                n_steps += 1
                if len(pending) >= FETCH_EVERY:
                    pending = self._fetch(pending, meters)
        self._fetch(pending, meters)
        self._sync()
        if prof is not None:
            self._stop_profile(prof)
        dt = max_over_ranks(time.perf_counter() - t0)   # the slowest rank's

        avg = meters.averages()
        avg["steps_per_sec"] = n_steps / max(dt, 1e-9)
        if cfg.stage in ("far", "nar"):
            avg["transformer_tflops_per_sec"] = (
                self._step_flops() * avg["steps_per_sec"] / 1e12)
        return state, avg

    @staticmethod
    def _fetch(pending, meters) -> list:
        """Read the pending steps' metrics into ``meters``; returns an empty
        pending list."""
        with record_function("trainer.fetch_metrics"):
            for values in fetch_metrics(pending):
                meters.update(values)
        return []

    def _step_flops(self) -> int:
        """The transformer's FLOPs a train step (the JAX package's count,
        bench.py:145)."""
        t, d = self.cfg.transformer, self.cfg.data
        if self.cfg.stage == "far":
            return transformer_step_flops(
                d.batch_size, d.num_past_frames + d.num_future_frames - 1,
                t.enc_h, t.enc_w, t.d_model, t.n_heads, t.num_encoder_layers,
                t.window_size, t.spatial_ffn_hidden_ratio)
        return nar_step_flops(
            d.batch_size, d.num_past_frames, d.num_future_frames, t.enc_h,
            t.enc_w, t.d_model, t.n_heads, t.num_encoder_layers,
            t.num_decoder_layers, t.window_size, t.spatial_ffn_hidden_ratio)

    def _validate(self, state, loader, epoch: int):
        meters = AverageMeters()
        pending, sample = [], None
        for past, future in loader:
            metrics, pred = self.eval_step(state, *self.put_batch(past, future))
            pending.append(metrics)
            sample = (past, future, pred)
        for values in fetch_metrics(pending):
            meters.update(values)
        vavg = meters.averages()
        if self.writer is not None:
            self.writer.write_scalars(epoch, vavg, prefix="val/")
        self.logger.info("epoch %d val: %s", epoch,
                         {k: round(v, 5) for k, v in vavg.items()})
        self._update_history("val", epoch, vavg)
        if sample is not None and self.write_outputs:
            past, future, pred = sample
            self._dump_gifs(epoch, past, future, pred.float().cpu().numpy())

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof):
        self._sync()
        prof.stop()
        self.profiler = prof
        out = Path(self.cfg.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / "trace.json"
        prof.export_chrome_trace(str(path))
        self.logger.info("profiler trace written to %s", path)

    def _update_history(self, split: str, epoch: int, avg: Dict[str, float]):
        hist = self.history.setdefault(split, {})
        for k, v in avg.items():
            hist.setdefault(k, []).append([epoch, float(v)])

    def _dump_gifs(self, epoch: int, past, future, pred: np.ndarray):
        out = Path(self.cfg.ckpt_dir) / f"val_gifs_epoch{epoch}"
        try:
            pred_future = pred[:, -future.shape[1]:]
            visualize_batch_clips(past, future, pred_future, str(out),
                                  renorm=self.renorm, desc="pred_future")
        except Exception as e:  # GIF failures must never kill training
            self.logger.warning("gif dump failed: %s", e)
