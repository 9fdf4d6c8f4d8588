"""Checkpoint / resume on ``torch.save``, in the JAX package's layout.

Counterpart of ``vptr_tpu/train/checkpoint.py`` (orbax there):
``<directory>/<step>/state.pt`` per saved step (``directory`` is
``<ckpt_dir>/ckpt``), ``config.json`` and ``history.json`` beside the step
directories, the newest ``keep`` steps kept. A step is written into a
temporary directory and renamed into place, so a run cut mid-save leaves
the previous steps whole and no partial step behind.

A checkpoint holds the whole train state (:mod:`vptr_tpu_torch.train.state`):
the step, the state's ``torch.Generator`` (so a resumed run draws the
dropout masks an unbroken one would), every module's state dict (BatchNorm
running statistics included; a stage-2 state's frozen encoder and decoder
too) and every optimizer state (count, first and second moments in their
dtypes). :meth:`CheckpointManager.restore` loads it into a state of the
same configuration, in place, on that state's device.

Under a process group of W > 1 ranks, rank 0 writes (the others write
nothing, not even the directory) and a barrier follows every save, so no
rank looks for a step that is still being renamed into place; every rank
restores the same file onto its own device. A checkpoint is always whole,
in the one-process layout: under tensor parallelism every rank takes part
in gathering the transformer's shares and its optimizer moments (the
model group's all-gathers) before rank 0 writes, and a restore cuts each
rank's shares from the whole tensors, so a run on one mesh resumes on
another (``mesh.model`` 2 in one process, and the other way round).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Optional

import torch

from vptr_tpu_torch.models.transformer import tp_shards
from vptr_tpu_torch.parallel.mesh import barrier, gather_state, host_id, shard_state
from vptr_tpu_torch.train.optim import AdamState
from vptr_tpu_torch.train.state import AETrainState, Stage2TrainState

_FILE = "state.pt"
# the modules and optimizer states of each kind of state, by attribute
_MODULES = {AETrainState: ("enc", "dec", "disc"),
            Stage2TrainState: ("transformer", "enc", "dec", "disc")}
_OPTS = {AETrainState: ("g_opt_state", "d_opt_state"),
         Stage2TrainState: ("opt_state", "d_opt_state")}
# the module whose parameters an optimizer state's moments mirror (its
# shards are theirs)
_OPT_OF = {"opt_state": "transformer", "d_opt_state": "disc", "g_opt_state": None}


def _shards(state, opt_name: str):
    owner = _OPT_OF[opt_name]
    return tp_shards(getattr(state, owner)) if owner else {}


def _write_text(path: Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def state_dict(state) -> dict:
    """The train state as a dict of tensors, ints and strings, whole (a
    sharded transformer's shares gathered: a collective every model rank
    calls)."""
    kind = type(state)
    out = {"kind": kind.__name__, "step": int(state.step),
           "generator": state.generator.get_state()}
    for name in _MODULES[kind]:
        module = getattr(state, name)
        out[name] = (None if module is None else
                     gather_state(module.state_dict(), tp_shards(module)))
    for name in _OPTS[kind]:
        opt = getattr(state, name)
        shards = _shards(state, name)
        out[name] = None if opt is None else {"count": opt.count,
                                              "mu": gather_state(opt.mu, shards),
                                              "nu": gather_state(opt.nu, shards)}
    return out


def load_state_dict(state, saved: dict):
    """Load :func:`state_dict`'s output into ``state`` in place (every
    module strictly, every optimizer state onto the modules' device);
    returns ``state``."""
    kind = type(state)
    if saved["kind"] != kind.__name__:
        raise ValueError(f"a {saved['kind']} checkpoint cannot restore a "
                         f"{kind.__name__}")
    for name in _MODULES[kind]:
        module = getattr(state, name)
        if (module is None) != (saved[name] is None):
            raise ValueError(f"the checkpoint's {name} and the state's do not "
                             f"match (one of them is None)")
        if module is not None:
            module.load_state_dict(shard_state(saved[name], tp_shards(module)))
    device = next(getattr(state, _MODULES[kind][0]).parameters()).device
    for name in _OPTS[kind]:
        opt = saved[name]
        if (getattr(state, name) is None) != (opt is None):
            raise ValueError(f"the checkpoint's {name} and the state's do not "
                             f"match (one of them is None)")
        if opt is not None:
            shards = _shards(state, name)
            setattr(state, name, AdamState(
                opt["count"],
                {k: v.to(device) for k, v in shard_state(opt["mu"], shards).items()},
                {k: v.to(device) for k, v in shard_state(opt["nu"], shards).items()}))
    state.step = saved["step"]
    state.generator.set_state(saved["generator"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = Path(directory).absolute()
        if host_id() == 0:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, state: Any, *, config_json: Optional[str] = None,
             history: Optional[dict] = None):
        """Write ``step`` (rank 0, after every rank took part in gathering
        the state whole; every rank waits for it)."""
        saved = state_dict(state)
        if host_id() == 0:
            self._save(step, saved, config_json, history)
        barrier()

    def _save(self, step: int, saved: dict, config_json: Optional[str],
              history: Optional[dict]):
        tmp = Path(tempfile.mkdtemp(prefix=f".{step}-", dir=self.directory))
        try:
            torch.save(saved, tmp / _FILE)
            final = self.directory / str(step)
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if config_json is not None:
            _write_text(self.directory / "config.json", config_json)
        if history is not None:
            _write_text(self.directory / "history.json",
                        json.dumps(history, default=float))
        for old in self.all_steps()[:-self.keep] if self.keep else []:
            shutil.rmtree(self.directory / str(old))

    def all_steps(self):
        """The saved steps, oldest first."""
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit() and (p / _FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: Optional[int]) -> Path:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return self.directory / str(step) / _FILE

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Load the step (default: the latest) into ``state_template`` in
        place and return it."""
        return load_state_dict(state_template, self.restore_raw(step))

    def restore_raw(self, step: Optional[int] = None) -> dict:
        """The saved dict (:func:`state_dict`'s layout) on the CPU, no
        template needed; used for the cross-stage handoff."""
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def load_history(self) -> dict:
        p = self.directory / "history.json"
        if p.exists():
            return json.loads(p.read_text())
        return {}


def load_ae_modules(directory: str, enc, dec, step: Optional[int] = None):
    """Load the frozen stage-1 encoder and decoder for stage 2 (reference:
    train_FAR.py:210) from a stage-1 checkpoint (``directory`` is the
    stage-1 ``<ckpt_dir>/ckpt``) into ``enc`` and ``dec``, in place;
    returns them. A checkpoint of another kind or of another autoencoder
    configuration raises."""
    saved = CheckpointManager(directory).restore_raw(step)
    if saved["kind"] != AETrainState.__name__:
        raise ValueError(f"{directory} holds a {saved['kind']} checkpoint, "
                         f"not a stage-1 ({AETrainState.__name__}) one")
    enc.load_state_dict(saved["enc"])
    dec.load_state_dict(saved["dec"])
    return enc, dec
