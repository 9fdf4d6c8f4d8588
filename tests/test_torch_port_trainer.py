"""The port's Trainer against the JAX package's, and its checkpoints.

* ``Trainer.train`` on SMALL far_mnist (f32, dropout and DropPath 0, one
  epoch of 2 steps and a validation pass) and on a small ae_mnist with the
  GAN term, from JAX's initial variables: every train and val history value
  the JAX trainer records agrees to 1e-4 relative (the port adds
  ``grad_norm``); far_mnist also with ``dtype = "float16"`` in both
  packages, to 2^-8 relative (measured 1.1e-3 on T_GDL: f16's 10 mantissa
  bits through two steps and the decoder);
* resume: two epochs in one run against one epoch, then one more resumed
  from its checkpoint, with dropout 0.1 on: parameters, optimizer states,
  the generator, the steps and the history (timings aside) bit-equal;
* a stage-1 checkpoint (the discriminator, BatchNorm statistics, both
  optimizer states) restores bit for bit, into a stage-1 state only;
* the stage-1 -> stage-2 handoff through ``ae_ckpt``; the
  ``ckpt_per_epochs`` cadence and ``keep``; one card only; the loop's
  options (``steps_per_dispatch``, ``debug_nans``, ``profile_dir``).

The validation split is cut to 4 clips in both packages (the loader is the
JAX package's, batch for batch: tests/test_torch_port_data.py).
"""

import numpy as np
import pytest
import torch

import vptr_tpu.config as jcfg
import vptr_tpu.train.trainer as jtrainer
import vptr_tpu_torch.config as tcfg
import vptr_tpu_torch.train.trainer as ttrainer
from vptr_tpu_torch.train.checkpoint import CheckpointManager
from vptr_tpu_torch.utils.weights import load_jax_variables

from _torch_port_util import SMALL, to_numpy
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TIMING = ("steps_per_sec", "transformer_tflops_per_sec")
LOOP = {"epochs": 1, "steps_per_epoch": 2, "val_per_epochs": 1,
        "mesh": {"data": 1, "model": 1}}
FAR = {**SMALL, **LOOP, "transformer": {**SMALL["transformer"], "dropout": 0.0,
                                        "drop_path": 0.0}}
FAR16 = {**FAR, "dtype": "float16"}
AE = {"dtype": "float32", **LOOP,
      "ae": {"ngf": 8, "feat_dim": 16, "n_res_blocks": 1}, "disc": {"ndf": 8},
      "data": {"batch_size": 2, "num_past_frames": 2, "num_future_frames": 2}}


@pytest.fixture(autouse=True)
def short_val(monkeypatch):
    """Both trainers' validation split cut to 4 clips."""
    for mod in (jtrainer, ttrainer):
        build = mod.build_loader

        def wrapped(cfg, *, split="train", _build=build, **kw):
            loader = _build(cfg, split=split, **kw)
            if split == "val":
                loader.dataset.num_clips = 4
            return loader
        monkeypatch.setattr(mod, "build_loader", wrapped)


def _port_from_jax(jstate, tt):
    """The port trainer's state over the JAX state's initial variables."""
    for name in ("enc", "dec", "transformer", "disc"):
        module = getattr(tt, name, None)
        if module is not None:
            load_jax_variables(module, to_numpy(getattr(jstate, name).variables()))
    return tt.init_state()


def _check_history(got, want, rtol=1e-4):
    for split in ("train", "val"):
        assert set(want[split]) <= set(got[split])
        assert set(got[split]) - set(want[split]) <= {"grad_norm"}
        for key, rows in want[split].items():
            if key in TIMING:
                continue
            g = np.array(got[split][key])
            w = np.array(rows, np.float64)
            np.testing.assert_array_equal(g[:, 0], w[:, 0])
            np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=rtol, atol=1e-7,
                                       err_msg=f"{split} {key}")


@pytest.mark.parametrize("preset,over", [("far_mnist", FAR), ("ae_mnist", AE),
                                         ("far_mnist", FAR16)])
def test_train_matches_jax(preset, over):
    jc = jcfg.get_preset(preset).override(over)
    tc = tcfg.get_preset(preset).override(over)
    jt = jtrainer.Trainer(jc, write_outputs=False)
    jstate = jt.init_state()
    tt = ttrainer.Trainer(tc, device="cpu", write_outputs=False)
    tstate = _port_from_jax(jstate, tt)
    jt.train(jstate)
    tstate = tt.train(tstate)
    assert tstate.step == 2
    assert tt.dtype == ttrainer._dtype_of(over["dtype"])
    _check_history(tt.history, jt.history, 1e-4 if over["dtype"] == "float32" else 2 ** -8)
    if preset == "ae_mnist":
        assert tt.history["train"]["Dtotal"][0][1] > 0


def _state_arrays(state):
    """Every tensor of a stage-2 state, by name, and its step and count."""
    out = {f"transformer.{k}": v for k, v in state.transformer.state_dict().items()}
    out.update({f"mu.{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.opt_state.nu.items()})
    out["generator"] = state.generator.get_state()
    return out, (state.step, state.opt_state.count)


def test_resume_is_bit_equal(tmp_path):
    over = {**SMALL, **LOOP, "ckpt_dir": str(tmp_path / "a")}   # dropout 0.1
    cfg = tcfg.get_preset("far_mnist").override(over)
    assert cfg.transformer.dropout == 0.1 and cfg.transformer.drop_path == 0.1
    unbroken = ttrainer.Trainer(cfg.override({"epochs": 2}), device="cpu")
    want = unbroken.train()
    first = ttrainer.Trainer(cfg.override({"ckpt_dir": str(tmp_path / "b")}),
                             device="cpu")
    first.train()
    resumed = ttrainer.Trainer(cfg.override({"ckpt_dir": str(tmp_path / "b")}),
                               device="cpu")
    got = resumed.train()
    (ga, gs), (wa, ws) = _state_arrays(got), _state_arrays(want)
    assert gs == ws == (4, 4)
    assert set(ga) == set(wa)
    for k in wa:
        assert ga[k].dtype == wa[k].dtype and torch.equal(ga[k], wa[k]), k
    for split in ("train", "val"):
        for key, rows in unbroken.history[split].items():
            if key not in TIMING:
                assert resumed.history[split][key] == rows, (split, key)
    assert resumed.history["epoch"] == unbroken.history["epoch"] == 2
    assert CheckpointManager(str(tmp_path / "b" / "ckpt")).all_steps() == [2, 4]


def test_stage1_checkpoint_round_trip(tmp_path):
    cfg = tcfg.get_preset("ae_mnist").override(
        {**AE, "ckpt_dir": str(tmp_path), "steps_per_epoch": 1, "val_per_epochs": 9})
    saved = ttrainer.Trainer(cfg, device="cpu").train()
    fresh = ttrainer.Trainer(cfg, device="cpu", write_outputs=False)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    got = mgr.restore(fresh.init_state())
    assert got.step == saved.step == 1
    assert torch.equal(got.generator.get_state(), saved.generator.get_state())
    for name in ("enc", "dec", "disc"):
        want = getattr(saved, name).state_dict()
        have = getattr(got, name).state_dict()
        assert any("running_var" in k for k in want)
        assert all(torch.equal(have[k], want[k]) for k in want), name
    for name in ("g_opt_state", "d_opt_state"):
        a, b = getattr(got, name), getattr(saved, name)
        assert a.count == b.count == 1
        for k in b.mu:
            assert a.mu[k].dtype == b.mu[k].dtype and torch.equal(a.mu[k], b.mu[k])
            assert torch.equal(a.nu[k], b.nu[k])
    far = ttrainer.Trainer(tcfg.get_preset("far_mnist").override(FAR), device="cpu",
                           write_outputs=False)
    with pytest.raises(ValueError, match="AETrainState checkpoint cannot restore"):
        mgr.restore(far.init_state())


def test_stage1_to_stage2_handoff(tmp_path):
    ae = tcfg.get_preset("ae_mnist").override(
        {**AE, "ckpt_dir": str(tmp_path / "ae"), "steps_per_epoch": 1,
         "val_per_epochs": 9})
    ae_state = ttrainer.Trainer(ae, device="cpu").train()
    far = tcfg.get_preset("far_mnist").override(
        {**FAR, "ae": AE["ae"], "data": AE["data"], "steps_per_epoch": 1,
         "val_per_epochs": 9, "ae_ckpt": str(tmp_path / "ae" / "ckpt"),
         "transformer": {**FAR["transformer"], "d_model": 16,
                         "num_past_frames": 2, "num_future_frames": 2}})
    tt = ttrainer.Trainer(far, device="cpu", write_outputs=False)
    state = tt.init_state()
    for name in ("enc", "dec"):
        want = getattr(ae_state, name).state_dict()
        got = getattr(state, name).state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want), name
    state = tt.train(state)
    assert np.isfinite(tt.history["train"]["T_total"][0][1])
    bad = far.override({"ae": {"feat_dim": 24}, "transformer": {"d_model": 24}})
    with pytest.raises(RuntimeError, match="size mismatch"):
        ttrainer.Trainer(bad, device="cpu", write_outputs=False).init_state()


@pytest.mark.parametrize("per,keep,want", [(2, 3, [2, 3]), (1, 1, [3])])
def test_checkpoint_cadence_and_keep(tmp_path, per, keep, want):
    cfg = tcfg.get_preset("ae_mnist").override(
        {**AE, "epochs": 3, "steps_per_epoch": 1, "val_per_epochs": 99,
         "ckpt_per_epochs": per, "ckpt_keep": keep, "ckpt_dir": str(tmp_path)})
    ttrainer.Trainer(cfg, device="cpu").train()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.all_steps() == want
    assert mgr.load_history()["epoch"] == 3
    assert (tmp_path / "train_log.log").is_file()
    assert (tmp_path / "tb" / "scalars.jsonl").is_file()
    assert not [p for p in (tmp_path / "ckpt").iterdir() if p.name.startswith(".")]


@pytest.mark.parametrize("mesh", [{"model": 2}, {"data": 2}])
def test_one_card_only(mesh):
    """In one process the mesh is one card: a model axis is refused (the
    TP/SP slice is not ported) and an explicit data axis must equal the
    world, here 1."""
    cfg = tcfg.get_preset("far_mnist").override({**FAR, "mesh": mesh})
    error, match = ((NotImplementedError, "TP/SP slice") if "model" in mesh
                    else (ValueError, "process group has 1 rank"))
    with pytest.raises(error, match=match):
        ttrainer.Trainer(cfg, device="cpu", write_outputs=False)


def test_loop_options(tmp_path):
    """``steps_per_dispatch`` 3, ``debug_nans`` (anomaly mode) and a
    ``profile_dir`` trace leave the history as it is without them; the
    trace holds the loop's spans."""
    base = tcfg.get_preset("ae_mnist").override(
        {**AE, "steps_per_epoch": 4, "val_per_epochs": 9})
    plain = ttrainer.Trainer(base, device="cpu", write_outputs=False)
    plain.train()
    other = ttrainer.Trainer(base.override(
        {"steps_per_dispatch": 3, "debug_nans": True, "profile_dir": str(tmp_path),
         "profile_steps": 1}), device="cpu", write_outputs=False)
    other.train()
    for key, rows in plain.history["train"].items():
        if key not in TIMING:
            assert other.history["train"][key] == rows, key
    assert (tmp_path / "trace.json").is_file()
    names = {e.name for e in other.profiler.events()}
    assert {"trainer.loader_wait", "trainer.put_batch", "trainer.step"} <= names
