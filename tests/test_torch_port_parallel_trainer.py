"""The port's Trainer, evaluate and command line at W = 2 gloo ranks, on the
CPU (``tests/_torch_port_mp_worker.py``'s ``trainer`` job, spawned once for
the module).

(e) ``Trainer.train`` at W = 2, far_mnist cut to the TINY geometry (d_model
    24, 4 heads, 2 layers, 2 + 2 frames of 32 x 32, global batch 8) with
    dropout and DropPath 0.1, 2 epochs of 2 steps: only rank 0 writes
    under the run directory (an audit hook records every rank's opens for
    writing, directories made, renames and removals); the histories are
    equal on both ranks, timings included, as are the states ``train()``
    returns; the run cut after its first epoch and resumed is bit-equal to
    the unbroken one (parameters, optimizer moments, generator, steps; the
    history but its timings); a ragged ``put_batch`` raises; ``evaluate``'s
    curves on both ranks equal the one-process ``evaluate`` over the two
    ranks' shards of the test split (f64 sums in another order: 1e-12
    relative);
(f) the refusals at W = 2: ``mesh.model`` 2, an explicit ``mesh.data`` of
    3, a ``batch_size`` of 7, and ``cli predict``;
(g) ``torchrun --nproc_per_node=2 -m vptr_tpu_torch.cli train --device
    cpu`` at the TINY size ends with exit code 0, rank 0's checkpoint and a
    finite history; ``cli eval`` on two ranks prints its curves once.
"""

import json
import os
import subprocess
import sys
from itertools import islice

import numpy as np
import pytest
import torch

import vptr_tpu_torch.config as tcfg
from vptr_tpu_torch.data.loader import build_loader
from vptr_tpu_torch.eval.harness import evaluate
from vptr_tpu_torch.train.checkpoint import CheckpointManager
from vptr_tpu_torch.train.trainer import Trainer

from _torch_port_mp_worker import EVAL_BATCHES, REPO, TRAINER, Launch
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TIMING = ("steps_per_sec", "transformer_tflops_per_sec")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results of the trainer job, and its directory."""
    out = tmp_path_factory.mktemp("dp_trainer")
    launch = Launch("trainer", out)
    try:
        yield launch.results(), out
    finally:
        for p in launch.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_only_rank0_writes(ranks):
    (r0, r1), out = ranks
    assert r0["write_outputs"] is True and r1["write_outputs"] is False
    assert r1["writes"] == []
    written = {os.path.relpath(p, out / "run") for p in r0["writes"]}
    for want in ("a/train_log.log", "a/tb/scalars.jsonl", "a/ckpt/history.json.tmp",
                 "b/ckpt/history.json.tmp"):
        assert want in written, (want, sorted(written))
    assert (out / "run" / "a" / "ckpt" / "4" / "state.pt").is_file()
    assert (out / "run" / "a" / "val_gifs_epoch2").is_dir()


def test_histories_and_states_equal_across_ranks(ranks):
    (r0, r1), _ = ranks
    assert r0["history"] == r1["history"]
    assert r0["history"]["val"]["T_total"][0][0] == 2
    (a0, s0), (a1, s1) = r0["unbroken"], r1["unbroken"]
    assert s0 == s1 == (4, 4)
    for name, t in a0.items():
        assert torch.equal(t, a1[name]), name


def test_resume_at_two_ranks_is_bit_equal(ranks):
    (r0, r1), _ = ranks
    for r in (r0, r1):
        (want, ws), (got, gs) = r["unbroken"], r["resumed"]
        assert gs == ws == (4, 4)
        for name, t in want.items():
            assert torch.equal(got[name], t), name
        for split in ("train", "val"):
            for key, rows in r["history"][split].items():
                if key not in TIMING:
                    assert r["resumed_history"][split][key] == rows, (split, key)


def test_ragged_put_batch_raises(ranks):
    (r0, r1), _ = ranks
    for r in (r0, r1):
        assert r["ragged"] is not None and "ragged batch of 3 rows" in r["ragged"]


def test_evaluate_matches_one_process_over_the_shards(ranks):
    (r0, r1), out = ranks
    cfg = tcfg.get_preset("far_mnist").override(TRAINER)
    one = Trainer(cfg, device="cpu", write_outputs=False)
    state = CheckpointManager(str(out / "run" / "a" / "ckpt")).restore(one.init_state())
    batches = [b for host in (0, 1) for b in islice(build_loader(
        cfg.data, split="test", seed=cfg.seed, host_id=host, num_hosts=2), EVAL_BATCHES)]
    want = evaluate(one, state, batches, mode="far", num_pred=2)
    for r in (r0, r1):
        assert r["curves"].keys() == want.keys()
        for m, c in want.items():
            np.testing.assert_allclose(r["curves"][m], c, rtol=1e-12, atol=0, err_msg=m)


@pytest.mark.parametrize("what,match", [
    # a tensor-parallel (TP/SP slice) refusal: heads that do not split over the model ranks
    pytest.param("refuse_model", "does not split over mesh.model",
                 id="refuse_model-TP/SP slice"),
    ("refuse_data", "process group has 2 rank"),
    ("refuse_batch", "does not split over 2 ranks"),
    ("refuse_predict", "predict runs in one process")])
def test_refusals_at_two_ranks(ranks, what, match):
    for r in ranks[0]:
        assert r[what] is not None and match in r[what], (what, r[what])


def _sets(**more):
    flat = {"dtype": "float32", "ae.ngf": 8, "ae.feat_dim": 24, "ae.n_res_blocks": 1,
            "ae.n_downsampling": 2, "transformer.d_model": 24, "transformer.n_heads": 4,
            "transformer.num_encoder_layers": 2, "transformer.num_past_frames": 2,
            "transformer.num_future_frames": 2, "data.batch_size": 8, "data.img_size": 32,
            "data.num_past_frames": 2, "data.num_future_frames": 2,
            "data.test_past_frames": 2, "data.test_future_frames": 2,
            "data.num_workers": 1, "epochs": 1, "steps_per_epoch": 2,
            "val_per_epochs": 2, **more}
    return [a for k, v in flat.items() for a in ("--set", f"{k}={v}")]


def test_torchrun_cli_train_and_eval(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO)] + ([os.environ["PYTHONPATH"]]
                                         if os.environ.get("PYTHONPATH") else []))}
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "vptr_tpu_torch.cli"]
    common = ["--device", "cpu", "--preset", "far_mnist", "--ckpt-dir", str(tmp_path)]
    train = subprocess.run(run + ["train", *common, *_sets()], env=env, cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, (train.stdout + train.stderr)[-4000:]
    assert (tmp_path / "ckpt" / "2" / "state.pt").is_file()
    hist = json.loads((tmp_path / "ckpt" / "history.json").read_text())
    assert all(np.isfinite(v) for rows in hist["train"].values() for _, v in rows)
    ev = subprocess.run(run + ["eval", *common, "--max-batches", "1", "--no-lpips",
                               *_sets()], env=env, cwd=tmp_path, capture_output=True,
                        text=True, timeout=300)
    assert ev.returncode == 0, (ev.stdout + ev.stderr)[-4000:]
    assert ev.stdout.count('"mean"') == 1, ev.stdout[-4000:]   # rank 0 prints
    curves = json.loads(ev.stdout[ev.stdout.index("{"):ev.stdout.rindex("}") + 1])
    assert all(np.isfinite(curves["mean"][m]) for m in ("psnr", "ssim", "mse"))
