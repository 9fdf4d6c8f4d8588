"""The port's Trainer, checkpoints, evaluate, weight conversions, command
line and dry run on a (1, 2) mesh (tensor parallelism with
``sequence_parallel``) of gloo ranks on the CPU
(``tests/_torch_port_mp_worker.py``'s ``tp_trainer`` job, spawned once for
the module), against one process.

(a) the mesh's first epoch (2 steps of far_mnist cut to the TINY geometry,
    dropout and DropPath 0.1) against one process's: the whole state
    (parameters, optimizer moments, generator) and the history;
(b) its checkpoint (written whole, in the one-process layout) resumed in
    one process with ``mesh.model`` 1, and a one-process checkpoint resumed
    on the mesh: either second epoch against the unbroken one-process run;
(c) ``evaluate`` on the mesh against one process's;
(d) ``export_jax_variables`` / ``load_jax_variables`` of a sharded
    transformer, unrolled and with ``scan_layers``: the whole JAX tree
    back, bit for bit, from the ranks' shares;
(e) ``torchrun --nproc_per_node=2 -m vptr_tpu_torch.cli train --set
    mesh.model=2 --set transformer.sequence_parallel=true --device cpu``,
    then its run resumed by one process's ``cli train``;
(f) ``python -m vptr_tpu_torch.parallel.dryrun --ranks 4 --device cpu``.

Tolerances: the mesh's sums run in another order (the model ranks'
partial products), so the states agree to rounding: the parameters within
2e-5 a step (AdamW moves an element whose gradient is rounding noise by up
to lr / 5 a step, lr 1e-4), the moments and metrics within 1e-5 relative.
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
import vptr_tpu_torch.train.trainer as ttrainer
from vptr_tpu_torch.data.loader import build_loader
from vptr_tpu_torch.eval.harness import evaluate

from _torch_port_mp_worker import EVAL_BATCHES, REPO, TP_TRAINER, Launch, short_val, whole_state
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

STEP_PARAM_TOL, REL_TOL = 2e-5, 1e-5
TIMING = ("steps_per_sec", "transformer_tflops_per_sec")


def _cfg(run_dir, model=1):
    return tcfg.get_preset("far_mnist").override(TP_TRAINER).override(
        {"ckpt_dir": str(run_dir), "mesh": {"model": model}})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the two ranks' results, the one-process first epoch's state, the
    unbroken one-process run's state and its trainer, the directory)."""
    out = tmp_path_factory.mktemp("tp_trainer")
    short_val(ttrainer)
    one = ttrainer.Trainer(_cfg(out / "run" / "c"), device="cpu")
    first = whole_state(one.train(epochs=1))       # the checkpoint the mesh resumes
    launch = Launch("tp_trainer", out)
    try:
        unbroken = ttrainer.Trainer(_cfg(out / "run" / "a"), device="cpu")
        want = unbroken.train()
        yield launch.results(), first, whole_state(want), (unbroken, want), out
    finally:
        for p in launch.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _states_close(got, want, steps):
    (g, gs), (w, ws) = got, want
    assert gs == ws
    assert g.keys() == w.keys()
    for name, t in w.items():
        if name == "generator":
            assert torch.equal(g[name], t)
            continue
        a, b = g[name].double(), t.double()
        if name.startswith("transformer.") and not name.endswith(("running_mean",
                                                                  "running_var")):
            tol = STEP_PARAM_TOL * steps
        else:
            tol = REL_TOL * max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        assert err <= tol, f"{name}: max |err| {err:.3e} > {tol:.3e}"


def _histories_close(got, want):
    for split in ("train", "val"):
        assert got[split].keys() == want[split].keys()
        for key, rows in want[split].items():
            if key in TIMING:
                continue
            for (sa, va), (sb, vb) in zip(got[split][key], rows):
                assert sa == sb and abs(va - vb) <= REL_TOL * max(1.0, abs(vb)), (split, key)


def test_tp_first_epoch_matches_one_process(ranks):
    """(a)"""
    results, first, _, _, _ = ranks
    for r in results:
        _states_close(r["first"], first, 2)
    assert torch.equal(results[0]["first"][0]["transformer.block0.ffn.linear1.weight"],
                       results[1]["first"][0]["transformer.block0.ffn.linear1.weight"])


def test_tp_checkpoint_resumes_in_one_process(ranks):
    """(b) a mesh.model = 2 checkpoint, whole, resumed by one process."""
    results, _, want, _, out = ranks
    state = torch.load(out / "run" / "b" / "ckpt" / "2" / "state.pt", weights_only=True)
    assert state["transformer"]["block0.slmhsa.attn.q_proj.weight"].shape == (24, 24)
    resumed = ttrainer.Trainer(_cfg(out / "run" / "b"), device="cpu", write_outputs=True)
    got = resumed.train(epochs=1)
    _states_close(whole_state(got), want, 4)
    _histories_close(resumed.history, results[0]["resumed_history"])


def test_one_process_checkpoint_resumes_on_the_mesh(ranks):
    """(b) the other way round."""
    results, _, want, (unbroken, _), _ = ranks
    for r in results:
        _states_close(r["resumed"], want, 4)
        _histories_close(r["resumed_history"], unbroken.history)


def test_evaluate_on_the_mesh(ranks):
    """(c)"""
    results, _, _, (unbroken, state), _ = ranks
    cfg = unbroken.cfg
    batches = list(islice(build_loader(cfg.data, split="test", seed=cfg.seed), EVAL_BATCHES))
    want = evaluate(unbroken, state, batches, mode="far", num_pred=2)
    for r in results:
        for m, c in want.items():
            np.testing.assert_allclose(r["curves"][m], c, rtol=1e-4, atol=1e-6, err_msg=m)


def test_jax_round_trip_of_a_sharded_transformer(ranks):
    """(d)"""
    for r in ranks[0]:
        for scan, trip in r["round_trip"].items():
            assert trip["same_leaves"] and trip["equal"], scan
            assert trip["sharded_params"] > 0 and trip["local_q"] == (12, 24), trip


def _sets(**more):
    flat = {"dtype": "float32", "ae.ngf": 8, "ae.feat_dim": 24, "ae.n_res_blocks": 1,
            "ae.n_downsampling": 2, "transformer.d_model": 24, "transformer.n_heads": 4,
            "transformer.num_encoder_layers": 2, "transformer.num_past_frames": 2,
            "transformer.num_future_frames": 2, "data.batch_size": 4, "data.img_size": 32,
            "data.num_past_frames": 2, "data.num_future_frames": 2,
            "data.test_past_frames": 2, "data.test_future_frames": 2,
            "data.num_workers": 1, "steps_per_epoch": 2, "val_per_epochs": 2, **more}
    return [a for k, v in flat.items() for a in ("--set", f"{k}={v}")]


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join([str(REPO)] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH") else []))}


def test_torchrun_cli_train_on_the_mesh_resumed_in_one_process(tmp_path):
    """(e)"""
    common = ["train", "--device", "cpu", "--preset", "far_mnist", "--ckpt-dir", str(tmp_path)]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "vptr_tpu_torch.cli"]
    tp = subprocess.run(run + common + _sets(**{"epochs": 1, "mesh.model": 2,
                                                "transformer.sequence_parallel": "true"}),
                        env=_env(), cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert tp.returncode == 0, (tp.stdout + tp.stderr)[-4000:]
    assert (tmp_path / "ckpt" / "2" / "state.pt").is_file()
    assert "tensor parallel over 2 model ranks" in (tmp_path / "train_log.log").read_text()
    one = subprocess.run([sys.executable, "-m", "vptr_tpu_torch.cli"] + common
                         + _sets(epochs=1), env=_env(), cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert one.returncode == 0, (one.stdout + one.stderr)[-4000:]
    assert (tmp_path / "ckpt" / "4" / "state.pt").is_file()
    log = (tmp_path / "train_log.log").read_text()
    assert "resumed from step 2" in log
    hist = json.loads((tmp_path / "ckpt" / "history.json").read_text())
    assert all(np.isfinite(v) for rows in hist["train"].values() for _, v in rows)


def test_dryrun_four_ranks_on_the_cpu():
    """(f)"""
    out = subprocess.run([sys.executable, "-m", "vptr_tpu_torch.parallel.dryrun", "--ranks",
                          "4", "--device", "cpu"], env=_env(), cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    for preset in ("ae_mnist", "far_mnist", "nar_mnist"):
        line = next(x for x in out.stdout.splitlines()
                    if x.startswith(f"dryrun_multichip {preset} ok:"))
        assert '"data": 2, "model": 2' in line and "FAILED" not in line, line
