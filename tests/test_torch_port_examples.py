"""The port's examples (``examples/test_vptr_torch.py``,
``examples/test_autoencoder_torch.py``) on the CPU, against the JAX
package on the same weights.

Checkpoints come from ``python -m vptr_tpu_torch.cli train --device cpu``
(two steps on the synthetic loader at ``tests/test_cli.py``'s TINY_SETS,
``tests/test_torch_port_cli.py``'s LOOP), written once for the module:
stage 1 (ae_mnist) and stage 2 (far_mnist, nar_mnist); and nar_mnist's
seeded init saved as step 0 by its Trainer. The port's restored modules
are carried to the JAX package with ``export_jax_variables``.

At this geometry nar_mnist's first step has a non-finite gradient in
both packages (the NCE head's projection of a token is exactly 0, and the
L2 normalisation's sqrt has an infinite derivative there: 0 x inf), so
the 2-step checkpoint holds NaN weights and both packages' nar curves are
NaN: they are held to each other NaN for NaN, and the seeded init's
checkpoint gives the finite comparison.

* ``test_vptr_torch.py`` in modes far, far_rip, far_ril (far_mnist) and
  nar (nar_mnist, both checkpoints): the curves its ``main`` returns and
  prints against ``vptr_tpu.eval.harness.evaluate`` over the same test
  loader, 1e-4 relative (as ``tests/test_torch_port_eval.py``);
  ``--gif-dir`` writes the GIFs; ``--lpips`` without weights on disk says
  so and runs without;
* ``test_autoencoder_torch.py``: the reconstruction PSNR / SSIM against
  the JAX autoencoder's apply in eval mode and ``vptr_tpu.eval.metrics``,
  1e-4 relative; ``--out`` writes the strip;
* both refuse to run without ``--device cpu`` where there is no GPU.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vptr_tpu.eval.harness as jharness
import vptr_tpu.eval.metrics as jm
from vptr_tpu.cli import _apply_sets as japply_sets
from vptr_tpu.config import get_preset as jget_preset
from vptr_tpu.data.loader import build_loader as jbuild_loader
from vptr_tpu.train.state import ModuleState
from vptr_tpu.train.trainer import Trainer as JTrainer
from vptr_tpu_torch.cli import _apply_sets as tapply_sets
from vptr_tpu_torch.cli import main as cli_main
from vptr_tpu_torch.config import get_preset as tget_preset
from vptr_tpu_torch.train.checkpoint import CheckpointManager
from vptr_tpu_torch.train.trainer import Trainer
from vptr_tpu_torch.utils.weights import export_jax_variables

from test_cli import TINY_SETS
from test_torch_port_cli import LOOP
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
RTOL = 1e-4
HAVE_PIL = importlib.util.find_spec("PIL") is not None


def _example(name):
    spec = importlib.util.spec_from_file_location(f"_port_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# run -> (preset, its checkpoint's step)
RUNS = {"ae_mnist": ("ae_mnist", 2), "far_mnist": ("far_mnist", 2),
        "nar_mnist": ("nar_mnist", 2), "nar_mnist_init": ("nar_mnist", 0)}


def _cfgs(preset, run):
    """(the port's config, the JAX package's) of ``preset`` at TINY_SETS."""
    sets = TINY_SETS[1::2]                  # the key=value strings of "--set" pairs
    return (tapply_sets(tget_preset(preset).override({"ckpt_dir": str(run)}), sets),
            japply_sets(jget_preset(preset).override({"ckpt_dir": str(run)}), sets))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{run: its directory}: two cli train steps a preset, and nar_mnist's
    seeded init saved as step 0."""
    root = tmp_path_factory.mktemp("example_ckpts")
    runs = {name: root / name for name in RUNS}
    for name, (preset, step) in RUNS.items():
        if step:
            cli_main(["train", "--preset", preset, "--ckpt-dir", str(runs[name]),
                      "--device", "cpu", *TINY_SETS, *LOOP])
        else:
            trainer = Trainer(_cfgs(preset, runs[name])[0], device="cpu", write_outputs=False)
            CheckpointManager(f"{runs[name]}/ckpt").save(0, trainer.init_state())
        assert (runs[name] / "ckpt" / str(step) / "state.pt").is_file()
    return runs


def _restored(name, run):
    """The port's Trainer (CPU) and its state restored from ``run``, and
    the JAX Trainer of the same configuration."""
    preset, step = RUNS[name]
    tcfg, jcfg = _cfgs(preset, run)
    tt = Trainer(tcfg, device="cpu", write_outputs=False)
    state = CheckpointManager(f"{run}/ckpt").restore(tt.init_state())
    assert state.step == step
    return tt, state, JTrainer(jcfg, write_outputs=False)


def _jax_state(state, names):
    """A JAX state of the port state's modules ``names`` (ModuleState each)."""
    return type("S", (), {n: ModuleState.from_variables(export_jax_variables(
        getattr(state, n))) for n in names})


@pytest.mark.parametrize("name,mode", [("far_mnist", "far"), ("far_mnist", "far_rip"),
                                       ("far_mnist", "far_ril"), ("nar_mnist", "nar"),
                                       ("nar_mnist_init", "nar")])
def test_vptr_example_matches_jax(ckpts, capsys, name, mode):
    run, preset = ckpts[name], RUNS[name][0]
    got = _example("test_vptr_torch").main(
        ["--preset", preset, "--ckpt-dir", str(run), "--mode", mode, "--max-batches", "2",
         "--device", "cpu", *TINY_SETS])
    printed = capsys.readouterr().out.splitlines()
    assert set(got) == {"psnr", "ssim", "mse"}
    for m, c in got.items():
        line = next(x for x in printed if x.startswith(f"{m:6s} per-timestep:"))
        assert line == (f"{m:6s} per-timestep: " + " ".join(f"{v:.4f}" for v in c)
                        + f" | mean {np.mean(c):.4f}")
        assert c.shape == (2,)
        assert name == "nar_mnist" or np.isfinite(c).all()   # (the module notes)

    _, state, jt = _restored(name, run)
    want = jharness.evaluate(jt, _jax_state(state, ("enc", "dec", "transformer")),
                             jbuild_loader(jt.cfg.data, split="test", seed=jt.cfg.seed),
                             mode=mode, num_pred=2, max_batches=2)
    assert set(want) == set(got)
    for m in want:
        np.testing.assert_allclose(got[m], want[m], rtol=RTOL, err_msg=f"{mode} {m}")


def test_vptr_example_gifs_and_lpips(ckpts, capsys, tmp_path, monkeypatch):
    """``--gif-dir`` writes a GIF a clip of the first batch (2); ``--lpips``
    without weights on disk says so and gives the curves without LPIPS."""
    monkeypatch.setenv("VPTR_LPIPS_WEIGHTS", str(tmp_path / "no_weights.npz"))
    gifs = tmp_path / "gifs"
    got = _example("test_vptr_torch").main(
        ["--preset", "far_mnist", "--ckpt-dir", str(ckpts["far_mnist"]), "--mode", "far_rip",
         "--max-batches", "1", "--lpips", "--gif-dir", str(gifs), "--device", "cpu",
         *TINY_SETS])
    out = capsys.readouterr().out
    assert "no LPIPS weights" in out and "lpips" not in got
    if HAVE_PIL:
        assert sorted(p.name for p in gifs.glob("*.gif")) == [
            "pred_far_rip_0.gif", "pred_far_rip_1.gif"]
        assert "wrote GIFs to" in out
    else:
        assert "PIL does not import" in out


def test_autoencoder_example_matches_jax(ckpts, capsys, tmp_path):
    run, png = ckpts["ae_mnist"], tmp_path / "recon.png"
    got = _example("test_autoencoder_torch").main(
        ["--preset", "ae_mnist", "--ckpt-dir", str(run), "--out", str(png), "--device", "cpu",
         *TINY_SETS])
    out = capsys.readouterr().out
    assert f"reconstruction PSNR: {got['psnr']}" in out
    assert f"reconstruction SSIM: {got['ssim']}" in out
    assert png.is_file() == HAVE_PIL

    _, state, jt = _restored("ae_mnist", run)
    loader = jbuild_loader(jt.cfg.data, split="test", seed=jt.cfg.seed)
    past, future = next(iter(loader))
    x = np.concatenate([past, future], axis=1)[:, :20]
    ev, dv = (export_jax_variables(getattr(state, n)) for n in ("enc", "dec"))
    feats = jt.enc.apply(ev, jnp.asarray(x), train=False)
    rec = np.asarray(jt.dec.apply(dv, feats, train=False), np.float32)
    flat = lambda a: jnp.asarray(np.clip(jt.renorm(a), 0, 1).reshape((-1,) + a.shape[2:]))
    want = {"psnr": float(jm.psnr(flat(rec), flat(x))), "ssim": float(jm.ssim(flat(rec),
                                                                               flat(x)))}
    for m in want:
        np.testing.assert_allclose(got[m], want[m], rtol=RTOL, err_msg=m)


@pytest.mark.parametrize("name", ["test_vptr_torch", "test_autoencoder_torch"])
def test_examples_run_on_the_card_by_default(ckpts, name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is here: the default runs on it")
    preset = "far_mnist" if name == "test_vptr_torch" else "ae_mnist"
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        _example(name).main(["--preset", preset, "--ckpt-dir", str(ckpts[preset]),
                             *TINY_SETS])
