"""``python -m vptr_tpu_torch.cli``: presets and info print what the JAX
package's CLI prints; train -> train again (resumed) -> eval -> predict on
the CPU (``--device cpu``) at the JAX CLI tests' tiny geometry."""

import json
import logging

import numpy as np
import pytest

from vptr_tpu.cli import main as jmain
from vptr_tpu_torch.cli import main

from test_cli import TINY_SETS
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

LOOP = ["--set", "epochs=1", "--set", "steps_per_epoch=2", "--set", "val_per_epochs=1"]


@pytest.mark.parametrize("argv", [
    ["presets"],
    ["info", "--preset", "far_mnist", "--set", "epochs=3"],
    ["info", "--preset", "nar_bair", "--ckpt-dir", "/tmp/x", *TINY_SETS],
])
def test_output_matches_jax(argv, capsys):
    jmain(argv)
    want = capsys.readouterr().out
    main(argv)
    got = capsys.readouterr().out
    assert got == want and got.strip()


def test_unknown_key_and_bad_set():
    with pytest.raises(KeyError):
        main(["info", "--preset", "far_mnist", "--set", "no.such_key=1"])
    with pytest.raises(SystemExit):
        main(["info", "--preset", "far_mnist", "--set", "epochs"])


def test_train_eval_predict(tmp_path, capsys, caplog):
    run = ["--preset", "far_mnist", "--ckpt-dir", str(tmp_path / "run"),
           "--device", "cpu", *TINY_SETS, *LOOP]
    main(["train", *run])
    assert (tmp_path / "run" / "ckpt" / "2" / "state.pt").is_file()
    with caplog.at_level(logging.INFO, logger="vptr_tpu_torch"):
        main(["train", *run])
    assert "resumed from step 2 (epoch 1)" in caplog.text
    history = json.loads((tmp_path / "run" / "ckpt" / "history.json").read_text())
    assert history["epoch"] == 2 and len(history["train"]["T_total"]) == 2
    capsys.readouterr()

    main(["eval", *run, "--mode", "far_rip", "--num-pred", "2", "--max-batches", "2"])
    out = json.loads(capsys.readouterr().out)
    for metric in ("psnr", "ssim", "mse"):
        assert len(out[metric]) == 2 and np.isfinite(out[metric]).all()
        assert out["mean"][metric] == pytest.approx(np.mean(out[metric]), abs=1e-4)

    preds = tmp_path / "preds"
    main(["predict", *run, "--mode", "far", "--num-pred", "2", "--out", str(preds)])
    files = list(preds.rglob("*"))
    assert any(f.suffix == ".avi" for f in files), files
    assert len([f for f in files if f.suffix == ".gif"]) == 2, files
    assert "predictions in" in capsys.readouterr().out
