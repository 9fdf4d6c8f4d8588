"""The port's package boundary on the CPU.

(f) every preset of the port's config equals the JAX package's, field for
    field (the port keeps its own copy of ``vptr_tpu/config.py``).
(g) importing ``vptr_tpu_torch`` (every module) pulls in neither ``jax``
    nor ``vptr_tpu`` (nor orbax, nor the optional PIL, tensorboardX,
    TensorFlow and detectron2, which only the functions needing them
    import); entry points asked for the card raise when there is
    none instead of running on the CPU; unported routes raise.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import vptr_tpu.config as jcfg
import vptr_tpu_torch.config as tcfg
from vptr_tpu_torch.cli import main as cli_main
from vptr_tpu_torch.eval.harness import make_predict_fn
from vptr_tpu_torch.models.autoencoder import build_autoencoder
from vptr_tpu_torch.models.transformer import build_transformer
from vptr_tpu_torch.ops import attention_core as tac
from vptr_tpu_torch.train.trainer import Trainer

from _torch_port_util import small_cfgs
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


def test_preset_names_match():
    assert tcfg.list_presets() == jcfg.list_presets()


@pytest.mark.parametrize("name", jcfg.list_presets())
def test_preset_matches_jax(name):
    assert (dataclasses.asdict(tcfg.get_preset(name))
            == dataclasses.asdict(jcfg.get_preset(name)))
    over = {"transformer": {"d_model": 48}, "data": {"batch_size": 3}}
    assert (dataclasses.asdict(tcfg.get_preset(name).override(over))
            == dataclasses.asdict(jcfg.get_preset(name).override(over)))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vptr_tpu_torch\n"
        "for m in pkgutil.walk_packages(vptr_tpu_torch.__path__, 'vptr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "lazy = ('jax', 'vptr_tpu', 'flax', 'orbax', 'PIL', 'tensorboardX',\n"
        "        'tensorflow', 'detectron2')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in lazy)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cuda_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = small_cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_autoencoder(cfg.ae)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_transformer(cfg.transformer)
    enc, dec = build_autoencoder(cfg.ae, device="cpu")
    tr = build_transformer(cfg.transformer, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_predict_fn(cfg, enc, dec, tr, "far_rip", 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, write_outputs=False)
    for cmd in ("train", "eval", "predict"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main([cmd, "--preset", "far_mnist"])


def test_nar_entry_points_raise_without_gpu(monkeypatch):
    """The NAR builders and the nar predict mode, as the FAR ones above."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = small_cfgs()
    cfg = cfg.override({"transformer": {"variant": "nar", "rpe": True,
                                        "num_decoder_layers": 1}})
    with pytest.raises(RuntimeError, match="CUDA"):
        build_transformer(cfg.transformer)
    enc, dec = build_autoencoder(cfg.ae, device="cpu")
    tr = build_transformer(cfg.transformer, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_predict_fn(cfg, enc, dec, tr, "nar", 3)


def test_kernel_wrapper_refuses_other_devices():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tac.attention_core(q, q, q)


@pytest.mark.parametrize("override,match", [
    # remat, scan_layers and sequence_parallel raised until they were
    # ported; their cases now check that the config builds the working path
    # (ids kept)
    pytest.param({"remat": True}, None, id="override0-remat slice"),
    pytest.param({"sequence_parallel": True}, None, id="override1-multi-GPU slice"),
    pytest.param({"variant": "nar", "sequence_parallel": True}, None,
                 id="override2-multi-GPU slice"),
    pytest.param({"scan_layers": True}, None, id="override3-scan_layers slice"),
])
def test_unported_routes_raise(override, match):
    """remat, scan_layers and sequence_parallel build (sequence_parallel's
    temporal attentions split their columns on a mesh with a model axis:
    tests/test_torch_port_tp.py)."""
    _, cfg = small_cfgs()
    tcfg = cfg.transformer.__class__(**{**dataclasses.asdict(cfg.transformer), **override})
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            build_transformer(tcfg, device="cpu")
        return
    tr = build_transformer(tcfg, device="cpu")
    assert (tr.remat, tr.scan_layers) == (tcfg.remat, tcfg.scan_layers)
    temporal = [m for m in tr.modules() if type(m).__name__ == "TemporalAttention"]
    assert temporal and all(m.sequence_parallel == tcfg.sequence_parallel and m.sp is None
                            for m in temporal)
    first = "enc_block" if tcfg.variant == "nar" else "block"
    assert hasattr(tr, first + "s") == tcfg.scan_layers
    assert hasattr(tr, first + "0") != tcfg.scan_layers


def test_tslma_route_builds():
    """The config that raised until TSLMA was ported now builds it."""
    _, cfg = small_cfgs()
    tr = build_transformer(cfg.transformer.__class__(
        **{**dataclasses.asdict(cfg.transformer), "variant": "nar", "tslma": True}),
        device="cpu")
    assert all(getattr(tr, f"dec_block{i}").use_tslma for i in range(tr.num_decoder_layers))
