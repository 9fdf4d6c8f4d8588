"""The port's eval metrics, LPIPS and ``evaluate`` against the JAX
package's.

* ``psnr``, ``mse_score``, ``ssim`` (11-tap Gaussian, depthwise, same
  padding) and ``per_timestep_metrics`` on seeded f32 frames, 1 and 3
  channels: 1e-5 relative;
* LPIPS from one random ``.npz`` that both ``load_weights`` read: 1e-4;
* ``evaluate`` on SMALL FAR and NAR models carrying JAX's random weights
  across, over the same test loader: the per-timestep curves of modes
  ``far``, ``far_rip`` and ``nar`` agree to 1e-4 relative (the rollouts'
  frames agree to ~1e-4 after the f32 differences of each module compound
  over the autoregressive steps).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vptr_tpu.eval.harness as jharness
import vptr_tpu.eval.lpips as jlpips
import vptr_tpu.eval.metrics as jm
from vptr_tpu.data.loader import build_loader as jbuild_loader
from vptr_tpu.train.state import ModuleState
from vptr_tpu.train.trainer import Trainer as JTrainer
from vptr_tpu_torch.data.loader import build_loader
from vptr_tpu_torch.eval import lpips as tlpips
from vptr_tpu_torch.eval import metrics as tm
from vptr_tpu_torch.eval.harness import evaluate
from vptr_tpu_torch.train.trainer import Trainer
from vptr_tpu_torch.utils.weights import load_jax_variables

from _torch_port_util import random_variables, small_cfgs, small_nar_cfgs
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5


def _pairs(c, seed=0, n=3, size=24):
    rng = np.random.default_rng(seed)
    x = rng.random((n, size, size, c)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("name", ["psnr", "mse", "ssim"])
def test_metric_matches_jax(name, c):
    x, y = _pairs(c)
    got = tm.METRIC_FNS[name](torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jm.METRIC_FNS[name](jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_ssim_per_image_and_identity():
    x, y = _pairs(3, seed=1)
    got = tm.ssim(torch.from_numpy(x), torch.from_numpy(y), size_average=False)
    want = jm.ssim(jnp.asarray(x), jnp.asarray(y), size_average=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert abs(float(tm.ssim(torch.from_numpy(x), torch.from_numpy(x))) - 1) < 1e-5


@pytest.mark.parametrize("metric", ["psnr", "ssim", "mse"])
def test_per_timestep_metrics(metric):
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((2, 4, 16, 16, 3)).astype(np.float32)
    target = rng.standard_normal((2, 4, 16, 16, 3)).astype(np.float32)
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.3, 0.25)
    from vptr_tpu.data.transforms import ReNormalize as JRe
    from vptr_tpu_torch.data.transforms import ReNormalize as TRe

    got = tm.per_timestep_metrics(torch.from_numpy(pred), torch.from_numpy(target),
                                  metric, TRe(mean, std))
    want = jm.per_timestep_metrics(jnp.asarray(pred), jnp.asarray(target), metric,
                                   JRe(mean, std))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def _random_lpips_npz(path):
    rng = np.random.default_rng(55)
    flat, in_ch = {}, 3
    for i, (feat, k, _, _) in enumerate(tlpips._ALEX_CFG):
        flat[f"alex/conv{i}/kernel"] = (rng.normal(size=(k, k, in_ch, feat)) * 0.05
                                        ).astype(np.float32)
        flat[f"alex/conv{i}/bias"] = (rng.normal(size=(feat,)) * 0.05).astype(np.float32)
        flat[f"lin{i}"] = rng.normal(size=(feat,)).astype(np.float32)
        in_ch = feat
    np.savez(path, **flat)
    return str(path)


@pytest.mark.parametrize("c", [1, 3])
def test_lpips_matches_jax(tmp_path, c):
    path = _random_lpips_npz(tmp_path / "lpips.npz")
    x, y = _pairs(c, seed=3, n=2, size=64)
    got = tlpips.make_lpips_fn(path, device="cpu")(torch.from_numpy(x),
                                                    torch.from_numpy(y))
    want = jlpips.make_lpips_fn(path)(jnp.asarray(x), jnp.asarray(y))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert tlpips.lpips_available(path) and not tlpips.lpips_available(
        str(tmp_path / "none.npz"))
    assert tlpips.make_lpips_fn(str(tmp_path / "none.npz"), device="cpu") is None


def _trainers(jc, tc):
    """(JAX trainer and a state of seeded random variables, the port's
    trainer on the CPU and its state over the same weights)."""
    jt = JTrainer(jc, write_outputs=False)
    rng = np.random.default_rng(30)
    d = jc.data
    x = jnp.zeros((2, d.num_past_frames + d.num_future_frames, d.img_size,
                   d.img_size, d.img_channels))
    ev = random_variables(jt.enc.init, rng, x)
    feats = jnp.zeros((2, d.num_past_frames, jc.transformer.enc_h,
                       jc.transformer.enc_w, jc.ae.feat_dim))
    dv = random_variables(jt.dec.init, rng, feats)
    init = (partial(jt.transformer.init, method="init_all")
            if hasattr(jt.transformer, "init_all") else jt.transformer.init)
    tv = random_variables(init, rng, feats)
    jstate = type("S", (), {"enc": ModuleState.from_variables(ev),
                            "dec": ModuleState.from_variables(dv),
                            "transformer": ModuleState.from_variables(tv)})
    tt = Trainer(tc, device="cpu", write_outputs=False)
    for m, v in ((tt.enc, ev), (tt.dec, dv), (tt.transformer, tv)):
        load_jax_variables(m, v)
    return jt, jstate, tt, tt.init_state()


TEST_DATA = {"data": {"test_past_frames": 3, "test_future_frames": 3}}


@pytest.mark.parametrize("stage,modes", [("far", ["far", "far_rip"]), ("nar", ["nar"])])
def test_evaluate_matches_jax(stage, modes):
    jc, tc = small_cfgs() if stage == "far" else small_nar_cfgs()
    jc, tc = jc.override(TEST_DATA), tc.override(TEST_DATA)
    jt, jstate, tt, tstate = _trainers(jc, tc)
    for mode in modes:
        kw = dict(mode=mode, num_pred=3, max_batches=2)
        want = jharness.evaluate(jt, jstate, jbuild_loader(jc.data, split="test"), **kw)
        got = evaluate(tt, tstate, build_loader(tc.data, split="test"), **kw)
        assert set(got) == set(want) == {"psnr", "ssim", "mse"}
        for m in want:
            assert got[m].shape == (3,)
            np.testing.assert_allclose(got[m], want[m], rtol=1e-4, err_msg=f"{mode} {m}")
