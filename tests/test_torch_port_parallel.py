"""The port's data-parallel train steps on the CPU: two gloo ranks
(``tests/_torch_port_mp_worker.py``, spawned once for the module) against
one process at the global batch, and against the JAX package.

(a) a FAR, a NAR and an AE/GAN step at W = 2 (local batch 4) with dropout
    and DropPath 0.1 (the AE's residual-block dropout on) against the
    one-process port step at batch 8 from the same weights and generator
    seed: every metric within 1e-5 (AE 1e-4), every parameter within 1e-4,
    every gradient within 1e-4 of its leaf's largest (a dropout mask that
    differs by one row moves the losses by far more);
(b) the same three at dropout 0 against the JAX package's single-device
    step at batch 8 (the weights go to both through ``load_jax_variables``):
    metrics and gradients as in (a), the BatchNorm statistics 1e-5 absolute
    plus 1e-5 relative (``tests/test_parallel.py``'s: the packages' E[x^2]
    - E[x]^2 differ in summation order), the parameters by the port's
    protocol against JAX (``adam_param_errors``: Adam's first step moves an
    element by about lr times the sign of its gradient, so where the
    gradient is within the tolerance of 0 the packages may step 2 lr apart,
    and elsewhere they agree to 2e-6);
(c) the parameters are ``torch.equal`` across the ranks after each step,
    and the BatchNorm running statistics (the AE's and D's, the NAR
    encoder's conv FFN) within 1e-5 of the one-process run's;
(e) the ranks with ``transformer.remat`` on (the blocks and the decoder
    checkpointed; under W ranks the NAR encoder's BatchNorm sums pass
    through the all-reduce again in each recompute) on the fused-FFN route
    (FAR, ``fused_ffn`` + ``fused_dw``) and with TSLMA (NAR), dropout 0.1,
    against the one-process step with remat off, by (a)'s and (c)'s
    checks: the BatchNorm statistics move once;
(d) ``fold_seed``, in one process without a group: rank r's mask under the
    folded seed equals rows r·b .. (r+1)·b of the global call's, bit for
    bit, for the four hash masks against the JAX package's oracles at the
    global shape; and the mesh's refusals in one process.

The geometry is ``tests/test_parallel.py``'s TINY: d_model 24 over 4 heads,
2 layers (NAR 2 + 2), 2 + 2 frames of 32 x 32, global batch 8 (AE ngf 8,
two downsamplings: 8 x 8 latents, four windows a frame); f32.
"""

import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vptr_tpu.config as jcfg
import vptr_tpu_torch.config as tcfg
from vptr_tpu import losses as jlosses
from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
from vptr_tpu.models.discriminator import build_discriminator as jbuild_disc
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu.ops import attention_core as jac
from vptr_tpu.ops import fused_dw_chain as jdw
from vptr_tpu.ops import fused_ffn as jffn
from vptr_tpu.ops import fused_window_attention as jfw
from vptr_tpu.train.state import AETrainState, ModuleState, Stage2TrainState
from vptr_tpu.train.steps import make_ae_train_step as jmake_ae_train_step
from vptr_tpu.train.steps import make_far_train_step as jmake_far_train_step
from vptr_tpu.train.steps import make_nar_train_step as jmake_nar_train_step
from vptr_tpu_torch import parallel
from vptr_tpu_torch.ops import dropout as tdrop

from _torch_port_mp_worker import Launch, run_case
from _torch_port_util import adam_param_errors, leaf_errors, random_variables, recording
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

AE_TINY = {"ngf": 8, "n_res_blocks": 1, "n_downsampling": 2}
DATA = {"batch_size": 8, "img_size": 32, "num_past_frames": 2, "num_future_frames": 2}
TR_TINY = {"d_model": 24, "n_heads": 4, "num_encoder_layers": 2,
           "num_past_frames": 2, "num_future_frames": 2, "enc_h": 8, "enc_w": 8}


def _over(kind, drop: float):
    if kind == "ae":
        return {"dtype": "float32", "data": DATA, "disc": {"ndf": 8},
                "ae": {**AE_TINY, "feat_dim": 8, "use_dropout": drop > 0}}
    tr = {**TR_TINY, "dropout": drop, "drop_path": drop}
    if kind == "nar":
        tr["num_decoder_layers"] = 2
    return {"dtype": "float32", "data": DATA, "ae": {**AE_TINY, "feat_dim": 24},
            "transformer": tr}


PRESETS = {"far": "far_mnist", "nar": "nar_mnist", "ae": "ae_mnist"}
# case name -> (kind, dropout / DropPath, seed of the weights and frames)
# (ae0's seed is one where the packages' train-mode forwards take the same
# side of every ReLU and GDL kink, as tests/test_torch_port_ae_train.py's:
# their E[x^2] - E[x]^2 differ by ~1e-5 at each BatchNorm output, and a
# kink crossed apart moves a few gradients by 1-6%; the test checks it)
CASES = {"far": ("far", 0.1, 1), "nar": ("nar", 0.1, 2), "ae": ("ae", 0.1, 3),
         "far0": ("far", 0.0, 4), "nar0": ("nar", 0.0, 5), "ae0": ("ae", 0.0, 38),
         # (e): the ranks with transformer.remat (and the decoder
         # checkpointed) on a kernel route, transformer flags last
         "far_ffn_remat": ("far", 0.1, 6, {"fused_ffn": True, "fused_dw": True,
                                           "remat": True}),
         "nar_tslma_remat": ("nar", 0.1, 7, {"tslma": True, "remat": True})}
METRIC_TOL = {"far": 1e-5, "nar": 1e-5, "ae": 1e-4}
PARAM_TOL, GRAD_REL, STAT_TOL = 1e-4, 1e-4, 1e-5


def _case(name):
    """The case's config overrides, JAX modules, seeded random JAX-layout
    variables and a global batch of 8."""
    kind, drop, seed, *flags = CASES[name]
    over = _over(kind, drop)
    if flags:
        over["transformer"].update(flags[0])
    jc = jcfg.get_preset(PRESETS[kind]).override(over)
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 1, (8, 4, 32, 32, 1)).astype(np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    feat = jc.ae.feat_dim
    v = {"enc": random_variables(jenc.init, rng, frames),
         "dec": random_variables(jdec.init, rng, np.zeros((8, 4, 8, 8, feat), np.float32))}
    if kind == "ae":
        jmods = (jenc, jdec, jbuild_disc(jc.disc))
        v["disc"] = random_variables(jmods[2].init, rng, frames[:, 0])
    else:
        jtr = jbuild_tr(jc.transformer)
        jmods = (jenc, jdec, jtr)
        init = jtr.init if kind == "far" else partial(jtr.init, method="init_all")
        v["transformer"] = random_variables(init, rng, np.zeros((8, 2, 8, 8, feat),
                                                                np.float32))
    case = {"kind": kind, "preset": PRESETS[kind], "over": over, "vars": v,
            "past": frames[:, :2], "future": frames[:, 2:]}
    return case, jc, jmods


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The cases, and the two ranks running all of them (started before any
    test of the module computes its references)."""
    out = tmp_path_factory.mktemp("dp_steps")
    built = {name: _case(name) for name in CASES}
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump({name: b[0] for name, b in built.items()}, f)
    launch = Launch("steps", out)
    yield built, launch
    for p in launch.procs:          # a failed test may leave them unread
        if p.poll() is None:
            p.kill()
            p.wait()


def _close(got, want, tol, what):
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol, f"{what}: max |err| {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("name", ["far", "nar", "ae"])
def test_dp_step_matches_one_process(dp, name):
    """(a) and (c): W = 2 with dropout against the one-process step."""
    built, launch = dp
    case = built[name][0]
    ref = run_case(case)                   # no group here: one process, batch 8
    ranks = [r[name] for r in launch.results()]
    _check_ranks(ranks, ref, name)
    # dropout acted: the step differs from its dropout-0 twin's
    assert ref["metrics"] != run_case({**case, "over": _over(case["kind"], 0.0)})["metrics"]


@pytest.mark.parametrize("name", ["far_ffn_remat", "nar_tslma_remat"])
def test_dp_remat_step_matches_one_process(dp, name):
    """(e): W = 2 with remat against the one-process step without it."""
    built, launch = dp
    case = built[name][0]
    assert case["over"]["transformer"]["remat"]
    off = {**case["over"], "transformer": {**case["over"]["transformer"], "remat": False}}
    ref = run_case({**case, "over": off})
    ranks = [r[name] for r in launch.results()]
    _check_ranks(ranks, ref, case["kind"])
    if case["kind"] == "nar":   # they moved, and equal the remat-off step's: once
        start = case["vars"]["transformer"]["batch_stats"]["enc_block0"]["spatial_ffn"]
        got = ranks[0]["stats"]["transformer.enc_block0.spatial_ffn.norm1.running_mean"]
        assert not np.allclose(got.numpy(), start["norm1"]["mean"], atol=1e-3)


def _check_ranks(ranks, ref, kind):
    """(a) and (c) for each rank's result against the one-process ``ref``."""
    for r, got in enumerate(ranks):
        assert got["metrics"].keys() == ref["metrics"].keys()
        for k, want in ref["metrics"].items():
            assert abs(got["metrics"][k] - want) <= METRIC_TOL[kind], (r, k, got["metrics"][k],
                                                                       want)
        for n, want in ref["params"].items():
            _close(got["params"][n], want, PARAM_TOL, f"rank {r} param {n}")
        for n, want in ref["grads"].items():
            _close(got["grads"][n], want,
                   GRAD_REL * max(float(want.abs().max()), 1e-4), f"rank {r} grad {n}")
        for n, want in ref["stats"].items():
            _close(got["stats"][n], want, STAT_TOL, f"rank {r} statistic {n}")
    # (c) every rank holds the same state
    for n in ref["params"]:
        assert torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]), n
    for n in ref["stats"]:
        assert torch.equal(ranks[0]["stats"][n], ranks[1]["stats"][n]), n
    assert (len(ref["stats"]) > 0) == (kind in ("nar", "ae"))


def _jax_step(kind, jc, jmods, v, past, future):
    """The JAX package's single-device step (recording optimizers: their
    states keep the gradients) -> (metrics, {root: (params, grads,
    stats)})."""
    x = (jnp.asarray(past), jnp.asarray(future))
    ms = ModuleState.from_variables
    if kind == "ae":
        jenc, jdec, jdisc = jmods
        g_opt = recording(jlosses.build_optimizer(jc.optim))
        d_opt = recording(jlosses.build_optimizer(jc.optim_d))
        state = AETrainState(
            step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
            enc=ms(v["enc"]), dec=ms(v["dec"]), disc=ms(v["disc"]),
            g_opt=g_opt.init((v["enc"]["params"], v["dec"]["params"])),
            d_opt=d_opt.init(v["disc"]["params"]))
        new, m = jax.jit(jmake_ae_train_step(jenc, jdec, jdisc, g_opt, d_opt,
                                             jc.loss))(state, *x)
        (eg, dg), sg = new.g_opt[1], new.d_opt[1]
        out = {"enc": (new.enc, eg), "dec": (new.dec, dg), "disc": (new.disc, sg)}
    else:
        jenc, jdec, jtr = jmods
        opt = recording(jlosses.build_optimizer(jc.optim, jc.transformer.d_model))
        state = Stage2TrainState(
            step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
            transformer=ms(v["transformer"]), t_opt=opt.init(v["transformer"]["params"]),
            enc=ms(v["enc"]), dec=ms(v["dec"]), disc=None, d_opt=None)
        make = jmake_far_train_step if kind == "far" else jmake_nar_train_step
        new, m = jax.jit(make(jenc, jdec, jtr, None, opt, None, jc.loss))(state, *x)
        out = {"transformer": (new.transformer, new.t_opt[1])}
    return ({k: float(val) for k, val in m.items()},
            {root: (s.params, g, s.stats) for root, (s, g) in out.items()})


def _ae_kink_flips(case, jmods):
    """tests/test_torch_port_ae_train.py's kink check on the case's batch."""
    from types import SimpleNamespace

    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.utils.weights import load_jax_variables

    from test_torch_port_ae_train import _kink_flips

    cfg = tcfg.get_preset(case["preset"]).override(case["over"])
    enc, dec = build_autoencoder(cfg.ae, device="cpu")
    load_jax_variables(enc, case["vars"]["enc"])
    load_jax_variables(dec, case["vars"]["dec"])
    x = np.concatenate([case["past"], case["future"]], axis=1)
    return _kink_flips({"jmods": jmods, "jvars": case["vars"], "x": x},
                       SimpleNamespace(enc=enc, dec=dec))


@pytest.mark.parametrize("name", ["far0", "nar0", "ae0"])
def test_dp_step_matches_jax(dp, name):
    """(b): W = 2 at dropout 0 against the JAX package at batch 8."""
    built, launch = dp
    case, jc, jmods = built[name]
    kind = case["kind"]
    if kind == "ae":
        assert not any(_ae_kink_flips(case, jmods).values())
    jm, jout = _jax_step(kind, jc, jmods, case["vars"], case["past"], case["future"])
    ranks = [r[name] for r in launch.results()]
    for r, got in enumerate(ranks):
        for k, want in jm.items():
            assert abs(got["metrics"][k] - want) <= METRIC_TOL[kind], (r, k, got["metrics"][k],
                                                                       want)
        for root, (params, grads, stats) in jout.items():
            assert leaf_errors(got["jax_grads"][root], grads, GRAD_REL, 1e-8) == [], (r, root)
            lr = jc.optim_d.lr if root == "disc" else jc.optim.lr
            assert adam_param_errors(got["jax"][root]["params"], params, grads, lr,
                                     GRAD_REL, 1e-8) == [], (r, root)
            assert leaf_errors(got["jax"][root].get("batch_stats", {}), stats, STAT_TOL,
                               STAT_TOL) == [], (r, root)
    for n in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]), n


# ------------------------------------------------------------ (d) fold_seed

def _masks(kind, seed, b):
    """(the port's mask of a b-sample call under a given seed, the call's
    count of mask elements (its index space), the JAX oracle's mask of the
    call under ``seed``: a function too) for one of the four hash masks;
    the sample axis first."""
    h, l, rate = 4, 19, 0.1
    if kind == "dropout":      # attention core: (B, H, Tq, Tk)
        return (lambda s: tdrop.dropout_keep_mask(s, b, h, l, rate, 11), b * h * l * 11,
                lambda: np.asarray(jac.dropout_keep_mask(seed, b, h, l, rate, 11)))
    if kind == "window":       # window kernel: L 19 indexed over 32 (bf16)
        lp = tdrop.padded_tokens(l, torch.bfloat16)
        return (lambda s: tdrop.window_keep_mask(s, b, h, l, rate, torch.bfloat16),
                b * h * lp * lp,
                lambda: np.stack([np.asarray(jfw._keep_mask_head(
                    jnp.uint32(seed), 0, hh, b, lp, h, rate))[:, :l, :l]
                    for hh in range(h)], axis=1))
    if kind == "ffn":          # fused FFN: (rows, hidden), 6 rows a sample
        return (lambda s: tdrop.ffn_keep_mask(s, 6 * b, 40, rate), 6 * b * 40,
                lambda: np.asarray(jffn.ffn_keep_mask(seed, 6 * b, 40, rate)))
    return (lambda s: tdrop.dw_keep_mask(s, b, 16, 24, rate), b * 16 * 24,   # dw chain
            lambda: np.asarray(jdw.dw_keep_mask(seed, b, 16, 24, rate)))


_GLOBAL = {}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("kind", ["dropout", "window", "ffn", "dw"])
def test_fold_seed_gives_the_ranks_rows(kind, world):
    seed = 2 ** 31 - 2
    if kind not in _GLOBAL:                         # the global call: 6 samples
        _GLOBAL[kind] = _masks(kind, seed, 6)[2]()
    want = _GLOBAL[kind]
    local, n, _ = _masks(kind, seed, 6 // world)    # n: the local call's elements
    rows = want.shape[0] // world
    for r in range(world):
        got = local(parallel.fold_seed(seed, r * n)).numpy()
        np.testing.assert_array_equal(got, want[r * rows:(r + 1) * rows])
        tensor_seed = parallel.fold_seed(torch.tensor([seed], dtype=torch.int32), r * n)
        assert tensor_seed.dtype == torch.int32
        assert int(tensor_seed) == parallel.fold_seed(seed, r * n)
        assert -2 ** 31 <= int(tensor_seed) < 2 ** 31


def test_one_process_mesh_and_collectives():
    """Without a group: the world is one rank, init is a no-op, the
    collectives are the identity, and the mesh refuses what one process
    cannot hold."""
    assert parallel.num_hosts() == 1 and parallel.host_id() == 0
    assert parallel.make_mesh(-1, 1) == parallel.Mesh(data=1, rank=0)
    assert parallel.make_mesh(1, 1).data == 1
    with pytest.raises(ValueError, match="process group has 1 rank"):
        parallel.make_mesh(2, 1)
    with pytest.raises(NotImplementedError, match="TP/SP slice"):
        parallel.make_mesh(-1, 2)
    assert parallel.rank_seed(torch.tensor([5], dtype=torch.int32), 100).item() == 5
    assert parallel.fold_seed(7, 0) == 7
    x = torch.arange(4.0, requires_grad=True)
    assert parallel.all_reduce_sum(x) is x
    assert parallel.all_reduce_mean([x]) == [x]
    p, q = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    q.grad = torch.full((2,), 3.0)
    parallel.all_reduce_grads([p, q])      # a missing gradient becomes zeros
    assert torch.equal(p.grad, torch.zeros(3))
    assert torch.equal(q.grad, torch.full((2,), 3.0))
