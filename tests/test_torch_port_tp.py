"""The port's tensor- and sequence-parallel FAR train steps on the CPU: gloo
ranks (``tests/_torch_port_mp_worker.py``; a 2-rank and a 4-rank launch,
each spawned once for the module) on (data, model) meshes of (1, 2) and
(2, 2), against one process at the global batch and against the JAX
package's step on a mesh of the conftest's virtual devices; the NAR cases
are ``tests/test_torch_port_tp_nar.py``'s, with this module's helpers.

(a) FAR (NAR in the other module) with tensor parallelism at (1, 2) and
    (2, 2); FAR with ``sequence_parallel`` alone (the parameters whole) and
    with SP + TP (and NAR with SP + TP at (2, 2)); NAR with ``tslma`` at
    model 2; FAR with ``remat`` and SP + TP; the kernel routes on the model
    axis: FAR ``fused_ffn`` + ``fused_dw`` at (1, 2), FAR with those and
    ``fused_residual`` (the five flags of far_mnist's fused-FFN route) at
    (2, 2) and (1, 4), NAR ``fused_dw`` at (1, 2); FAR ``fused_conv_ffn`` +
    ``fused_full_temporal`` at (1, 2) and with ``fused_attention`` and
    ``fused_full`` at (2, 2), NAR ``fused_conv_ffn`` at (1, 2) (#11/#12 as
    fc1's column- and fc2's row-parallel call, the folded temporal
    sublayer on the head subset); dropout and DropPath 0.1: every metric
    within 1e-5, every parameter within 1e-4 and every gradient within 1e-4
    of its leaf's largest against the one-process port step at batch 8
    from the same weights and generator seed (so the kernels' masks on a
    head subset and on a column share, and the hidden dropout's, are the
    global call's); the parameters ``torch.equal`` across the ranks;
(b) each case at dropout 0 against the JAX package's step on a (data,
    model) mesh built as ``tests/test_parallel.py`` builds it (the state
    put on the mesh by ``state_sharding(..., tensor_parallel=True)`` for
    TP, the batch over ``data``, ``sequence_parallel`` in the JAX config):
    metrics and gradients within ``tests/test_parallel.py``'s 1e-4, the
    parameters by ``adam_param_errors``, the BatchNorm statistics 1e-5 (the
    JAX step's window sublayers on XLA, its #7-#10 in Pallas interpret
    mode);
(c) the refusals: ``n_heads % model`` and one-process ``mesh.model`` 2;
    every kernel route shards (none is refused under a model axis).

The geometry is ``tests/test_parallel.py``'s TINY (``test_torch_port_parallel``'s
cases): d_model 24 over 4 heads (2 a model rank), 2 layers (NAR 2 + 2),
2 + 2 frames of 32 x 32, global batch 8; f32.
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
from vptr_tpu.models.transformer import build_transformer as jbuild_tr
from vptr_tpu.parallel.mesh import batch_sharding, state_sharding
from vptr_tpu.parallel.mesh import make_mesh as jmake_mesh
from vptr_tpu.train.state import ModuleState, Stage2TrainState
from vptr_tpu.train.steps import make_far_train_step as jmake_far_train_step
from vptr_tpu.train.steps import make_nar_train_step as jmake_nar_train_step
from vptr_tpu_torch import parallel
from vptr_tpu_torch.models.transformer import build_transformer, shard_transformer

from _torch_port_mp_worker import Launch, run_case
from _torch_port_util import adam_param_errors, leaf_errors, random_variables, recording
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse)

AE_TINY = {"ngf": 8, "n_res_blocks": 1, "n_downsampling": 2, "feat_dim": 24}
DATA = {"batch_size": 8, "img_size": 32, "num_past_frames": 2, "num_future_frames": 2}
TR_TINY = {"d_model": 24, "n_heads": 4, "num_encoder_layers": 2,
           "num_past_frames": 2, "num_future_frames": 2, "enc_h": 8, "enc_w": 8}
PRESETS = {"far": "far_mnist", "nar": "nar_mnist"}
# case -> (kind, seed, (data, model), transformer flags, tensor parallel);
# seeds where the one-process port step and JAX's single-device step take
# the same side of every GDL kink at dropout 0 (at seed 16 "far_sp_tp" sat
# on a tie: the two packages differ there by 1.5e-4 on 55 leaves with no
# mesh at all, as the module notes of test_torch_port_nar_train.py say)
CASES = {
    "far_tp": ("far", 11, (1, 2), {}, True),
    "far_dp_tp": ("far", 12, (2, 2), {}, True),
    "nar_tp": ("nar", 13, (1, 2), {}, True),
    "nar_dp_tp": ("nar", 14, (2, 2), {}, True),
    "far_sp": ("far", 15, (1, 2), {"sequence_parallel": True}, False),
    "far_sp_tp": ("far", 20, (2, 2), {"sequence_parallel": True}, True),
    "nar_sp_tp": ("nar", 17, (2, 2), {"sequence_parallel": True}, True),
    "nar_tslma_tp": ("nar", 18, (1, 2), {"tslma": True}, True),
    "far_remat_sp_tp": ("far", 19, (1, 2), {"remat": True, "sequence_parallel": True},
                        True),
    # the kernel routes on the model axis: #7/#8 on a hidden subset and the
    # dw chain's LayerNorms over every rank's channels; with the window
    # sublayer's residual folded (#1 unfolded on the head subset, x added
    # after the reduce); the NAR decoder's dw chain
    "far_ffn_tp": ("far", 21, (1, 2), {"fused_ffn": True, "fused_dw": True}, True),
    "far_fused_dp_tp": ("far", 22, (2, 2), {"fused_attention": True, "fused_full": True,
                                            "fused_residual": True, "fused_ffn": True,
                                            "fused_dw": True}, True),
    "nar_dw_tp": ("nar", 23, (1, 2), {"fused_dw": True}, True),
    # the fused-FFN route's five flags at mesh.model 4: a head, 6 channels
    # and 24 hidden columns a rank (on the card far_mnist's 528 hidden
    # channels a rank end in a partial 32-channel tile of the split dw
    # chain). At seed 27 with dropout 0.1 these flags sit on a tie at every
    # mesh, (1, 2) and (2, 2) as well: grad_norm 2.6e-6 and the conv FFN's
    # norm affines 2.8e-3 of their largest from the one-process step, with
    # the losses equal (at dropout 0 1e-6); at seed 28 the port and JAX
    # take different sides of a kink at dropout 0 (67 leaves 1.0-1.3x past
    # 1e-4). Seed 29 has neither
    "far_fused_tp4": ("far", 29, (1, 4), {"fused_attention": True, "fused_full": True,
                                          "fused_residual": True, "fused_ffn": True,
                                          "fused_dw": True}, True),
    # the conv FFN's #11/#12 on the model axis: fc1 column-parallel with
    # norm1's statistics over every rank's hidden, fc2 row-parallel; with
    # the temporal sublayer folded into #1 on the head subset
    "far_conv_tp": ("far", 24, (1, 2), {"fused_conv_ffn": True, "fused_full_temporal": True},
                    True),
    "far_conv_dp_tp": ("far", 25, (2, 2), {"fused_attention": True, "fused_full": True,
                                           "fused_conv_ffn": True, "fused_full_temporal": True},
                       True),
    "nar_conv_tp": ("nar", 26, (1, 2), {"fused_conv_ffn": True}, True),
}
METRIC_TOL, PARAM_TOL, GRAD_REL, STAT_TOL = 1e-5, 1e-4, 1e-4, 1e-5
JAX_TOL = 1e-4              # tests/test_parallel.py's


def _over(kind, drop, flags):
    tr = {**TR_TINY, "dropout": drop, "drop_path": drop, **flags}
    if kind == "nar":
        tr["num_decoder_layers"] = 2
    return {"dtype": "float32", "data": DATA, "ae": AE_TINY, "transformer": tr}


def _case(name, drop):
    """The case at dropout ``drop``: its port case (config overrides,
    seeded random JAX-layout variables, a global batch of 8, the mesh), the
    JAX config and modules."""
    kind, seed, mesh, flags, tp = CASES[name]
    over = _over(kind, drop, flags)
    jc = jcfg.get_preset(PRESETS[kind]).override(over)
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 1, (8, 4, 32, 32, 1)).astype(np.float32)
    jenc, jdec = jbuild_ae(jc.ae)
    jtr = jbuild_tr(jc.transformer)
    v = {"enc": random_variables(jenc.init, rng, frames),
         "dec": random_variables(jdec.init, rng, np.zeros((8, 4, 8, 8, 24), np.float32))}
    # the variables' shapes from the module without SP (its sharding
    # constraints need a mesh in context; the tree is the same)
    whole = jbuild_tr(jc.override({"transformer": {"sequence_parallel": False}}).transformer)
    init = whole.init if kind == "far" else partial(whole.init, method="init_all")
    v["transformer"] = random_variables(init, rng, np.zeros((8, 2, 8, 8, 24), np.float32))
    case = {"kind": kind, "preset": PRESETS[kind], "over": over, "vars": v,
            "past": frames[:, :2], "future": frames[:, 2:], "mesh": mesh,
            "tensor_parallel": tp}
    return case, jc, (jenc, jdec, jtr)


def _launch(out, world, built, names):
    names = [n for n in names if CASES[n][2][0] * CASES[n][2][1] == world]
    sub = out / f"w{world}"
    sub.mkdir()
    with open(sub / "cases.pkl", "wb") as f:
        pickle.dump({f"{n}{tag}": built[(n, tag)][0] for n in names for tag in ("", "0")}, f)
    return Launch("steps", sub, world=world)


def tp_cases(out, kind):
    """The ``kind`` cases (dropout 0.1, and their dropout-0 twins
    "<name>0") and the 2-rank and 4-rank launches running all of them
    (started before any test of the module computes its references); a
    generator for a module fixture."""
    names = [n for n in CASES if CASES[n][0] == kind]
    built = {(n, tag): _case(n, drop) for n in names for tag, drop in (("", 0.1), ("0", 0.0))}
    launches = {w: _launch(out, w, built, names) for w in (2, 4)}
    yield built, launches
    for launch in launches.values():
        for p in launch.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    yield from tp_cases(tmp_path_factory.mktemp("tp_steps"), "far")


FAR = [n for n in CASES if CASES[n][0] == "far"]


def _ranks(launches, name):
    mesh = CASES[name.rstrip("0")][2]
    return [r[name] for r in launches[mesh[0] * mesh[1]].results()]


def _close(got, want, tol, what):
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol, f"{what}: max |err| {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("name", FAR)
def test_tp_step_matches_one_process(tp, name):
    """(a): the mesh's step with dropout against the one-process step."""
    check_one_process(tp, name)


def check_one_process(tp, name):
    built, launches = tp
    case = built[(name, "")][0]
    ref = run_case({k: v for k, v in case.items() if k != "mesh"})    # one process, batch 8
    ranks = _ranks(launches, name)
    for r, got in enumerate(ranks):
        assert got["metrics"].keys() == ref["metrics"].keys()
        for k, want in ref["metrics"].items():
            assert abs(got["metrics"][k] - want) <= METRIC_TOL, (r, k, got["metrics"][k], want)
        for n, want in ref["params"].items():
            _close(got["params"][n], want, PARAM_TOL, f"rank {r} param {n}")
        for n, want in ref["grads"].items():
            _close(got["grads"][n], want, GRAD_REL * max(float(want.abs().max()), 1e-4),
                   f"rank {r} grad {n}")
        for n, want in ref["stats"].items():
            _close(got["stats"][n], want, STAT_TOL, f"rank {r} statistic {n}")
    for n in ref["params"]:                     # every rank holds the same state
        for got in ranks[1:]:
            assert torch.equal(ranks[0]["params"][n], got["params"][n]), n
    assert (len(ref["stats"]) > 0) == (case["kind"] == "nar")


def _jax_mesh_step(case, jc, jmods):
    """The JAX package's step on a (data, model) mesh of the virtual
    devices, as tests/test_parallel.py builds it: the state sharded by the
    TP rules (or replicated for SP alone), the batch over ``data``,
    ``sequence_parallel`` from the config (recording optimizer: its state
    keeps the gradients). -> (metrics, params, grads, stats)."""
    kind, (data, model) = case["kind"], case["mesh"]
    v = case["vars"]
    jenc, jdec, _ = jmods
    # the unfused XLA route: at dropout 0 the same function as the Pallas
    # kernels (tests/test_torch_port_ops.py holds those to it), without
    # interpret mode's compile time
    jtr = jbuild_tr(jc.override({"transformer": {"fused_attention": False,
                                                 "fused_full": False}}).transformer)
    mesh = jmake_mesh(data=data, model=model)
    opt = recording(jlosses.build_optimizer(jc.optim, jc.transformer.d_model))
    ms = ModuleState.from_variables
    state = Stage2TrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
        transformer=ms(v["transformer"]), t_opt=opt.init(v["transformer"]["params"]),
        enc=ms(v["enc"]), dec=ms(v["dec"]), disc=None, d_opt=None)
    state = jax.device_put(state, state_sharding(state, mesh,
                                                 tensor_parallel=case["tensor_parallel"]))
    x = jax.device_put((jnp.asarray(case["past"]), jnp.asarray(case["future"])),
                       batch_sharding(mesh))
    make = jmake_far_train_step if kind == "far" else jmake_nar_train_step
    with mesh:
        new, m = jax.jit(make(jenc, jdec, jtr, None, opt, None, jc.loss))(state, *x)
    return ({k: float(val) for k, val in m.items()}, new.transformer.params,
            new.t_opt[1], new.transformer.stats)


@pytest.mark.parametrize("name", FAR)
def test_tp_step_matches_jax_mesh(tp, name):
    """(b): the mesh's step at dropout 0 against the JAX package's step on a
    (data, model) mesh."""
    check_jax_mesh(tp, name)


def check_jax_mesh(tp, name):
    built, launches = tp
    case, jc, jmods = built[(name, "0")]
    jm, params, grads, stats = _jax_mesh_step(case, jc, jmods)
    for r, got in enumerate(_ranks(launches, name + "0")):
        for k, want in jm.items():
            assert abs(got["metrics"][k] - want) <= JAX_TOL * max(1.0, abs(want)), (
                r, k, got["metrics"][k], want)
        root = got["jax"]["transformer"]
        assert leaf_errors(got["jax_grads"]["transformer"], grads, JAX_TOL, 1e-8) == [], r
        assert adam_param_errors(root["params"], params, grads, jc.optim.lr, JAX_TOL,
                                 1e-8) == [], r
        assert leaf_errors(root.get("batch_stats", {}), stats, STAT_TOL, STAT_TOL) == [], r


# ------------------------------------------------------------ (c) refusals

def test_refusals():
    """Whole heads only; one-process mesh.model 2."""
    cfg = tcfg.get_preset("far_mnist").override(
        {"dtype": "float32", "transformer": {**TR_TINY, "n_heads": 3}})
    tr = build_transformer(cfg.transformer, device="cpu")
    mesh = parallel.Mesh(data=1, rank=1, model=2)
    with pytest.raises(ValueError, match="n_heads 3 does not split over mesh.model=2"):
        shard_transformer(tr, mesh)
    with pytest.raises(NotImplementedError, match="one process per model rank"):
        parallel.make_mesh(-1, 2)


@pytest.mark.parametrize("kind", ["far", "nar"])
def test_fused_routes_shard(kind):
    """far_mnist and nar_mnist with fused_ffn, fused_dw and fused_residual,
    and with fused_conv_ffn and fused_full_temporal, build and cut to a
    rank's shares at mesh.model 2: every linear FFN and LayerNorm conv FFN
    (on the dw chain's route, or on #11/#12's) holds half the hidden; no
    route is refused."""
    hidden = 4 * TR_TINY["d_model"]
    for flags, route in (({"fused_ffn": True, "fused_dw": True, "fused_residual": True},
                          "fused_dw"),
                         ({"fused_conv_ffn": True, "fused_full_temporal": True}, "fused_ln")):
        cfg = tcfg.get_preset(PRESETS[kind]).override(_over(kind, 0.0, flags))
        tr = shard_transformer(build_transformer(cfg.transformer, device="cpu"),
                               parallel.Mesh(data=1, rank=1, model=2))
        ffns = [m for n, m in tr.named_modules() if n.endswith(".ffn")]
        convs = [m for m in tr.modules() if getattr(m, route, False)]
        assert ffns and convs, flags
        assert all(m.tp == (2, 1) and m.linear1.weight.shape[0] == hidden // 2 for m in ffns)
        assert all(m.tp == (2, 1) and m.fc1.weight.shape[0] == hidden // 2
                   and m.fc2.weight.shape[1] == hidden // 2 for m in convs)
