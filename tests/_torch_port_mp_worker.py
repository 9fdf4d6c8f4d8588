"""Worker and launcher of the port's data-parallel tests
(``tests/test_torch_port_parallel*.py``) -- NOT a test module (no ``test_``
prefix; pytest does not collect it). The port's counterpart of
``tests/_mp_worker.py``.

:class:`Launch` starts W copies of

    python _torch_port_mp_worker.py <job> <dir>

with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set as ``torchrun`` sets them, on a free port; each joins a
gloo group through ``vptr_tpu_torch.parallel.init_distributed("cpu")``, runs
``<job>`` and writes ``<dir>/<job>.rank<r>.pt``:

* ``steps``: every case of ``<dir>/cases.pkl`` (:func:`run_case`: one FAR,
  NAR or AE/GAN train step on the rank's rows of the case's global batch,
  from the case's weights; a case with a ``mesh`` (data, model) runs on
  that mesh, its transformer sharded, and reports its tensors whole);
* ``trainer``: ``Trainer.train`` of a tiny far_mnist for 2 epochs of 2
  steps, the same run cut after its first epoch and resumed, a ragged
  ``put_batch``, ``evaluate`` over the rank's shard of the test split, the
  refusals, and every file-system write of the rank under the run
  directory (an audit hook);
* ``tp_trainer``: the same Trainer on a (1, W) mesh (tensor parallelism
  and ``sequence_parallel``): its first epoch with a checkpoint, the
  second epoch of a one-process run's checkpoint resumed on the mesh,
  ``evaluate``, and the JAX-layout round trip of the sharded transformer
  (``export_jax_variables`` / ``load_jax_variables``, unrolled and with
  ``scan_layers``);
* ``dw_split``: every case of ``<dir>/cases.pkl`` (the dw chain's whole
  operands) on a (1, W) mesh, each rank on its share of the channels
  (:func:`run_dw_split`): the wrapper's forward and gradients (its
  autograd Function: the plain split forward and backward) and the plain
  version's under autograd;
* ``conv_split``: every case of ``<dir>/cases.pkl`` (a conv_ln_gelu
  stage's whole operands) on a (1, W) mesh, each rank on its share
  (:func:`run_conv_split`: fc1 column-parallel, its Cout channels; fc2
  row-parallel, its Cin channels), through the wrapper and the plain
  version under autograd.

Imports torch and the port only (no JAX), so a worker starts in seconds.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

# the Trainer runs: far_mnist cut to d 24 over 4 heads, 2 layers, 8 x 8
# latents of 32 x 32 frames (AE ngf 8, 2 downsamplings), 2 + 2 frames,
# global batch 8, dropout and DropPath 0.1 (the preset's)
TRAINER = {
    "dtype": "float32", "epochs": 2, "steps_per_epoch": 2, "val_per_epochs": 2,
    "ae": {"ngf": 8, "feat_dim": 24, "n_res_blocks": 1, "n_downsampling": 2},
    "transformer": {"d_model": 24, "n_heads": 4, "num_encoder_layers": 2,
                    "num_past_frames": 2, "num_future_frames": 2},
    "data": {"batch_size": 8, "img_size": 32, "num_past_frames": 2,
             "num_future_frames": 2, "test_past_frames": 2,
             "test_future_frames": 2, "num_workers": 1},
}
VAL_CLIPS = 16          # the val split cut to 16 clips: 2 batches a rank
EVAL_BATCHES = 2        # evaluate's batches a rank


class Launch:
    """W worker processes of one job; :meth:`results` waits for them."""

    def __init__(self, job: str, out_dir: Path, world: int = 2, timeout: float = 600):
        self.job, self.out_dir, self.world, self.timeout = job, Path(out_dir), world, timeout
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(REPO)] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else []))}
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__)), job, str(out_dir)],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self._results = None

    def results(self):
        """[rank 0's result, rank 1's, ...]; raises with a worker's output if
        one failed."""
        if self._results is None:
            import torch

            outs = []
            try:
                outs = [p.communicate(timeout=self.timeout)[0] for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                if p.returncode != 0:
                    raise RuntimeError(f"{self.job} worker {r} exit {p.returncode}:\n"
                                       f"{out[-4000:]}")
            self._results = [torch.load(self.out_dir / f"{self.job}.rank{r}.pt",
                                        weights_only=False)
                             for r in range(self.world)]
        return self._results


# ------------------------------------------------------------------- steps

def run_case(case):
    """One train step of ``case`` on this rank's rows of its global batch:
    ``case`` holds ``kind`` ("far", "nar" or "ae"), ``preset``, ``over``
    (config overrides), ``vars`` (JAX-layout numpy variables of every module)
    and ``past`` / ``future`` (the global batch). Returns the metrics, and
    the trained modules' parameters, gradients and BatchNorm running
    statistics after the step, by name, and the same in the JAX package's
    layout (``jax``, ``jax_grads``)."""
    import torch

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.discriminator import build_discriminator
    from vptr_tpu_torch.models.transformer import build_transformer, tp_shards
    from vptr_tpu_torch.parallel import host_id, make_mesh, num_hosts
    from vptr_tpu_torch.parallel.mesh import gather_state
    from vptr_tpu_torch.train import state as tstate
    from vptr_tpu_torch.train import steps as tsteps
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.utils.weights import (
        ae_train_state_from_jax,
        export_jax_variables,
        load_jax_variables,
    )

    cfg = get_preset(case["preset"]).override(case["over"])
    v = case["vars"]
    mesh = make_mesh(*case["mesh"]) if case.get("mesh") else None
    enc, dec = build_autoencoder(cfg.ae, device="cpu")
    if case["kind"] == "ae":
        disc = build_discriminator(cfg.disc, device="cpu")
        g_opt, d_opt = build_optimizer(cfg.optim), build_optimizer(cfg.optim_d)
        state = ae_train_state_from_jax(v, enc, dec, disc, g_opt, d_opt, seed=7)
        step = tsteps.make_ae_train_step(enc, dec, disc, g_opt, d_opt, cfg.loss)
        trained = {"enc": state.enc, "dec": state.dec, "disc": state.disc}
    else:
        load_jax_variables(enc, v["enc"])
        load_jax_variables(dec, v["dec"])
        tr = build_transformer(cfg.transformer, device="cpu")
        if mesh is not None:
            from vptr_tpu_torch.models.transformer import shard_transformer
            shard_transformer(tr, mesh, case.get("tensor_parallel", True))
        tr = load_jax_variables(tr, v["transformer"])
        opt = build_optimizer(cfg.optim, cfg.transformer.d_model)
        state = tstate.create_far_train_state(enc, dec, tr, opt, seed=7)
        make = (tsteps.make_far_train_step if case["kind"] == "far"
                else tsteps.make_nar_train_step)
        step = make(enc, dec, tr, opt, cfg.loss, remat_decoder=cfg.transformer.remat)
        trained = {"transformer": state.transformer}
    w, r = (mesh.data, mesh.data_rank) if mesh is not None else (num_hosts(), host_id())
    b = case["past"].shape[0] // w
    rows = slice(r * b, (r + 1) * b)
    state, m = step(state, torch.from_numpy(case["past"][rows]),
                    torch.from_numpy(case["future"][rows]))
    out = {"metrics": {k: float(x) for k, x in m.items()}, "params": {}, "grads": {},
           "stats": {}}
    for root, module in trained.items():    # whole, a sharded module's shares gathered
        shards = tp_shards(module)
        named = dict(module.named_parameters())
        params = gather_state({n: p.detach() for n, p in named.items()}, shards)
        grads = gather_state({n: p.grad.detach() for n, p in named.items()}, shards)
        stats = gather_state({n: b_ for n, b_ in module.named_buffers()
                              if n.endswith(("running_mean", "running_var"))}, shards)
        for n in named:
            out["params"][f"{root}.{n}"] = params[n].clone()
            out["grads"][f"{root}.{n}"] = grads[n].clone()
        for n, buf in stats.items():
            out["stats"][f"{root}.{n}"] = buf.clone()
    # the same in the JAX package's layout: {"params", "batch_stats"} and
    # the gradients' "params"
    out["jax"] = {root: export_jax_variables(m) for root, m in trained.items()}
    out["jax_grads"] = {root: export_jax_variables(
        m, {n: p.grad for n, p in m.named_parameters()})["params"]
        for root, m in trained.items()}
    return out


def job_steps(out_dir: Path):
    with open(out_dir / "cases.pkl", "rb") as f:
        cases = pickle.load(f)
    return {name: run_case(case) for name, case in cases.items()}


# ----------------------------------------------------------------- trainer

class _Writes:
    """Every path under ``root`` this process opens for writing, makes,
    renames or removes (a ``sys.addaudithook`` hook: it stays for the
    process's life, so it only records while ``on``)."""

    def __init__(self, root: Path):
        self.root, self.paths, self.on = str(root), [], False
        sys.addaudithook(self._hook)

    def _hook(self, event, args):
        if not self.on:
            return
        if event == "open" and isinstance(args[0], (str, os.PathLike)):
            mode = args[1] or ""
            flags = args[2] or 0
            if any(c in str(mode) for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR):
                self._add(args[0])
        elif event in ("os.mkdir", "os.rename", "os.remove", "os.rmdir",
                       "shutil.rmtree", "os.replace"):
            self._add(args[0])

    def _add(self, path):
        path = os.fspath(path)
        if isinstance(path, str) and os.path.abspath(path).startswith(self.root):
            self.paths.append(os.path.abspath(path))


def _state_arrays(state):
    """Every tensor of a stage-2 state by name (the generator's state too)
    and its step and optimizer count."""
    out = {f"transformer.{k}": v.clone() for k, v in state.transformer.state_dict().items()}
    out.update({f"mu.{k}": v.clone() for k, v in state.opt_state.mu.items()})
    out.update({f"nu.{k}": v.clone() for k, v in state.opt_state.nu.items()})
    out["generator"] = state.generator.get_state()
    return out, (state.step, int(state.opt_state.count))


def short_val(trainer_module):
    """The trainer module's val loaders cut to VAL_CLIPS clips."""
    build = trainer_module.build_loader

    def wrapped(cfg, *, split="train", **kw):
        loader = build(cfg, split=split, **kw)
        if split == "val":
            loader.dataset.num_clips = VAL_CLIPS
        return loader
    trainer_module.build_loader = wrapped


def _raises(fn, error):
    try:
        fn()
    except error as e:
        return str(e)
    return None


def job_trainer(out_dir: Path):
    import numpy as np

    import vptr_tpu_torch.train.trainer as ttrainer
    from vptr_tpu_torch import cli
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.eval.harness import evaluate
    from vptr_tpu_torch.parallel import host_id

    short_val(ttrainer)
    run = out_dir / "run"
    writes = _Writes(run)
    cfg = get_preset("far_mnist").override(TRAINER)
    out = {}

    writes.on = True
    unbroken = ttrainer.Trainer(cfg.override({"ckpt_dir": str(run / "a")}), device="cpu")
    want = unbroken.train()
    first = ttrainer.Trainer(cfg.override({"ckpt_dir": str(run / "b")}), device="cpu")
    first.train(epochs=1)
    resumed = ttrainer.Trainer(cfg.override({"ckpt_dir": str(run / "b")}), device="cpu")
    got = resumed.train(epochs=1)
    writes.on = False
    out["writes"] = sorted(set(writes.paths))
    out["write_outputs"] = unbroken.write_outputs
    out["history"] = unbroken.history
    out["resumed_history"] = resumed.history
    out["unbroken"], out["resumed"] = _state_arrays(want), _state_arrays(got)

    past = np.zeros((3, 2, 32, 32, 1), np.float32)
    out["ragged"] = _raises(lambda: unbroken.put_batch(past, past), ValueError)

    test = build_loader(cfg.data, split="test", seed=cfg.seed, host_id=host_id(),
                        num_hosts=2)
    out["curves"] = evaluate(unbroken, want, test, mode="far", num_pred=2,
                             max_batches=EVAL_BATCHES)

    def trainer(over):
        return lambda: ttrainer.Trainer(cfg.override(over), device="cpu",
                                        write_outputs=False)
    out["refuse_model"] = _raises(trainer({"mesh": {"model": 2},
                                           "transformer": {"n_heads": 3}}), ValueError)
    out["refuse_data"] = _raises(trainer({"mesh": {"data": 3}}), ValueError)
    out["refuse_batch"] = _raises(trainer({"data": {"batch_size": 7}}), ValueError)
    out["refuse_predict"] = _raises(lambda: cli.cmd_predict(
        cli.argparse.Namespace(preset="far_mnist", set=None, ckpt_dir=str(run / "a"),
                               device="cpu", mode="far", num_pred=None, batches=1,
                               out=str(out_dir / "preds"))), RuntimeError)
    return out


# the tensor-parallel Trainer runs: TRAINER on a (1, W) mesh with the
# temporal columns split too
TP_TRAINER = {**TRAINER, "transformer": {**TRAINER["transformer"],
                                         "sequence_parallel": True}}


def whole_state(state):
    """A stage-2 state's tensors by name, whole (a sharded transformer's
    shares and optimizer moments gathered: every model rank calls it), its
    step and optimizer count."""
    from vptr_tpu_torch.train.checkpoint import state_dict

    saved = state_dict(state)
    out = {f"transformer.{k}": v.clone() for k, v in saved["transformer"].items()}
    out.update({f"mu.{k}": v.clone() for k, v in saved["opt_state"]["mu"].items()})
    out.update({f"nu.{k}": v.clone() for k, v in saved["opt_state"]["nu"].items()})
    out["generator"] = state.generator.get_state()
    return out, (state.step, int(state.opt_state.count))


def job_tp_trainer(out_dir: Path):
    import numpy as np
    import torch

    import vptr_tpu_torch.train.trainer as ttrainer
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.eval.harness import evaluate
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.parallel import num_hosts
    from vptr_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

    short_val(ttrainer)
    run = out_dir / "run"
    model = {"mesh": {"model": num_hosts()}}
    cfg = get_preset("far_mnist").override(TP_TRAINER).override(model)
    out = {}
    first = ttrainer.Trainer(cfg.override({"ckpt_dir": str(run / "b")}), device="cpu")
    out["first"] = whole_state(first.train(epochs=1))
    out["first_history"] = first.history
    resumed = ttrainer.Trainer(cfg.override({"ckpt_dir": str(run / "c")}), device="cpu")
    got = resumed.train(epochs=1)        # the one-process run's checkpoint, on the mesh
    out["resumed"], out["resumed_history"] = whole_state(got), resumed.history
    test = build_loader(cfg.data, split="test", seed=cfg.seed, host_id=0, num_hosts=1)
    out["curves"] = evaluate(resumed, got, test, mode="far", num_pred=2,
                             max_batches=EVAL_BATCHES)

    # the JAX-layout round trip of the sharded transformer
    trips = {}
    for scan in (False, True):
        c = cfg.override({"transformer": {"scan_layers": scan}})
        whole = build_transformer(c.transformer, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
        tree = export_jax_variables(whole)
        sharded = build_transformer(c.transformer, device="cpu", mesh=first.mesh)
        load_jax_variables(sharded, tree)
        back = export_jax_variables(sharded)
        leaves = lambda t, p=(): ([(p, t)] if not isinstance(t, dict) else
                                  [x for k, v in t.items() for x in leaves(v, p + (k,))])
        a, b = dict(leaves(tree)), dict(leaves(back))
        trips[scan] = {"same_leaves": a.keys() == b.keys(),
                       "equal": all(np.array_equal(a[k], b[k]) for k in a),
                       "sharded_params": len(sharded.tp_shards),
                       "local_q": tuple(dict(sharded.named_parameters())[
                           ("blocks.0." if scan else "block0.")
                           + "slmhsa.attn.q_proj.weight"].shape)}
    out["round_trip"] = trips
    return out


# ---------------------------------------------------------------- dw_split

def run_dw_split(case):
    """``fused_dw_chain`` on this model rank's share of ``case``'s channels
    (``args``: x, taps, dwb, s1, b1, s2, b2 whole, numpy f32; ``g`` the
    output cotangent; ``seed``, ``w``, ``rate``): the output and the seven
    gradients through the wrapper and through the plain version."""
    import torch

    from vptr_tpu_torch.ops.fused_dw_chain import fused_dw_chain, fused_dw_chain_plain
    from vptr_tpu_torch.parallel import model_rank, model_size

    m, r = model_size(), model_rank()
    c = case["args"][0].shape[-1] // m
    share = lambda a: torch.from_numpy(a[..., r * c:(r + 1) * c].copy())
    out = {}
    for name, fn in (("wrapper", fused_dw_chain), ("plain", fused_dw_chain_plain)):
        ops = [share(a).requires_grad_() for a in case["args"]]
        y = fn(*ops, case["seed"], case["w"], case["rate"], model=(m, r))
        grads = torch.autograd.grad(y, ops, share(case["g"]))
        out[name] = [y.detach()] + [d.detach() for d in grads]
    return out


def job_dw_split(out_dir: Path):
    from vptr_tpu_torch.parallel import make_mesh, num_hosts

    make_mesh(1, num_hosts())
    with open(out_dir / "cases.pkl", "rb") as f:
        cases = pickle.load(f)
    return {name: run_dw_split(case) for name, case in cases.items()}


# -------------------------------------------------------------- conv_split

def run_conv_split(case):
    """``conv_ln_gelu`` on this model rank's share of ``case``'s stage
    (``args``: x, w, b, scale, bias2 whole, numpy f32; ``g`` the output
    cotangent; ``rows``: fc2 row-parallel, the share x's and w's Cin
    channels, else fc1 column-parallel, the share w's, b's, scale's and
    bias2's Cout channels): the output and the five gradients through the
    wrapper and through the plain version."""
    import torch

    from vptr_tpu_torch.ops.conv_ln_gelu import conv_ln_gelu, conv_ln_gelu_plain
    from vptr_tpu_torch.parallel import model_rank, model_size

    m, r = model_size(), model_rank()
    x, w, b, scale, bias2 = case["args"]
    rows = case["rows"]
    cut = lambda a, axis: a.take(range(r * a.shape[axis] // m, (r + 1) * a.shape[axis] // m),
                                 axis)
    if rows:
        args = (cut(x, -1), cut(w, 0), b, scale, bias2)
        g = case["g"]
    else:
        args = (x, cut(w, 1), cut(b, 0), cut(scale, 1), cut(bias2, 1))
        g = cut(case["g"], -1)
    out = {}
    for name, fn in (("wrapper", conv_ln_gelu), ("plain", conv_ln_gelu_plain)):
        ops = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
        y = fn(*ops, model=(m, r), rows=rows)
        grads = torch.autograd.grad(y, ops, torch.from_numpy(g.copy()))
        out[name] = [y.detach()] + [d.detach() for d in grads]
    return out


def job_conv_split(out_dir: Path):
    from vptr_tpu_torch.parallel import make_mesh, num_hosts

    make_mesh(1, num_hosts())
    with open(out_dir / "cases.pkl", "rb") as f:
        cases = pickle.load(f)
    return {name: run_conv_split(case) for name, case in cases.items()}


def main():
    job, out_dir = sys.argv[1], Path(sys.argv[2])
    import torch

    torch.set_num_threads(1)
    from vptr_tpu_torch.parallel import destroy_distributed, host_id, init_distributed

    assert init_distributed("cpu"), "no process group in the environment"
    try:
        result = {"steps": job_steps, "trainer": job_trainer,
                  "tp_trainer": job_tp_trainer, "dw_split": job_dw_split,
                  "conv_split": job_conv_split}[job](out_dir)
        torch.save(result, out_dir / f"{job}.rank{host_id()}.pt")
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
