"""nar_mnist's first train step from the port's seeded init: its gradient
norm and the leaves whose gradient is not finite, on the port alone or
beside the JAX package on the same weights.

    python3 scripts/nar_first_step_parity.py [--device cuda] [--dtype bfloat16]
        [--batch 16] [--plain] [--jax] [--set key.path=value ...]

The port's Trainer builds nar_mnist (or the preset's overrides) from its
seed, takes the first batch of the synthetic train loader and runs one
train step; the script prints the losses, ``grad_norm``, the leaves with a
non-finite gradient and the largest finite gradients. ``--plain`` routes
the model through the kernels' plain versions (on the card: kernels
against plain). ``--jax`` (CPU only) also runs the JAX package's NAR step
on the port's variables (``export_jax_variables``) in the same dtype, and
prints its losses, its f32 global norm, the same norm summed in f64 and
its largest gradient. The decoder's first block normalises an all-zero
target (the queries' target starts at zero), so its gradients are the
product of several LayerNorm backwards at zero variance (1/sqrt(eps) each):
the step is ill-conditioned there and the two packages' magnitudes differ
by orders.
"""

from __future__ import annotations

import argparse
import sys
from contextlib import closing
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _largest(pairs, k=3):
    return sorted(pairs, reverse=True)[:k]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args()

    import numpy as np
    import torch

    from vptr_tpu_torch.cli import _apply_sets
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.models.layers import use_kernels
    from vptr_tpu_torch.train.trainer import Trainer
    from vptr_tpu_torch.utils.weights import export_jax_variables

    over = {"dtype": args.dtype, "mesh": {"data": 1, "model": 1}}
    if args.batch:
        over["data"] = {"batch_size": args.batch}
    cfg = _apply_sets(get_preset("nar_mnist").override(over), args.set)
    trainer = Trainer(cfg, device=args.device, write_outputs=False)
    state = trainer.init_state()
    if args.plain:
        use_kernels(state.transformer, "plain")
    with closing(iter(build_loader(cfg.data, split="train", seed=cfg.seed))) as batches:
        past, future = next(batches)
    variables = {n: export_jax_variables(getattr(state, n))
                 for n in ("enc", "dec", "transformer")} if args.jax else None
    new, m = trainer.train_step(state, *trainer.put_batch(past, future))
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    grads = [(n, p.grad.float()) for n, p in new.transformer.named_parameters()
             if p.grad is not None]
    bad = [(n, int((~torch.isfinite(g)).sum())) for n, g in grads
           if not torch.isfinite(g).all()]
    where = (torch.cuda.get_device_name(0) if trainer.device.type == "cuda" else "CPU")
    print(f"port ({where}, {args.dtype}, batch {cfg.data.batch_size}, "
          f"{'plain' if args.plain else 'kernels'}): "
          + ", ".join(f"{k} {float(v):.6g}" for k, v in m.items()
                      if k in ("T_MSE", "T_GDL", "T_bpc", "T_total", "grad_norm")))
    print(f"  non-finite gradient leaves {len(bad)}: {bad[:6]}")
    print(f"  largest finite |grad|: " + ", ".join(
        f"{v:.4g} {n}" for v, n in _largest(
            (float(g[torch.isfinite(g)].abs().max()), n) for n, g in grads
            if torch.isfinite(g).any())))
    if not args.jax:
        return 0

    import jax
    import jax.numpy as jnp
    import optax

    from vptr_tpu.cli import _apply_sets as japply_sets
    from vptr_tpu.config import get_preset as jget_preset
    from vptr_tpu.models.autoencoder import build_autoencoder as jbuild_ae
    from vptr_tpu.models.transformer import build_transformer as jbuild_tr
    from vptr_tpu.train.state import ModuleState, Stage2TrainState
    from vptr_tpu.train.steps import make_nar_train_step

    jc = japply_sets(jget_preset("nar_mnist").override(over), args.set)
    dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16}[args.dtype]
    # an optax transformation whose state becomes the gradients it is given
    probe = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    enc, dec = jbuild_ae(jc.ae, dtype=dt)
    tr = jbuild_tr(jc.transformer, dtype=dt)
    ms = ModuleState.from_variables
    js = Stage2TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3),
                          transformer=ms(variables["transformer"]),
                          t_opt=probe.init(variables["transformer"]["params"]),
                          enc=ms(variables["enc"]), dec=ms(variables["dec"]),
                          disc=None, d_opt=None)
    step = jax.jit(make_nar_train_step(enc, dec, tr, None, probe, None, jc.loss))
    jnew, jm = step(js, jnp.asarray(past, dt), jnp.asarray(future, dt))
    leaves = jax.tree_util.tree_leaves_with_path(jnew.t_opt)
    f64 = float(np.sqrt(sum(float(np.square(np.asarray(x, np.float64)).sum())
                            for _, x in leaves)))
    print(f"jax (CPU, {args.dtype}): " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in jm.items()
        if k in ("T_MSE", "T_GDL", "T_bpc", "T_total"))
          + f", global norm (f32) {float(optax.global_norm(jnew.t_opt)):.6g}, summed in f64 "
          f"{f64:.6g}")
    jbad = [jax.tree_util.keystr(p) for p, x in leaves
            if not np.isfinite(np.asarray(x, np.float32)).all()]
    print(f"  non-finite gradient leaves {len(jbad)}: {jbad[:6]}")
    print(f"  largest |grad|: " + ", ".join(f"{v:.4g} {n}" for v, n in _largest(
        (float(np.abs(np.asarray(x, np.float64)).max()), jax.tree_util.keystr(p))
        for p, x in leaves)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
