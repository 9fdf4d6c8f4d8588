"""The stage-2 optimizer: clip-by-global-norm -> adam / adamw, as plain
functions on tensors with optax's semantics (not ``torch.optim``'s).

Counterpart of ``vptr_tpu/losses.py::build_optimizer`` (``:145-164``), i.e.
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(lr, b1, b2,
weight_decay=wd, mu_dtype=mu_dtype))`` in optax 0.2.6:

* clip: with n the global norm, g -> g when n < max_norm, else
  (g / n) * max_norm (``torch.nn.utils.clip_grad_norm_`` scales by
  max_norm / (n + 1e-6) instead);
* ``scale_by_adam``: mu = (1 - b1) g + b1 mu_old, where ``b1 * mu_old`` is
  a product in mu's dtype (JAX rounds the Python constant to a bf16 or f16 mu's
  dtype); nu = (1 - b2) g^2 + b2 nu_old in f32; the update
  mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) uses the f32 mu, which is
  then stored in ``mu_dtype`` (``OptimConfig.mu_dtype``, bf16 by default);
* ``add_decayed_weights`` (adamw): u + wd * p on every leaf;
* ``scale_by_learning_rate``: u * -lr, lr a constant or the Noam schedule
  of the step count before this update;
* :func:`apply_updates`: p + u, in place.

Under tensor parallelism (a model axis) a sharded leaf holds the rank's
share: the clip's global norm is the square root of the replicated leaves'
squares plus the model group's sum of the sharded leaves' squares, the
same number on every rank; AdamW and the bf16 first moment act on the
shares as they are (every step is elementwise).

Parameters, gradients and moments are dicts name -> tensor in one order;
the moments live on the parameters' device. The arithmetic runs as
``torch._foreach_*`` ops (a few launches per step instead of a dozen per
leaf) with Python-float constants, which are f32 in an f32 op as optax's
are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple

import torch

from vptr_tpu_torch.losses import noam_schedule
from vptr_tpu_torch.parallel.mesh import model_sum

_MU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}


@dataclass
class AdamState:
    """Step count (the number of updates so far) and the two moments."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    def clone(self) -> "AdamState":
        return AdamState(self.count,
                         {k: v.clone() for k, v in self.mu.items()},
                         {k: v.clone() for k, v in self.nu.items()})


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params,
    sharded=()) -> (updates, new_state, grad_norm)``, grad_norm the 0-d
    global norm of the gradients before clipping (``sharded``: the names of
    the leaves that hold a model rank's share)."""

    init: Callable
    update: Callable


def global_norm(tensors, sharded=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, a 0-d f32 tensor.
    ``sharded``: one flag a tensor, True for a model rank's share of a
    whole leaf; their squares are summed over the model group."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).square()
    flags = torch.tensor(sharded, device=sq.device)
    rep_sq, shard_sq = sq[~flags].sum(), sq[flags].sum()
    return torch.sqrt(rep_sq + model_sum(shard_sq))


def clip_by_global_norm(grads, max_norm: float, sharded=None):
    """(clipped list, norm): optax's rule, without a host synchronisation
    (the choice is made on the device); ``sharded`` as :func:`global_norm`'s."""
    norm = global_norm(grads, sharded)
    clip = norm >= max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    div = torch.where(clip, norm, one)
    mul = torch.where(clip, torch.full_like(norm, max_norm), one)
    return torch._foreach_mul(torch._foreach_div(list(grads), div), mul), norm


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> None:
    """p += u for every leaf, in place (the port updates parameters in
    place; JAX returns new arrays)."""
    with torch.no_grad():
        torch._foreach_add_([params[k] for k in updates], list(updates.values()))


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, mu_dtype: torch.dtype = torch.float32,
         max_grad_norm=None) -> Optimizer:
    """[clip ->] adam (weight_decay 0) or adamw; ``learning_rate`` a float
    or a function of the step count."""
    b1_mu = torch.tensor(b1, dtype=mu_dtype).item()   # the constant in mu's dtype

    def init(params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            0, {k: torch.zeros_like(p, dtype=mu_dtype) for k, p in params.items()},
            {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()})

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: AdamState,
               params: Dict[str, torch.Tensor], sharded=()):
        names = list(grads)
        g = [grads[k].float() for k in names]
        flags = [k in sharded for k in names] if sharded else None
        if max_grad_norm is not None:
            g, norm = clip_by_global_norm(g, max_grad_norm, flags)
        else:
            norm = global_norm(g, flags)
        count = state.count + 1
        mu = torch._foreach_mul(g, 1.0 - b1)
        mu_old = torch._foreach_mul([state.mu[k] for k in names], b1_mu)
        mu = torch._foreach_add(mu, [m.float() for m in mu_old])
        nu = torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2)
        torch._foreach_add_(nu, torch._foreach_mul([state.nu[k] for k in names], b2))
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        bc1 = (1.0 - f32(b1) ** count).item()
        bc2 = (1.0 - f32(b2) ** count).item()
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if weight_decay:
            u = torch._foreach_add(u, torch._foreach_mul(
                [params[k].float() for k in names], weight_decay))
        lr = (learning_rate(state.count).item() if callable(learning_rate)
              else f32(learning_rate).item())
        torch._foreach_mul_(u, -lr)
        new = AdamState(count, {k: m.to(mu_dtype) for k, m in zip(names, mu)},
                        dict(zip(names, nu)))
        return dict(zip(names, u)), new, norm

    return Optimizer(init, update)


def build_optimizer(cfg, d_model: int = 528) -> Optimizer:
    """The optimizer of an OptimConfig: optional clip-by-global-norm, then
    adam or adamw at a constant lr or the Noam schedule, with the first
    moment in ``cfg.mu_dtype``."""
    if cfg.schedule == "noam":
        lr = noam_schedule(d_model, cfg.noam_factor, cfg.noam_warmup_steps)
    elif cfg.schedule == "constant":
        lr = cfg.lr
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.mu_dtype not in _MU_DTYPES:
        raise ValueError(f"mu_dtype must be one of {sorted(_MU_DTYPES)}, "
                         f"got {cfg.mu_dtype!r}")
    if cfg.optimizer == "adamw":
        wd = cfg.weight_decay
    elif cfg.optimizer == "adam":
        wd = 0.0
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return adam(lr, cfg.b1, cfg.b2, weight_decay=wd,
                mu_dtype=_MU_DTYPES[cfg.mu_dtype],
                max_grad_norm=cfg.max_grad_norm)
