"""Load the JAX package's variables into the port's modules.

``variables`` is what ``jax.tree.map(np.asarray, variables)`` gives for a
flax module: ``{"params": {...}, "batch_stats": {...}}`` as nested dicts of
numpy arrays (the port never imports JAX; callers convert). The port's
module names mirror the JAX tree, so a leaf's path names its target; the
only renames are the flax ``BatchNorm_0`` wrapper (dropped) and the leaf
names. Layout conversions:

* Dense ``kernel`` (in, out)          -> ``nn.Linear.weight`` (out, in)
* Conv ``kernel`` HWIO                 -> ``nn.Conv2d.weight`` OIHW; the
  depthwise (3, 3, 1, C) becomes (C, 1, 3, 3) by the same permutation
* ``TorchConvTranspose`` ``kernel`` HWIO -> ``nn.ConvTranspose2d.weight``
  (in, out, kh, kw). The JAX module flips the kernel at call time and
  correlates the dilated input; ``conv_transpose2d`` does that flip
  itself, so the stored kernel maps over without one.
* LayerNorm / BatchNorm ``scale``      -> ``weight``; BatchNorm ``mean`` /
  ``var`` -> ``running_mean`` / ``running_var``
* ``LayerNormHWC`` (H, W, C) affine    -> (C, H, W)

Every parameter and persistent buffer of the module must be covered, and
every leaf must land somewhere; anything else raises.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Iterator, Tuple

import numpy as np
import torch
from torch import nn

from vptr_tpu_torch.models.layers import LayerNormHWC

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(owner: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if isinstance(owner, nn.Linear):
            return arr.T
        if isinstance(owner, nn.ConvTranspose2d):
            return arr.transpose(2, 3, 0, 1)
        if isinstance(owner, nn.Conv2d):
            return arr.transpose(3, 2, 0, 1)
        raise TypeError(f"a kernel for {type(owner).__name__}")
    if isinstance(owner, LayerNormHWC) and leaf in ("scale", "bias"):
        return arr.transpose(2, 0, 1)
    return arr


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy ``variables`` (see module docstring) into ``module`` in place;
    returns the module."""
    targets = {name: t for name, t in module.state_dict(keep_vars=True).items()
               if not name.endswith("num_batches_tracked")}
    done = set()
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            names = [p for p in path[:-1] if p != "BatchNorm_0"]
            owner = module.get_submodule(".".join(names))
            name = ".".join(names + [_LEAF[path[-1]]])
            if name not in targets:
                raise KeyError(f"JAX leaf {'/'.join(path)} has no target "
                               f"{name!r} in {type(module).__name__}")
            value = np.ascontiguousarray(_convert(owner, path[-1], arr))
            target = targets[name]
            if tuple(target.shape) != value.shape:
                raise ValueError(f"{'/'.join(path)}: {value.shape} does not "
                                 f"fit {name} {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.from_numpy(value))
            done.add(name)
    missing = sorted(set(targets) - done)
    if missing:
        raise KeyError(f"no JAX leaf for {missing}")
    return module
