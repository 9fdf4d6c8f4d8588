"""Move variables between the JAX package's trees and the port's modules.

:func:`load_jax_variables` loads JAX variables into a module;
:func:`export_jax_variables` is the reverse direction (a module's
parameters, or tensors in their place such as their ``.grad``, as the JAX
tree), so gradients and updated parameters compare leaf for leaf.

``variables`` is what ``jax.tree.map(np.asarray, variables)`` gives for a
flax module: ``{"params": {...}, "batch_stats": {...}}`` as nested dicts of
numpy arrays (the port never imports JAX; callers convert). The port's
module names mirror the JAX tree, so a leaf's path names its target and
only the leaf names change. That includes the names flax gives a norm
inside a module: the autoencoder's ``_NormAct`` holds its norm as a child
named ``BatchNorm_0`` or ``GroupNorm_0`` (none for ``norm="none"``), as
the JAX ``_NormAct`` does, while the discriminator's ``norm{n}`` and the
transformer's norms are named directly, so the place of a norm in the tree
decides its path, not its class. Layout conversions:

* Dense ``kernel`` (in, out)          -> ``nn.Linear.weight`` (out, in)
* Conv ``kernel`` HWIO                 -> ``nn.Conv2d.weight`` OIHW; the
  depthwise (3, 3, 1, C) becomes (C, 1, 3, 3) by the same permutation
* ``TorchConvTranspose`` ``kernel`` HWIO -> ``nn.ConvTranspose2d.weight``
  (in, out, kh, kw). The JAX module flips the kernel at call time and
  correlates the dilated input; ``conv_transpose2d`` does that flip
  itself, so the stored kernel maps over without one.
* LayerNorm / BatchNorm / GroupNorm ``scale`` -> ``weight``; BatchNorm
  ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
* ``LayerNormHWC`` (H, W, C) affine    -> (C, H, W)
* bare parameters (``rpe_table`` of a window attention, the NAR
  ``frame_queries``) keep their names and layouts
* a ``scan_layers`` stack (a
  :class:`~vptr_tpu_torch.models.transformer.BlockStack`: JAX
  ``<stack>/block/...`` with every leaf, ``params`` and ``batch_stats``,
  stacked on axis 0) -> one leaf per block, ``<stack>.{i}...``; exported,
  the blocks' leaves are stacked back

Every parameter and persistent buffer of the module must be covered, and
every leaf must land somewhere; anything else raises. Each conversion is a
transpose, so it maps gradients as it maps weights.

A transformer sharded over a model axis
(:func:`~vptr_tpu_torch.models.transformer.shard_transformer`) loads the
whole JAX tree and keeps this rank's share of each sharded leaf; exported,
its shares are gathered whole first (a collective every model rank calls),
so both directions speak the one-process tree. Under ``scan_layers`` a
stacked JAX leaf is sliced into the blocks before the shares are cut (the
JAX rules shard such a leaf along another axis; the numbers are the same).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Mapping as MappingT, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vptr_tpu_torch.models.layers import LayerNormHWC
from vptr_tpu_torch.models.transformer import BlockStack, tp_shards
from vptr_tpu_torch.parallel.mesh import gather_state, shard_state

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var",
         "rpe_table": "rpe_table", "frame_queries": "frame_queries"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _stacks(module: nn.Module) -> Dict[str, int]:
    """{dotted name: block count} of the module's scan_layers stacks."""
    return {name: len(m) for name, m in module.named_modules()
            if isinstance(m, BlockStack)}


def _unstacked(stacks: Dict[str, int], path: Tuple[str, ...], arr: np.ndarray):
    """(path, array) pairs of one JAX leaf: a stacked leaf of a stack
    (``<stack>/block/...``) as one leaf a block (``<stack>/<i>/...``),
    any other leaf as it is."""
    for j in range(1, len(path) - 1):
        n = stacks.get(".".join(path[:j]))
        if n is not None and path[j] == "block":
            if arr.shape[:1] != (n,):
                raise ValueError(f"{'/'.join(path)}: {arr.shape} is not stacked over "
                                 f"the {n} blocks of {'.'.join(path[:j])}")
            return [(path[:j] + (str(i),) + path[j + 1:], arr[i]) for i in range(n)]
    return [(path, arr)]


def _restack(tree: dict, stacks: Dict[str, int]) -> None:
    """In place: each stack's per-block subtrees ``<stack>/<i>/...`` of the
    exported ``tree`` as one ``<stack>/block/...`` whose leaves stack the
    blocks' on axis 0."""
    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    for name, n in stacks.items():
        *parents, last = name.split(".")
        node = tree
        for k in parents:
            node = node.get(k, {})
        if last in node:
            node[last] = {"block": stack([node[last][str(i)] for i in range(n)])}


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
    stacks = _stacks(module)
    shards = tp_shards(module)
    done = set()
    for collection in ("params", "batch_stats"):
        for path, arr in (pair for leaf in _leaves(variables.get(collection, {}))
                          for pair in _unstacked(stacks, *leaf)):
            names = list(path[:-1])
            owner = module.get_submodule(".".join(names))
            name = ".".join(names + [_LEAF[path[-1]]])
            if name not in targets:
                raise KeyError(f"JAX leaf {'/'.join(path)} has no target "
                               f"{name!r} in {type(module).__name__}")
            value = np.ascontiguousarray(_convert(owner, path[-1], arr))
            if name in shards:        # this model rank's share of the whole leaf
                value = shard_state({name: torch.from_numpy(value)}, shards)[name].numpy()
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


_INV_LEAF = {"weight": "kernel", "bias": "bias", "running_mean": "mean",
             "running_var": "var", "rpe_table": "rpe_table",
             "frame_queries": "frame_queries"}


def _export(owner: nn.Module, leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """(JAX leaf name, array in the JAX layout) of one torch leaf."""
    if leaf == "weight":
        if isinstance(owner, nn.Linear):
            return "kernel", arr.T
        if isinstance(owner, nn.ConvTranspose2d):
            return "kernel", arr.transpose(2, 3, 0, 1)
        if isinstance(owner, nn.Conv2d):
            return "kernel", arr.transpose(2, 3, 1, 0)
        if isinstance(owner, LayerNormHWC):
            return "scale", arr.transpose(1, 2, 0)
        return "scale", arr                 # LayerNorm / BatchNorm / GroupNorm
    if leaf == "bias" and isinstance(owner, LayerNormHWC):
        return "bias", arr.transpose(1, 2, 0)
    return _INV_LEAF[leaf], arr


def export_jax_variables(module: nn.Module,
                         tensors: Optional[MappingT[str, torch.Tensor]] = None
                         ) -> Dict[str, dict]:
    """The module's variables as the JAX tree: ``{"params": ...,
    "batch_stats": ...}`` of nested dicts of f32 numpy arrays (the inverse
    of :func:`load_jax_variables`; a scan_layers stack's leaves stacked).
    With ``tensors`` (name -> tensor for every parameter, e.g. ``{n:
    p.grad}``) those take the parameters' places and only ``"params"`` is
    returned."""
    out: Dict[str, dict] = {"params": {}}
    if tensors is None:
        out["batch_stats"] = {}
        items = [(n, t) for n, t in module.state_dict(keep_vars=True).items()
                 if not n.endswith("num_batches_tracked")]
    else:
        items = list(tensors.items())
        missing = sorted(set(dict(module.named_parameters())) - set(tensors))
        if missing:
            raise KeyError(f"no tensor for parameters {missing}")
    items = list(gather_state(dict(items), tp_shards(module)).items())
    for name, t in items:
        path = name.split(".")
        owner = module.get_submodule(".".join(path[:-1]))
        leaf, arr = _export(owner, path[-1],
                            t.detach().float().cpu().numpy())
        collection = ("batch_stats" if path[-1].startswith("running_")
                      else "params")
        if collection not in out:
            continue
        node = out[collection]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[leaf] = np.array(arr, order="C")      # a copy, never a view of t
    if tensors is None and not out["batch_stats"]:
        del out["batch_stats"]
    stacks = _stacks(module)
    for tree in out.values():
        _restack(tree, stacks)
    return out


def ae_train_state_from_jax(variables: MappingT[str, Optional[Mapping]], enc: nn.Module,
                            dec: nn.Module, disc: Optional[nn.Module], g_optimizer,
                            d_optimizer=None, seed: int = 0):
    """The port's stage-1 state from a JAX ``AETrainState``'s modules:
    ``variables`` maps "enc", "dec" and "disc" (None without the GAN term) to
    ``{"params": ..., "batch_stats": ...}`` of numpy arrays (a JAX
    ``ModuleState``'s params and stats). They are loaded into ``enc``, ``dec``
    and ``disc``, which :func:`vptr_tpu_torch.train.state.create_ae_train_state`
    then takes with fresh optimizer states (the JAX package's at step 0)."""
    from vptr_tpu_torch.train.state import create_ae_train_state

    load_jax_variables(enc, variables["enc"])
    load_jax_variables(dec, variables["dec"])
    if disc is not None:
        load_jax_variables(disc, variables["disc"])
    return create_ae_train_state(enc, dec, disc, g_optimizer, d_optimizer, seed)
