"""Data parallelism of the port: one process per card (or per CPU rank),
W ranks that together compute what one process computes at the global
batch.

Counterpart of ``vptr_tpu/parallel/mesh.py:28-50,170-182``. The JAX package
gets data parallelism from GSPMD: one ``jit`` over a (data, model) mesh
averages the gradients, takes the BatchNorm statistics over the global
batch and draws every random bit at the global shape by itself. Here each
of those is done by hand over the default ``torch.distributed`` process
group, as the reference's DDP drivers ran it (``train_FAR_mp.py:200-204,
295-316, 320-326``):

* :func:`init_distributed` joins the group that ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``): NCCL on the card, gloo on the CPU;
* :func:`make_mesh` checks a config's mesh against the world: the data axis
  is the world, the model axis (tensor / sequence parallelism) is refused;
* :func:`all_reduce_grads` averages every gradient after the backward, in
  one flat all-reduce;
* :func:`all_reduce_sum` (through autograd) gives BatchNorm its global sums,
  :func:`all_reduce_mean` the step metrics their global means;
* :func:`fold_seed` moves a counter-hash dropout mask by an element offset,
  so a kernel on rank r draws rows r·b .. (r+1)·b of the global call's mask.

Without a process group (or in a group of one) every function here is the
identity and the port runs as one process.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Union

import torch
import torch.distributed as dist

# GOLDEN (ops/dropout.py, csrc/hash_dropout.cuh) times this is 1 mod 2^32
GOLDEN_INVERSE = 0x144CBC89
_U32 = 0xFFFFFFFF
_LAUNCH = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def num_hosts() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if _group() else 1


def host_id() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _group() else 0


def init_distributed(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group a launcher describes in the environment
    (``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``); returns whether a group is up.

    A no-op (False) without those variables, or when a group is up already.
    On a CUDA ``device`` the card ``LOCAL_RANK`` becomes the current one
    first (``resolve_device("cuda")`` takes the current card), and the
    backend is NCCL unless the caller names another; on the CPU it is gloo.
    A failure to bring NCCL up raises: nothing falls back to gloo or to one
    process."""
    if _group():
        return True
    if not all(os.environ.get(v) for v in _LAUNCH):
        return False
    device = torch.device(device)
    kwargs = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: a CUDA device was requested but "
                               "torch.cuda.is_available() is False")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} names no card: this machine has "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local)
        backend = backend or "nccl"
        if backend == "nccl":       # bring NCCL up now: a failure raises here
            kwargs["device_id"] = torch.device("cuda", local)
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method="env://", **kwargs)
    return True


def destroy_distributed() -> None:
    """Leave the process group, if one is up."""
    if _group():
        dist.destroy_process_group()


def barrier() -> None:
    if num_hosts() > 1:
        dist.barrier()


@dataclass(frozen=True)
class Mesh:
    """The port's device mesh: ``data`` ranks, each holding the whole model
    (no model axis yet); ``rank`` is this process's place on it."""

    data: int
    rank: int


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) mesh of a config over the process group: ``data``
    -1 means the world size, an explicit ``data`` must equal it (the JAX
    package warns and uses a subset of its devices; here a subset would
    leave ranks idle, so it raises), ``model`` must be 1."""
    if model > 1:
        raise NotImplementedError(
            f"mesh.model={model}: tensor and sequence parallelism (the TP/SP "
            f"slice: the model axis, _TP_RULES and sequence_parallel) are not "
            f"ported yet; set mesh.model to 1")
    if model != 1:
        raise ValueError(f"mesh.model must be >= 1, got {model}")
    world = num_hosts()
    if data == -1:
        data = world
    if data != world:
        raise ValueError(
            f"mesh.data={data} but the process group has {world} rank(s): launch "
            f"{data} processes (torchrun --nproc_per_node={data}) or set "
            f"mesh.data to -1")
    return Mesh(data, host_id())


def fold_seed(seed: Union[int, torch.Tensor], offset: int):
    """The seed whose counter-hash mask at element index i is ``seed``'s at
    i + ``offset`` (mod 2^32).

    The hash starts from x = idx + seed·GOLDEN (mod 2^32) with GOLDEN odd,
    so idx + offset gives the same x as idx with the seed seed +
    offset·GOLDEN^-1. A kernel call on rank r over its b samples, N mask
    elements, runs with ``fold_seed(seed, r * N)`` and draws the mask of
    rows r·b .. (r+1)·b of the call at the global batch (the index is
    sample-major). Returns the int32 bit pattern: an int for an int seed,
    an int32 tensor on the seed's device for a tensor seed (no host
    synchronisation)."""
    add = (offset * GOLDEN_INVERSE) & _U32
    if isinstance(seed, torch.Tensor):
        s = (seed.to(torch.int64) + add) & _U32
        return ((s ^ 0x80000000) - 0x80000000).to(torch.int32)
    s = (int(seed) + add) & _U32
    return (s ^ 0x80000000) - 0x80000000


def rank_seed(seed: Union[int, torch.Tensor], elements: int):
    """``seed`` folded for this rank's share of a global-batch kernel call
    whose local call has ``elements`` mask elements; the seed itself on
    rank 0, without a group, and at rate 0 (an int seed)."""
    r = host_id()
    if r == 0 or not isinstance(seed, torch.Tensor):
        return seed
    return fold_seed(seed, r * elements)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the output gradients over the
    ranks too (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable; ``x`` itself in one
    process."""
    return _AllReduceSum.apply(x) if num_hosts() > 1 else x


def all_reduce_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's mean over the ranks, in one all-reduce of their f32
    values; each comes back in its own shape and dtype."""
    w = num_hosts()
    if w == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= w
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def _coalesced(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective`` on one flat buffer per dtype of ``tensors`` and
    copy the results back into them, in place."""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        at = 0
        for t in group:
            t.copy_(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()


def all_reduce_grads(params: Union[Dict[str, torch.Tensor], Iterable[torch.Tensor]]
                     ) -> None:
    """Every parameter's ``.grad`` set to its mean over the ranks: one flat
    sum of all of them, divided by W, after the whole backward. A
    parameter whose ``.grad`` is None gets zeros first (as ``jax.grad``
    gives it), in one process too."""
    ps = list(params.values() if isinstance(params, dict) else params)
    for p in ps:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    w = num_hosts()
    if w == 1:
        return

    def mean(flat):
        dist.all_reduce(flat)
        flat /= w

    with torch.no_grad():
        _coalesced([p.grad for p in ps], mean)


def broadcast_tensors(tensors: Iterable[torch.Tensor]) -> None:
    """Rank 0's values into every rank's ``tensors``, in place, one
    broadcast per dtype."""
    if num_hosts() == 1:
        return
    with torch.no_grad():
        _coalesced([t for t in tensors if t.numel()],
                   lambda flat: dist.broadcast(flat, src=0))


def max_over_ranks(value: float) -> float:
    """The largest of the ranks' ``value`` (a host number, such as a time)."""
    if num_hosts() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64,
                     device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _collective_device() -> torch.device:
    """Where a host value goes for a collective: the current card under
    NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
