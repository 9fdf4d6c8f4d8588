"""Data, tensor and sequence parallelism of the port: one process per card
(or per CPU rank) on a (data, model) mesh of W = data x model ranks that
together compute what one process computes at the global batch.

Counterpart of ``vptr_tpu/parallel/mesh.py``. The JAX package gets its
parallelism from GSPMD: one ``jit`` over a (data, model) mesh averages the
gradients over ``data``, takes the BatchNorm statistics over the global
batch, draws every random bit at the global shape, and, with the
transformer's parameters sharded by ``_TP_RULES`` over ``model``, inserts
the collectives of each sharded product. Here each of those is done by hand
over ``torch.distributed`` groups, as the reference's DDP drivers ran the
data axis (``train_FAR_mp.py:200-204, 295-316, 320-326``):

* :func:`init_distributed` joins the group that ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``): NCCL on the card, gloo on the CPU;
* :func:`make_mesh` lays a config's mesh over the world (rank r at (r //
  model, r % model)) and makes its data and model groups;
* the data axis: :func:`all_reduce_grads` averages every gradient after
  the backward; :func:`all_reduce_sum` (through autograd) gives BatchNorm
  its global sums, :func:`all_reduce_mean` the step metrics their global
  means; :func:`fold_seed` moves a counter-hash dropout mask by an element
  offset, so a kernel on data rank r draws rows r·b .. (r+1)·b of the
  global call's mask;
* the model axis: the autograd collectives of the TP and SP regions
  (:func:`enter_model`, :func:`reduce_model`, :func:`model_sum`,
  :func:`scatter_model`, :func:`gather_model`, :func:`gather_params`), the
  split kernels' exchange of partials (:func:`gather_model_parts`) and
  the port's TP rules (:func:`tp_dim`), by which a whole state is cut to a
  rank's shares (:func:`shard_state`) and gathered back
  (:func:`gather_state`).

Without a process group (or in a group of one) every function here is the
identity and the port runs as one process.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
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
    process. With ``VPTR_RANKS_SHARE_CARDS=1`` in the environment more
    local ranks (``LOCAL_WORLD_SIZE``, as torchrun sets it) than cards
    share them (rank r on card r mod cards, over gloo: NCCL takes one rank
    a card), for a correctness run of a mesh larger than the machine."""
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
        cards = torch.cuda.device_count()
        if (os.environ.get("VPTR_RANKS_SHARE_CARDS") == "1"
                and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > cards):
            local %= cards          # every local rank decides alike: gloo
            backend = backend or "gloo"
        if local >= cards:
            raise RuntimeError(f"LOCAL_RANK {local} names no card: this machine has "
                               f"{cards}")
        torch.cuda.set_device(local)
        backend = backend or "nccl"
        if backend == "nccl":       # bring NCCL up now: a failure raises here
            kwargs["device_id"] = torch.device("cuda", local)
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method="env://", **kwargs)
    return True


def destroy_distributed() -> None:
    """Leave the process group, if one is up (its meshes go with it)."""
    global _ACTIVE
    _ACTIVE = None
    _GROUPS.clear()
    if _group():
        dist.destroy_process_group()


def barrier() -> None:
    if num_hosts() > 1:
        dist.barrier()


@dataclass(frozen=True)
class Mesh:
    """The port's (data, model) device mesh over the process group: ``data``
    ranks along the batch, ``model`` ranks along the transformer's heads
    and hidden channels (tensor parallelism) or its temporal columns
    (sequence parallelism). ``rank`` is this process's rank in the world;
    it sits at (rank // model, rank % model), the order of JAX's
    ``devices.reshape(data, model)``."""

    data: int
    rank: int
    model: int = 1

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


_ACTIVE: Optional[Mesh] = None
_GROUPS: Dict[Tuple[int, int], Tuple[object, object]] = {}


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) mesh of a config over the process group, made the
    active one: ``data`` -1 means the world size over ``model``; data x
    model must equal the world (the JAX package warns and uses a subset of
    its devices; here a subset would leave ranks idle, so it raises). Model
    ranks need one process each: ``model`` > 1 in one process raises, where
    the JAX package splits one process's devices. Under a group, every rank
    must call it with the same shape (it makes the data and model groups,
    once per shape)."""
    global _ACTIVE
    if model < 1:
        raise ValueError(f"mesh.model must be >= 1, got {model}")
    world = num_hosts()
    if model > 1 and world == 1:
        raise NotImplementedError(
            f"mesh.model={model} in one process: the port's tensor and sequence "
            f"parallelism (the TP/SP slice) run one process per model rank; launch "
            f"data x model processes (torchrun --nproc_per_node=...) or set mesh.model "
            f"to 1")
    if world % model:
        raise ValueError(f"mesh.model={model} does not divide the process group's "
                         f"{world} rank(s)")
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(
            f"mesh.data={data} but the process group has {world} rank(s) over "
            f"mesh.model={model}: launch {data * model} processes (torchrun "
            f"--nproc_per_node={data * model}) or set mesh.data to -1")
    mesh = Mesh(data, host_id(), model)
    if model > 1 and (data, model) not in _GROUPS:
        _GROUPS[(data, model)] = _new_groups(data, model, mesh)
    _ACTIVE = mesh
    return mesh


def _new_groups(data: int, model: int, mesh: Mesh):
    """(this rank's data group, its model group): the ranks of its model
    coordinate, and those of its data coordinate. Every rank makes every
    group, in one order, as ``dist.new_group`` asks."""
    mine_model = mine_data = None
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == mesh.data_rank:
            mine_model = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if m == mesh.model_rank:
            mine_data = g
    return mine_data, mine_model


def active_mesh() -> Mesh:
    """The mesh :func:`make_mesh` made last, or the data-parallel one over
    the world (model 1) when it has made none."""
    if _ACTIVE is not None and _ACTIVE.data * _ACTIVE.model == num_hosts():
        return _ACTIVE
    return Mesh(num_hosts(), host_id(), 1)


def data_size() -> int:
    return active_mesh().data


def data_rank() -> int:
    return active_mesh().data_rank


def model_size() -> int:
    return active_mesh().model


def model_rank() -> int:
    return active_mesh().model_rank


def _data_group():
    """The data group of the active mesh (None: the world, model 1)."""
    mesh = active_mesh()
    return None if mesh.model == 1 else _GROUPS[(mesh.data, mesh.model)][0]


def _model_group():
    mesh = active_mesh()
    if mesh.model == 1:
        raise RuntimeError("no model axis: the active mesh has mesh.model = 1")
    return _GROUPS[(mesh.data, mesh.model)][1]


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


def rank_seed(seed: Union[int, torch.Tensor], elements: int,
              index: Optional[int] = None):
    """``seed`` folded for this rank's share of a global-batch kernel call
    whose local call has ``elements`` mask elements: the share is the
    ``index``-th of the call (default: this rank's data coordinate); the
    seed itself at index 0, without a group, and at rate 0 (an int
    seed)."""
    r = data_rank() if index is None else index
    if r == 0 or not isinstance(seed, torch.Tensor):
        return seed
    return fold_seed(seed, r * elements)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy in f32, or f64 for an f64 tensor (the collectives
    run in f32 at least: gloo and NCCL both take it, and partial sums of
    bf16 shares lose nothing)."""
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.to(wide, memory_format=torch.contiguous_format, copy=True)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; its backward sums the output gradients over the
    group too (every rank's loss depends on every rank's input). In f32,
    returned in the input's dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = _f32(x)
        dist.all_reduce(out, group=group)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        out = _f32(g)
        dist.all_reduce(out, group=ctx.group)
        return out.to(g.dtype), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis (every rank of the data group holds
    other rows), differentiable; ``x`` itself on one data rank."""
    return _AllReduceSum.apply(x, _data_group()) if data_size() > 1 else x


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group, forward and backward: statistics
    over channels split across the model ranks (LayerNormHWC's moments
    over the conv FFN's hidden); ``x`` itself without a model axis."""
    return _AllReduceSum.apply(x, _model_group()) if model_size() > 1 else x


def gather_model_parts(x: torch.Tensor) -> torch.Tensor:
    """Every model rank's ``x`` (f32 partials: a split kernel's per-tile
    moments or sums), stacked in rank order on a new leading dim (M, ...):
    every rank holds the same bits, so a merge of them in a fixed order is
    the same on every rank. Not differentiable (a kernel's exchange)."""
    if model_size() == 1:
        return x[None]
    group = _model_group()
    x32 = _f32(x)
    parts = [torch.empty_like(x32) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x32, group=group)
    return torch.stack(parts)


def all_reduce_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's mean over the data axis, in one all-reduce of their
    f32 values; each comes back in its own shape and dtype (the model ranks
    of a data group hold the same values)."""
    w = data_size()
    if w == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=_data_group())
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


def all_reduce_grads(params: Union[Dict[str, torch.Tensor], Iterable[torch.Tensor]],
                     sharded: Iterable[str] = ()) -> None:
    """Every parameter's ``.grad`` set to its mean over the ranks, after the
    whole backward: a model rank's shares (the names in ``sharded``) over
    the data group, each averaged with the same share of the other data
    ranks; every other leaf, which the model ranks of a data group compute
    alike, over the whole world (the same mean, and the same bits on every
    rank: the card's backward is not bit-reproducible, so replicas of a
    leaf would drift apart otherwise). One flat sum a set, divided by its
    ranks. A parameter whose ``.grad`` is None gets zeros first (as
    ``jax.grad`` gives it), in one process too."""
    named = (list(params.items()) if isinstance(params, dict)
             else [(None, p) for p in params])
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    world = num_hosts()
    if world == 1:
        return
    sharded = set(sharded)
    replicated = [p.grad for n, p in named if n not in sharded]
    shares = [p.grad for n, p in named if n in sharded]

    def mean(ranks, group):
        def run(flat):
            dist.all_reduce(flat, group=group)
            flat /= ranks
        return run

    with torch.no_grad():
        if replicated:
            _coalesced(replicated, mean(world, None))
        if shares and data_size() > 1:
            _coalesced(shares, mean(data_size(), _data_group()))


def broadcast_tensors(tensors: Iterable[torch.Tensor]) -> None:
    """The first data rank's values into every rank's ``tensors`` along the
    data axis, in place, one broadcast per dtype (under a model axis each
    model rank's shares come from the first data rank of its model
    coordinate)."""
    if data_size() == 1:
        return
    mesh = active_mesh()
    src, group = mesh.model_rank, _data_group()   # the global rank of (0, model_rank)
    with torch.no_grad():
        _coalesced([t for t in tensors if t.numel()],
                   lambda flat: dist.broadcast(flat, src=src, group=group))


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


# ------------------------------------------------------------------ the model axis
#
# The collectives of the tensor-parallel (TP) and sequence-parallel (SP)
# regions, as autograd Functions over the model group. Each one's backward
# follows from whether its output's consumers are replicated or split
# across the model ranks (the Megatron pattern that GSPMD derives for the
# JAX package from _TP_RULES' shardings). All run in f32.

class _EnterModel(torch.autograd.Function):
    """Copy into the TP region: forward the identity; backward the sum of
    the gradients over the model group (each rank's consumers -- its heads,
    its hidden channels -- give a share). One all-reduce for all inputs."""

    @staticmethod
    def forward(ctx, *ts):
        ctx.group, ctx.dtypes = _model_group(), [t.dtype for t in ts]
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros((), dtype=torch.float32) if g is None else g for g in gs]
        shapes = [g.shape for g in gs]
        flat = torch.cat([g.float().reshape(-1) for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        out, at = [], 0
        for shape, dt in zip(shapes, ctx.dtypes):
            n = int(np.prod(shape)) if len(shape) else 1
            out.append(flat[at:at + n].view(shape).to(dt))
            at += n
        return tuple(out)


def enter_model(*tensors: Optional[torch.Tensor]) -> Tuple[Optional[torch.Tensor], ...]:
    """``tensors`` into the TP region: the same values; the gradients of
    those that take one are summed over the model group in the backward.
    None passes through; so does a tensor no backward reaches."""
    if model_size() == 1:
        return tensors
    at = [i for i, t in enumerate(tensors) if t is not None and t.requires_grad
          and torch.is_grad_enabled()]
    if not at:
        return tensors
    moved = _EnterModel.apply(*(tensors[i] for i in at))
    out = list(tensors)
    for i, t in zip(at, moved):
        out[i] = t
    return tuple(out)


class _ReduceModel(torch.autograd.Function):
    """Out of the TP region: forward the sum of the ranks' partial outputs
    (in f32); backward the identity (every rank's consumers are
    replicated), cast to the input's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        out = _f32(x)
        dist.all_reduce(out, group=_model_group())
        return out

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of each rank's partial ``x`` (a
    row-parallel product's), f32; ``x`` in f32 without a model axis."""
    return _ReduceModel.apply(x) if model_size() > 1 else x.float()


def _share(x: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"{tuple(x.shape)} does not split into {size} equal shares "
                         f"along dim {dim}")
    return x.narrow(dim, rank * (n // size), n // size)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model ranks' shares of ``x`` concatenated along ``dim``, in x's
    dtype (gathered in f32)."""
    x32 = _f32(x)
    parts = [torch.empty_like(x32) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x32, group=group)
    return torch.cat(parts, dim).to(x.dtype)


class _Scatter(torch.autograd.Function):
    """SP scatter along dim 0: forward this rank's share; backward the
    ranks' share gradients gathered."""

    @staticmethod
    def forward(ctx, x):
        ctx.group = _model_group()
        return _share(x, 0, model_size(), model_rank()).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 0, ctx.group)


class _Gather(torch.autograd.Function):
    """SP gather along dim 0: forward the shares gathered; backward this
    rank's share of the gradient."""

    @staticmethod
    def forward(ctx, x):
        return _all_gather(x, 0, _model_group())

    @staticmethod
    def backward(ctx, g):
        return _share(g, 0, model_size(), model_rank()).contiguous()


def scatter_model(x: torch.Tensor) -> torch.Tensor:
    """This model rank's contiguous share of ``x``'s rows (dim 0)."""
    return _Scatter.apply(x) if model_size() > 1 else x


def gather_model(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' row shares of a tensor, concatenated in rank order."""
    return _Gather.apply(x) if model_size() > 1 else x


class _GatherParams(torch.autograd.Function):
    """A sublayer's parameters whole for an SP call: each sharded one (its
    dim in ``dims``, None for a replicated one) gathered along its dim;
    backward: every gradient summed over the model group (each rank's call
    saw its share of the tokens), then this rank's share of a sharded one.
    One all-reduce for all of them."""

    @staticmethod
    def forward(ctx, dims, *ps):
        ctx.dims, ctx.group = dims, _model_group()
        return tuple(p.view_as(p) if d is None else _all_gather(p.detach(), d, ctx.group)
                     for p, d in zip(ps, dims))

    @staticmethod
    def backward(ctx, *gs):
        shapes = [g.shape for g in gs]
        flat = torch.cat([g.float().reshape(-1) for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        out, at = [], 0
        for shape, d, g in zip(shapes, ctx.dims, gs):
            n = int(np.prod(shape))
            full = flat[at:at + n].view(shape).to(g.dtype)
            at += n
            out.append(full if d is None else
                       _share(full, d, model_size(), model_rank()).contiguous())
        return (None,) + tuple(out)


def gather_params(params: List[torch.Tensor], dims: List[Optional[int]]
                  ) -> List[torch.Tensor]:
    """``params`` whole on every model rank (see :class:`_GatherParams`);
    themselves without a model axis."""
    if model_size() == 1:
        return list(params)
    return list(_GatherParams.apply(tuple(dims), *params))


# ------------------------------------------------------------------ the TP rules
#
# The port's copy of vptr_tpu/parallel/mesh.py:73-85 (_TP_RULES), on the
# port's parameter names and in torch's layouts: q/k/v projections and the
# linear FFN's linear1 and the conv FFN's fc1 and dw3x3 shard their output
# features (heads / hidden: dim 0 of an nn.Linear (out, in) or nn.Conv2d
# (out, in, kh, kw) weight, and their biases); out_proj, linear2 and fc2
# their input features (dim 1). Beyond JAX's rules, the tensors that only
# the rank's heads or hidden channels use shard with them (the JAX package
# replicates these; the numerics are the same): a window sublayer's RPE
# table (heads, dim 1), and the conv FFN's norm1 / norm2 over the hidden
# (LayerNormHWC affines (hidden, h, w), BatchNorm scale, bias and running
# statistics). Everything else is replicated.

_TP_RULES = (
    (r"(.*\.)?attn\.(q_proj|k_proj|v_proj)\.(weight|bias)$", 0),
    (r"(.*\.)?attn\.out_proj\.weight$", 1),
    (r"(.*\.)?ffn\.linear1\.(weight|bias)$", 0),
    (r"(.*\.)?ffn\.linear2\.weight$", 1),
    (r"(.*\.)?spatial_ffn2?\.(fc1|dw3x3)\.(weight|bias)$", 0),
    (r"(.*\.)?spatial_ffn2?\.fc2\.weight$", 1),
    (r"(.*\.)?spatial_ffn2?\.norm[12]\.(weight|bias|running_mean|running_var)$", 0),
    (r"(.*\.)?slmhsa\.rpe_table$", 1),
)


def tp_dim(name: str) -> Optional[int]:
    """The dim along which the TP rules shard the tensor ``name`` (a
    parameter or buffer name of a transformer, or of its optimizer
    moments), None for a replicated one."""
    for pattern, dim in _TP_RULES:
        if re.match(pattern, name):
            return dim
    return None


def shard_of(name: str, full: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    """Model rank ``rank``'s share (of ``size``) of the whole tensor ``name``
    (a view; the whole tensor for a replicated one)."""
    dim = tp_dim(name)
    return full if dim is None or size == 1 else _share(full, dim, size, rank)


def gather_tensor(shard: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor from the model ranks' shares along ``dim`` (a
    collective: every model rank calls it)."""
    return _all_gather(shard.detach(), dim, _model_group())


def gather_state(tensors: Dict[str, torch.Tensor], shards: Dict[str, int]
                 ) -> Dict[str, torch.Tensor]:
    """``tensors`` (name -> tensor) with each sharded one (``shards``: name
    -> dim) gathered whole; a collective every model rank calls with the
    same names."""
    if not shards or model_size() == 1:
        return dict(tensors)
    return {n: gather_tensor(t, shards[n]) if n in shards else t
            for n, t in tensors.items()}


def shard_state(tensors: Dict[str, torch.Tensor], shards: Dict[str, int]
                ) -> Dict[str, torch.Tensor]:
    """Whole ``tensors`` cut to this model rank's shares (``shards``: name
    -> dim of the sharded ones)."""
    if not shards or model_size() == 1:
        return dict(tensors)
    m, r = model_size(), model_rank()
    return {n: _share(t, shards[n], m, r).contiguous() if n in shards else t
            for n, t in tensors.items()}
