"""Multi-card training of the port: data, tensor and sequence parallelism
over ``torch.distributed`` process groups (:mod:`vptr_tpu_torch.parallel.mesh`)."""

from vptr_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    all_reduce_grads,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    broadcast_tensors,
    data_rank,
    data_size,
    destroy_distributed,
    fold_seed,
    host_id,
    init_distributed,
    make_mesh,
    max_over_ranks,
    model_rank,
    model_size,
    num_hosts,
    rank_seed,
    tp_dim,
)

__all__ = ["Mesh", "active_mesh", "all_reduce_grads", "all_reduce_mean",
           "all_reduce_sum", "barrier", "broadcast_tensors", "data_rank",
           "data_size", "destroy_distributed", "fold_seed", "host_id",
           "init_distributed", "make_mesh", "max_over_ranks", "model_rank",
           "model_size", "num_hosts", "rank_seed", "tp_dim"]
