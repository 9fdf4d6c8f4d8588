"""Multi-card training of the port: data parallelism over a
``torch.distributed`` process group (:mod:`vptr_tpu_torch.parallel.mesh`)."""

from vptr_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    broadcast_tensors,
    destroy_distributed,
    fold_seed,
    host_id,
    init_distributed,
    make_mesh,
    max_over_ranks,
    num_hosts,
    rank_seed,
)

__all__ = ["Mesh", "all_reduce_grads", "all_reduce_mean", "all_reduce_sum",
           "barrier", "broadcast_tensors", "destroy_distributed", "fold_seed",
           "host_id", "init_distributed", "make_mesh", "max_over_ranks",
           "num_hosts", "rank_seed"]
