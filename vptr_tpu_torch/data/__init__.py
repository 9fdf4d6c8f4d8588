"""The data layer of the port: numpy datasets, transforms and the
prefetching loader, batch for batch the JAX package's."""

from vptr_tpu_torch.data.datasets import (  # noqa: F401
    ClipDataset,
    MovingMNISTNpz,
    SyntheticMovingMNIST,
    bair_dataset,
    chop_clips,
    kth_dataset,
)
from vptr_tpu_torch.data.loader import ClipLoader, build_dataset, build_loader  # noqa: F401
from vptr_tpu_torch.data.transforms import (  # noqa: F401
    ClipTransform,
    Normalize,
    ReNormalize,
)
