"""vptr_tpu_torch — the PyTorch/CUDA port of vptr_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``vptr_tpu``; it imports torch and
never jax or vptr_tpu. It serves the FAR prediction path (frozen ResNet
encoder, VPTRFormerFAR, frozen decoder, ring-buffer rollouts) and trains the
FAR transformer (``train.steps.make_far_train_step``) with CUDA kernels
written by hand, forward and backward: ``ops.fused_window_attention`` and
``ops.attention_core`` (sources in ``csrc/``, built with nvcc at first use).
"""

from vptr_tpu_torch.config import ExperimentConfig, get_preset, list_presets

__all__ = ["ExperimentConfig", "get_preset", "list_presets"]
