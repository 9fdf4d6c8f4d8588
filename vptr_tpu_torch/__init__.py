"""vptr_tpu_torch — the PyTorch/CUDA port of vptr_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``vptr_tpu``; it imports torch and
never jax or vptr_tpu. What users run: ``python -m vptr_tpu_torch.cli
train / eval / predict / info / presets`` (``cli``), i.e.
``train.trainer.Trainer`` over the data layer (``data``: the synthetic
Moving MNIST stand-in, the Moving MNIST npz, the KTH and BAIR frame
folders, the prefetching loader), checkpoints (``train.checkpoint``) and
the metrics (``eval.metrics``, ``eval.lpips``, ``eval.harness.evaluate``).
It trains the stage-1 autoencoder with its PatchGAN discriminator
(``train.steps.make_ae_train_step``), serves the FAR and NAR prediction
paths (frozen ResNet encoder, VPTRFormerFAR / VPTRFormerNAR, frozen
decoder, rollouts) and trains both transformers
(``train.steps.make_far_train_step`` / ``make_nar_train_step``, with the
optional GAN term) with CUDA kernels written by hand, forward and backward
(``ops``; sources in ``csrc/``, built with nvcc at first use). Everything
runs on the card unless the caller asks for the CPU (``device="cpu"``,
``--device cpu``).
"""

from vptr_tpu_torch.config import ExperimentConfig, get_preset, list_presets

__all__ = ["ExperimentConfig", "get_preset", "list_presets"]
