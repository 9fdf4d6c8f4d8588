"""Train states of the port: stage 1 (autoencoder + discriminator) and
stage 2 (transformer over a frozen autoencoder).

Counterparts of ``vptr_tpu/train/state.py::AETrainState`` and
``Stage2TrainState`` and of the state creation in
``vptr_tpu/train/trainer.py:199-230``. JAX's states are immutable and hold
parameter trees; here the modules hold the parameters (and their BatchNorm
running statistics, as buffers) and the steps update them in place. Each
state carries the step count, the ``torch.Generator`` of the step's random
draws and the optimizer states. ``clone()`` gives an independent copy of
everything the step changes (the trained modules, the optimizer states,
the generator; a stage-2 state shares its frozen encoder and decoder), so
two steps can start from one state.

With the GAN term (``loss.lam_gan``) a state also holds the PatchGAN
discriminator and its own optimizer state (``cfg.optim_d``); both are None
without it.

Under a process group of W > 1 ranks every rank starts from the same
state: each builds it from the same seed, and creation copies rank 0's
parameters and buffers to the others (:func:`replicate`), so no rank can
start from different weights; a restore loads the same file on every
rank.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from vptr_tpu_torch.parallel.mesh import broadcast_tensors
from vptr_tpu_torch.train.optim import AdamState, Optimizer


def replicate(*modules: Optional[nn.Module]) -> None:
    """Rank 0's parameters and persistent buffers of ``modules`` on every
    rank, in place; nothing in one process."""
    broadcast_tensors([t for m in modules if m is not None
                       for t in m.state_dict().values()])


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _copy(module: Optional[nn.Module]) -> Optional[nn.Module]:
    return None if module is None else copy.deepcopy(module)


def _clone_opt(opt_state: Optional[AdamState]) -> Optional[AdamState]:
    return None if opt_state is None else opt_state.clone()


def _trainable(module: nn.Module) -> nn.Module:
    return module.train().requires_grad_(True)


def _g_params(enc: nn.Module, dec: nn.Module) -> Dict[str, torch.Tensor]:
    return {**{f"enc.{n}": p for n, p in enc.named_parameters()},
            **{f"dec.{n}": p for n, p in dec.named_parameters()}}


def _d_opt_init(disc, d_optimizer) -> Optional[AdamState]:
    if disc is None:
        return None
    if d_optimizer is None:
        raise ValueError("a discriminator needs its optimizer (d_optimizer)")
    return d_optimizer.init(dict(_trainable(disc).named_parameters()))


@dataclass
class AETrainState:
    """Stage 1: the encoder and decoder (the generator G, one optimizer
    state over both), the discriminator D and its optimizer state (None
    without the GAN term)."""

    step: int
    generator: torch.Generator     # every training draw of the step
    enc: nn.Module                  # trained
    dec: nn.Module                  # trained
    disc: Optional[nn.Module]       # trained
    g_opt_state: AdamState
    d_opt_state: Optional[AdamState]

    def g_params(self) -> Dict[str, torch.Tensor]:
        """G's parameters, ``enc.<name>`` and ``dec.<name>`` -> tensor."""
        return _g_params(self.enc, self.dec)

    def clone(self) -> "AETrainState":
        return AETrainState(self.step, _copy_generator(self.generator),
                            _copy(self.enc), _copy(self.dec), _copy(self.disc),
                            self.g_opt_state.clone(), _clone_opt(self.d_opt_state))


def create_ae_train_state(enc: nn.Module, dec: nn.Module,
                          disc: Optional[nn.Module], g_optimizer: Optimizer,
                          d_optimizer: Optional[Optimizer] = None,
                          seed: int = 0) -> AETrainState:
    """A fresh stage-1 state over the given modules (the state holds them):
    step 0, a generator seeded with ``seed`` on the encoder's device, G's
    optimizer state over the encoder's and decoder's parameters together
    (``trainer.py:224-227``), D's from ``d_optimizer`` when there is a
    discriminator. The modules are set trainable (train mode, gradients
    on)."""
    device = next(enc.parameters()).device
    for m in (enc, dec):
        _trainable(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    replicate(enc, dec, disc)
    return AETrainState(0, gen, enc, dec, disc, g_optimizer.init(_g_params(enc, dec)),
                        _d_opt_init(disc, d_optimizer))


@dataclass
class Stage2TrainState:
    step: int
    generator: torch.Generator     # every training draw of the step
    transformer: nn.Module          # trained
    opt_state: AdamState
    enc: nn.Module                  # frozen
    dec: nn.Module                  # frozen
    disc: Optional[nn.Module] = None            # trained, with loss.lam_gan
    d_opt_state: Optional[AdamState] = None

    def params(self):
        """The transformer's parameters, name -> tensor."""
        return dict(self.transformer.named_parameters())

    def clone(self) -> "Stage2TrainState":
        return Stage2TrainState(self.step, _copy_generator(self.generator),
                                copy.deepcopy(self.transformer),
                                self.opt_state.clone(), self.enc, self.dec,
                                _copy(self.disc), _clone_opt(self.d_opt_state))


def create_far_train_state(enc: nn.Module, dec: nn.Module,
                           transformer: nn.Module, optimizer: Optimizer,
                           seed: int = 0, *, disc: Optional[nn.Module] = None,
                           d_optimizer: Optional[Optimizer] = None
                           ) -> Stage2TrainState:
    """A fresh state: step 0, a generator seeded with ``seed`` on the
    transformer's device, the optimizer's initial state; the encoder and
    decoder are frozen (no gradients, eval mode). With ``disc`` (the GAN
    term) the discriminator is set trainable and gets ``d_optimizer``'s
    initial state. The NAR state is the same (:func:`create_nar_train_state`)."""
    device = next(transformer.parameters()).device
    for m in (enc, dec):
        m.eval().requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(seed)
    replicate(transformer, enc, dec, disc)
    return Stage2TrainState(0, gen, transformer,
                            optimizer.init(dict(transformer.named_parameters())),
                            enc, dec, disc, _d_opt_init(disc, d_optimizer))


create_nar_train_state = create_far_train_state
