"""Stage-2 train state of the port.

Counterpart of ``vptr_tpu/train/state.py::Stage2TrainState``: the step
count, the source of the step's random draws, the trainable transformer,
its optimizer state and the frozen autoencoder. JAX's state is immutable
and holds parameter trees; here the modules hold the parameters and the
step updates them in place. :meth:`Stage2TrainState.clone` gives an
independent copy (transformer, optimizer state and generator; the frozen
encoder and decoder are shared), so two steps can start from one state.
A NAR transformer's BatchNorm running statistics are buffers of the
module, so they are part of the state and ``clone`` copies them. The
discriminator of the GAN variant comes with the stage-1 slice.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from vptr_tpu_torch.train.optim import AdamState, Optimizer


@dataclass
class Stage2TrainState:
    step: int
    generator: torch.Generator     # every training draw of the step
    transformer: nn.Module          # trained
    opt_state: AdamState
    enc: nn.Module                  # frozen
    dec: nn.Module                  # frozen

    def params(self):
        """The transformer's parameters, name -> tensor."""
        return dict(self.transformer.named_parameters())

    def clone(self) -> "Stage2TrainState":
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.generator.get_state())
        return Stage2TrainState(self.step, gen, copy.deepcopy(self.transformer),
                                self.opt_state.clone(), self.enc, self.dec)


def create_far_train_state(enc: nn.Module, dec: nn.Module,
                           transformer: nn.Module, optimizer: Optimizer,
                           seed: int = 0) -> Stage2TrainState:
    """A fresh state: step 0, a generator seeded with ``seed`` on the
    transformer's device, the optimizer's initial state; the encoder and
    decoder are frozen (no gradients, eval mode). The NAR state is the same
    (:func:`create_nar_train_state`)."""
    device = next(transformer.parameters()).device
    for m in (enc, dec):
        m.eval().requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(seed)
    return Stage2TrainState(0, gen, transformer,
                            optimizer.init(dict(transformer.named_parameters())),
                            enc, dec)


create_nar_train_state = create_far_train_state
