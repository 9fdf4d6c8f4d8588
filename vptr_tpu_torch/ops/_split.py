"""Split kernel calls under tensor parallelism: a rank's share of a call
whose statistics (or partial sums) run over every model rank's, written as
a generator of its exchanges.

A split call (``ops/fused_dw_chain.py::split_forward``, ``split_backward``;
``ops/conv_ln_gelu.py::split_forward``, ``split_backward``,
``rows_forward``) launches its steps on the card and, between two of them,
yields what the model group must exchange (f32 partials) and takes back
every rank's, stacked in rank order (M, ...). :func:`run_split` drives
calls in step: on the mesh each gets its model group's gather
(:func:`model_exchange`); in one process the calls of ranks 0 .. M - 1 run
together and the exchange stacks their partials (the tests' and the smoke
run's comparisons).

The plain versions of such calls take a sample's sums over the model
group instead (:func:`sample_mean`, :func:`sample_ln`), differentiably.
"""

from __future__ import annotations

import torch

from vptr_tpu_torch.parallel.mesh import gather_model_parts, model_size, model_sum

LN_EPS = 1e-5


def run_split(calls, exchange=None):
    """Drive model ranks' split calls in step; returns each one's result.
    ``exchange`` maps the calls' partials to what each gets back; the
    default stacks them in order, so ``calls`` of ranks 0 .. M - 1 run the
    M ranks in one process."""
    exchange = exchange or (lambda parts: [torch.stack(parts)] * len(parts))
    got, results = [None] * len(calls), [None] * len(calls)
    while True:
        parts = []
        for i, call in enumerate(calls):
            try:
                parts.append(call.send(got[i]))
            except StopIteration as done:
                results[i] = done.value
        if len(parts) == 0:
            return results
        if len(parts) != len(calls):
            raise RuntimeError("run_split: the split calls are out of step")
        got = exchange(parts)


def model_exchange(parts):
    """A rank's partials gathered over the model group in rank order."""
    return [gather_model_parts(parts[0])]


def share_model(model, what: str):
    """``model`` (M, m) as the plain versions take it: None for a whole
    call (no model, or M 1); a share needs the active mesh's model group of
    M ranks."""
    if model is None or model[0] == 1:
        return None
    if model_size() != model[0]:
        raise ValueError(f"{what} on model rank {model[1]} of {model[0]}: its statistics run "
                         f"over every rank's channels, which needs the mesh's model group "
                         f"(the active mesh has mesh.model={model_size()})")
    return model


def sample_mean(z, model=None):
    """The mean over each sample's (HW, C) of z (N, HW, C); under ``model``
    (M, m) over every model rank's channels (the sums added up over the
    model group, differentiably)."""
    if model is None:
        return z.mean((1, 2), keepdim=True)
    return model_sum(z.sum((1, 2), keepdim=True)) / (z.shape[1] * z.shape[2] * model[0])


def sample_ln(z, model=None):
    """(zhat, rstd) of a whole-sample LayerNorm over (HW, C), two-pass
    variance; under ``model`` over every rank's channels."""
    zc = z - sample_mean(z, model)
    rstd = torch.rsqrt(sample_mean(zc * zc, model) + LN_EPS)
    return zc * rstd, rstd
