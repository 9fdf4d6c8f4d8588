"""The FAR and NAR training and eval steps of the port.

Counterpart of ``vptr_tpu/train/steps.py:205-445``. The FAR step
(``make_far_train_step`` / ``make_far_eval_step``; reference
``train_FAR.py:48-101``) is the step that the JAX package's
``Trainer.train_step`` and ``bench.py`` run:

1. teacher forcing: encode ``[past, future[:-1]]`` with the frozen encoder,
   without gradients;
2. run the transformer in train mode (attention dropout inside the
   kernels, DropPath, Dropout), every draw from ``state.generator``;
3. decode with the frozen decoder, gradients flowing through it;
4. MSE + GDL against ``[past[:, 1:], future]`` (optionally
   ``temporal_weight``-ed);
5. clip by global norm -> Adam(W) (``train/optim.py``), parameters updated
   in place.

The NAR step (``make_nar_train_step`` / ``make_nar_eval_step``; reference
``train_NAR.py:49-107``) encodes past and future with the frozen encoder,
runs the transformer on the past latents in train mode (its BatchNorm
running statistics update), decodes with gradients through the frozen
decoder, and adds ``lam_nce`` times BiPatchNCE between the NCE projections
of the predicted and the future latents (both projections give the NCE head
a gradient) to MSE + GDL against the future frames.

The steps return ``(state, metrics)`` with the JAX metric names (``T_MSE``,
``T_GDL``, ``T_gan`` = 0, ``T_total``; NAR adds ``T_bpc``) plus
``grad_norm``, the global norm of the gradients before clipping; every
metric is a 0-d tensor on the device (reading one synchronises). After a
step the transformer's ``.grad`` holds that step's gradients. Everything
runs where the modules are (the card unless they were built with
``device="cpu"``).

The GAN term (``loss.lam_gan``) needs the discriminator of the stage-1
slice and raises here.
"""

from __future__ import annotations

import torch

from vptr_tpu_torch.losses import (
    bi_patch_nce,
    gdl_loss,
    l2_normalize_channels,
    mse_loss,
    temporal_weight,
)
from vptr_tpu_torch.train.optim import Optimizer, apply_updates
from vptr_tpu_torch.train.state import Stage2TrainState


def _refuse_gan(loss_cfg) -> None:
    if loss_cfg.lam_gan is not None:
        raise NotImplementedError(
            "loss.lam_gan on the stage-2 steps needs the PatchGAN "
            "discriminator and its update, which come with the stage-1 "
            "AE/GAN slice")


def _frames(state: Stage2TrainState, past, future):
    device = next(state.transformer.parameters()).device
    as_frames = lambda f: torch.as_tensor(f).to(device=device, dtype=torch.float32)
    return as_frames(past), as_frames(future)


def _update(state: Stage2TrainState, optimizer: Optimizer, total, params):
    """Backward of ``total``, then clip -> Adam(W) in place; returns the
    gradient norm. A parameter the loss does not reach (the NCE head without
    ``lam_nce``) gets a zero gradient, as ``jax.grad`` gives it."""
    total.backward()
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = {k: p.grad for k, p in params.items()}
    updates, state.opt_state, norm = optimizer.update(
        grads, state.opt_state, params)
    apply_updates(params, updates)
    state.step += 1
    return norm


def _inputs(state: Stage2TrainState, past, future):
    past, future = _frames(state, past, future)
    x = torch.cat([past, future[:, :-1]], dim=1)
    target = torch.cat([past[:, 1:], future], dim=1)
    return x, target


def make_far_train_step(enc, dec, transformer, optimizer: Optimizer, loss_cfg):
    """``step(state, past, future) -> (state, metrics)`` for frames
    (N, T, H, W, C) in [0, 1] (numpy arrays or tensors). ``enc``, ``dec``
    and ``transformer`` are the modules the state was created with; the step
    runs the ones the state holds (a clone holds its own transformer)."""
    _refuse_gan(loss_cfg)
    del enc, dec, transformer        # the state carries the modules

    def step(state: Stage2TrainState, past, future):
        tr = state.transformer
        x, target = _inputs(state, past, future)
        weights = (temporal_weight(target.shape[1], target.device)
                   if loss_cfg.temporal_weight else None)
        with torch.no_grad():
            gt_feats = state.enc(x)
        tr.train()
        params = state.params()
        for p in params.values():
            p.grad = None
        pred = state.dec(tr(gt_feats, generator=state.generator))
        l_mse = mse_loss(pred, target, weights=weights)
        l_gdl = gdl_loss(target, pred, alpha=loss_cfg.gdl_alpha, weights=weights)
        total = l_gdl + l_mse
        norm = _update(state, optimizer, total, params)
        metrics = {"T_MSE": l_mse.detach(), "T_GDL": l_gdl.detach(),
                   "T_gan": torch.zeros((), device=total.device),
                   "T_total": total.detach(), "grad_norm": norm}
        return state, metrics

    return step


def make_far_eval_step(enc, dec, transformer, loss_cfg):
    """``step(state, past, future) -> (metrics, pred_frames)``: the
    teacher-forced prediction in eval mode, unweighted losses."""
    del enc, dec, transformer

    @torch.no_grad()
    def step(state: Stage2TrainState, past, future):
        x, target = _inputs(state, past, future)
        state.transformer.eval()
        pred = state.dec(state.transformer(state.enc(x)))
        l_mse = mse_loss(pred, target)
        l_gdl = gdl_loss(target, pred, alpha=loss_cfg.gdl_alpha)
        return {"T_MSE": l_mse, "T_GDL": l_gdl, "T_total": l_mse + l_gdl}, pred

    return step


def _nce(tr, pred_feats, future_feats, loss_cfg):
    """BiPatchNCE between the L2-normalised NCE projections of the future
    (ground-truth) and the predicted latents."""
    return bi_patch_nce(l2_normalize_channels(tr.nce_project(future_feats)),
                        l2_normalize_channels(tr.nce_project(pred_feats)),
                        loss_cfg.nce_temperature)


def make_nar_train_step(enc, dec, transformer, optimizer: Optimizer, loss_cfg):
    """``step(state, past, future) -> (state, metrics)`` for frames
    (N, Tp, H, W, C) and (N, Tf, H, W, C) in [0, 1]; see the module notes.
    Metrics: ``T_MSE``, ``T_GDL``, ``T_bpc`` (0 without ``lam_nce``),
    ``T_gan`` = 0, ``T_total``, ``grad_norm``."""
    _refuse_gan(loss_cfg)
    del enc, dec, transformer        # the state carries the modules
    lam_nce = loss_cfg.lam_nce

    def step(state: Stage2TrainState, past, future):
        tr = state.transformer
        past, future = _frames(state, past, future)
        weights = (temporal_weight(future.shape[1], future.device)
                   if loss_cfg.temporal_weight else None)
        with torch.no_grad():
            past_feats = state.enc(past)
            future_feats = state.enc(future) if lam_nce is not None else None
        tr.train()
        params = state.params()
        for p in params.values():
            p.grad = None
        pred_feats = tr(past_feats, generator=state.generator)
        pred = state.dec(pred_feats)
        l_mse = mse_loss(future, pred, weights=weights)
        l_gdl = gdl_loss(future, pred, alpha=loss_cfg.gdl_alpha, weights=weights)
        total = l_gdl + l_mse
        l_nce = torch.zeros((), device=total.device)
        if lam_nce is not None:
            l_nce = _nce(tr, pred_feats, future_feats, loss_cfg)
            total = total + lam_nce * l_nce
        norm = _update(state, optimizer, total, params)
        metrics = {"T_MSE": l_mse.detach(), "T_GDL": l_gdl.detach(),
                   "T_bpc": l_nce.detach(),
                   "T_gan": torch.zeros((), device=total.device),
                   "T_total": total.detach(), "grad_norm": norm}
        return state, metrics

    return step


def make_nar_eval_step(enc, dec, transformer, loss_cfg):
    """``step(state, past, future) -> (metrics, pred_frames)`` in eval mode,
    unweighted losses; with ``lam_nce`` the BiPatchNCE term is reported as
    ``T_bpc`` and folded into ``T_total``, as the reference's NAR
    validation does (``steps.py:408-445``)."""
    del enc, dec, transformer
    lam_nce = loss_cfg.lam_nce

    @torch.no_grad()
    def step(state: Stage2TrainState, past, future):
        past, future = _frames(state, past, future)
        tr = state.transformer.eval()
        pred_feats = tr(state.enc(past))
        pred = state.dec(pred_feats)
        l_mse = mse_loss(pred, future)
        l_gdl = gdl_loss(future, pred, alpha=loss_cfg.gdl_alpha)
        metrics = {"T_MSE": l_mse, "T_GDL": l_gdl}
        total = l_mse + l_gdl
        if lam_nce is not None:
            metrics["T_bpc"] = _nce(tr, pred_feats, state.enc(future), loss_cfg)
            total = total + lam_nce * metrics["T_bpc"]
        metrics["T_total"] = total
        return metrics, pred

    return step
