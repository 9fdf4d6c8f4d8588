"""The stage-1 (AE/GAN) and stage-2 (FAR, NAR) training and eval steps of
the port.

Counterpart of ``vptr_tpu/train/steps.py``. The stage-1 step
(``make_ae_train_step`` / ``make_ae_eval_step``, ``steps.py:103-199``;
reference ``train_AutoEncoder.py:44-86``) trains the autoencoder on
``x = [past, future]``:

1. one forward of the encoder and decoder in train mode (BatchNorm on batch
   statistics, running statistics updated once; the residual blocks'
   dropout drawn from ``state.generator``), with autograd;
2. with the GAN term (``loss.lam_gan`` and a discriminator), one
   discriminator update first (:func:`_disc_update`): D in train mode on the
   detached reconstructions (fake), then on x (real), so its BatchNorm
   running statistics update twice in that order; loss (Dfake + Dreal)
   * 0.5 * lam_gan, then D's optimizer (``cfg.optim_d``);
3. MSE + GDL against x, plus lam_gan times the generator's GAN term
   (:func:`_gan_term`: the *updated* D, still in train mode, on the
   reconstructions; its statistics update a third time; D's parameters
   take no gradient from it);
4. one backward from that total through the forward of 1, then G's
   optimizer over the encoder's and decoder's parameters together.

The FAR step (``make_far_train_step`` / ``make_far_eval_step``,
``steps.py:205-306``; reference ``train_FAR.py:48-101``) is the step that
the JAX package's ``Trainer.train_step`` and ``bench.py`` run:

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

With ``loss.lam_gan`` and a discriminator (``disc=``, ``d_optimizer=``;
the state from ``create_far_train_state(..., disc=, d_optimizer=)``), the
FAR and NAR steps update D between the transformer's forward and its loss,
as the AE step does: fake is the whole prediction (FAR: the Tp + Tf - 1
teacher-forced frames), real the Tf future frames (``steps.py:243-249``),
and ``T_gan`` is the generator's term. Without a discriminator the GAN
term is off, as in the JAX package.

The steps return ``(state, metrics)`` with the JAX metric names (AE:
``AE_MSE``, ``AE_GDL``, ``AEgan``, ``AE_total``; FAR: ``T_MSE``,
``T_GDL``, ``T_gan``, ``T_total``; NAR adds ``T_bpc``; all three
``Dtotal``, ``Dfake``, ``Dreal``, 0 without the GAN term) plus
``grad_norm``, the global norm of the trained generator's gradients before
clipping; every metric is a 0-d tensor on the device (reading one
synchronises). After a step the trained modules' ``.grad`` hold that
step's gradients (D's from its own update). Everything runs where the
modules are (the card unless they were built with ``device="cpu"``).

With ``remat_decoder`` (``steps.py:206, 231-236, 310, 337``; the
Trainer sets it from ``transformer.remat``) the FAR and NAR steps
checkpoint the frozen decoder's apply: its 64 x 64 conv activations are
recomputed in the backward instead of kept (the decoder is in eval mode
and draws nothing).

Under a process group of W > 1 ranks (:mod:`vptr_tpu_torch.parallel`),
each rank steps on its b rows of a global batch of W·b and the step is the
one-process step at the global batch: the modules take global-batch
statistics and masks (:mod:`vptr_tpu_torch.models.layers`), every update
(G's, D's, the transformer's) averages the gradients over the ranks after
the whole backward and before the clip, so ``grad_norm`` is the global
gradient's norm on every rank, and the metrics a train or eval step returns
are their means over the ranks. On a (data, model) mesh the ranks of one
model group hold the same rows and a sharded transformer
(``shard_transformer``): the model-group sums its layers need happen in
the backward itself (:mod:`vptr_tpu_torch.parallel.mesh`'s autograd
collectives), the mean runs over the data group after them, the clip's
norm adds the shares' squares over the model group, and the metrics are
the data group's means, the same on every rank.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.utils.checkpoint import checkpoint

from vptr_tpu_torch.losses import (
    bi_patch_nce,
    gan_loss,
    gdl_loss,
    l2_normalize_channels,
    mse_loss,
    temporal_weight,
)
from vptr_tpu_torch.models.transformer import tp_shards
from vptr_tpu_torch.parallel.mesh import all_reduce_grads, all_reduce_mean, data_size
from vptr_tpu_torch.train.optim import Optimizer, apply_updates
from vptr_tpu_torch.train.state import AETrainState, Stage2TrainState


def _device(module) -> torch.device:
    return next(module.parameters()).device


def _frames(device, *frames):
    return tuple(torch.as_tensor(f).to(device=device, dtype=torch.float32)
                 for f in frames)


def _optimize(params, optimizer: Optimizer, opt_state, sharded=()):
    """Optimizer step from the parameters' ``.grad`` (a parameter the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it), the
    gradients first averaged over the ranks (``all_reduce_grads``), in
    place; ``sharded``: the names of a model rank's shares. Returns (new
    optimizer state, gradient norm)."""
    all_reduce_grads(params, sharded)
    grads = {k: p.grad for k, p in params.items()}
    updates, opt_state, norm = optimizer.update(grads, opt_state, params, sharded)
    apply_updates(params, updates)
    return opt_state, norm


def _global_means(metrics):
    """The step's metrics as their means over the ranks (each rank's are
    means over its equal share of the global batch); ``grad_norm`` is
    global already."""
    if data_size() == 1:
        return metrics
    keys = [k for k in metrics if k != "grad_norm"]
    return {**metrics, **dict(zip(keys, all_reduce_mean([metrics[k] for k in keys])))}


def _zero_grads(params) -> None:
    for p in params.values():
        p.grad = None


def _update(state: Stage2TrainState, optimizer: Optimizer, total, params):
    """Backward of ``total``, then clip -> Adam(W) in place; returns the
    gradient norm."""
    total.backward()
    state.opt_state, norm = _optimize(params, optimizer, state.opt_state,
                                      tp_shards(state.transformer))
    state.step += 1
    return norm


# ---------------------------------------------------------------- GAN parts

def _use_gan(loss_cfg, disc, d_optimizer) -> bool:
    """The GAN term runs with ``loss.lam_gan`` and a discriminator
    (``steps.py:107``); its update needs D's optimizer."""
    if disc is None or loss_cfg.lam_gan is None:
        return False
    if d_optimizer is None:
        raise ValueError("the GAN term needs the discriminator's optimizer "
                         "(d_optimizer)")
    return True


def _flat_frames(x: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) -> (N*T, H, W, C) for the per-frame discriminator."""
    return x.reshape((-1,) + x.shape[2:])


def _disc_update(state, d_optimizer: Optimizer, fake, real, loss_cfg):
    """One discriminator step (``steps.py:42-78``, reference cal_lossD):
    D in train mode on the detached fakes, then on the real frames (the
    real pass sees the statistics the fake pass left), loss (Dfake + Dreal)
    * 0.5 * lam_gan, D's optimizer in place. Returns the D metrics."""
    disc = state.disc.train()
    params = dict(disc.named_parameters())
    _zero_grads(params)
    l_fake = gan_loss(disc(_flat_frames(fake.detach())), False, loss_cfg.gan_mode)
    l_real = gan_loss(disc(_flat_frames(real)), True, loss_cfg.gan_mode)
    loss_d = (l_fake + l_real) * 0.5 * loss_cfg.lam_gan
    loss_d.backward()
    state.d_opt_state, _ = _optimize(params, d_optimizer, state.d_opt_state)
    return {"Dtotal": loss_d.detach(), "Dfake": l_fake.detach(),
            "Dreal": l_real.detach()}


@contextmanager
def _frozen(module):
    """The module's parameters take no gradient inside (gradients still
    flow through it to its input)."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield module
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _gan_term(disc, frames, gan_mode: str):
    """The generator's GAN term (``steps.py:81-97``): the (updated) D in
    train mode, as the reference keeps it (its BatchNorm normalises with
    batch statistics and updates its running ones a third time), its
    parameters frozen."""
    with _frozen(disc.train()):
        return gan_loss(disc(_flat_frames(frames)), True, gan_mode)


def _with_gan(state, d_optimizer, fake, real, total, loss_cfg, use_gan: bool):
    """The GAN part of a step between the generator's forward and its
    backward: D's update on (fake, real), then ``total`` + lam_gan x the
    generator's term on the fakes. Returns (total, the GAN term, the D
    metrics); without the GAN term (total, 0, zeros)."""
    if not use_gan:
        zero = torch.zeros((), device=total.device)
        return total, zero, {"Dtotal": zero, "Dfake": zero, "Dreal": zero}
    d_metrics = _disc_update(state, d_optimizer, fake, real, loss_cfg)
    l_gan = _gan_term(state.disc, fake, loss_cfg.gan_mode)
    return total + loss_cfg.lam_gan * l_gan, l_gan, d_metrics


# ---------------------------------------------------------------- stage 1

def make_ae_train_step(enc, dec, disc, g_optimizer: Optimizer,
                       d_optimizer, loss_cfg):
    """``step(state, past, future) -> (state, metrics)`` for frames
    (N, Tp, H, W, C) and (N, Tf, H, W, C) in the decoder's output range
    (numpy arrays or tensors); see the module notes. ``enc``, ``dec`` and
    ``disc`` are the modules the state was created with; the step runs the
    ones the state holds (a clone holds its own)."""
    use_gan = _use_gan(loss_cfg, disc, d_optimizer)
    del enc, dec, disc               # the state carries the modules

    def step(state: AETrainState, past, future):
        past, future = _frames(_device(state.enc), past, future)
        x = torch.cat([past, future], dim=1)
        params = state.g_params()
        _zero_grads(params)
        rec = state.dec.train()(state.enc.train()(x, generator=state.generator))
        l_mse = mse_loss(x, rec)
        l_gdl = gdl_loss(x, rec, alpha=loss_cfg.gdl_alpha)
        total, l_gan, d_metrics = _with_gan(state, d_optimizer, rec, x, l_mse + l_gdl,
                                            loss_cfg, use_gan)
        total.backward()
        state.g_opt_state, norm = _optimize(params, g_optimizer, state.g_opt_state)
        state.step += 1
        metrics = {"AE_MSE": l_mse.detach(), "AE_GDL": l_gdl.detach(),
                   "AEgan": l_gan.detach(), "AE_total": total.detach(),
                   **d_metrics, "grad_norm": norm}
        return state, _global_means(metrics)

    return step


def make_ae_eval_step(enc, dec, disc, loss_cfg):
    """``step(state, past, future) -> (metrics, reconstructions)``: the
    encoder, decoder and discriminator in eval mode (set on every call),
    ``AE_MSE``, ``AE_GDL`` and ``AE_total``; with the GAN term also
    ``AEgan`` (D on its running statistics), folded into ``AE_total``."""
    use_gan = disc is not None and loss_cfg.lam_gan is not None
    del enc, dec, disc

    @torch.no_grad()
    def step(state: AETrainState, past, future):
        past, future = _frames(_device(state.enc), past, future)
        x = torch.cat([past, future], dim=1)
        rec = state.dec.eval()(state.enc.eval()(x))
        l_mse = mse_loss(x, rec)
        l_gdl = gdl_loss(x, rec, alpha=loss_cfg.gdl_alpha)
        metrics = {"AE_MSE": l_mse, "AE_GDL": l_gdl, "AE_total": l_mse + l_gdl}
        if use_gan:
            metrics["AEgan"] = gan_loss(state.disc.eval()(_flat_frames(rec)), True,
                                        loss_cfg.gan_mode)
            metrics["AE_total"] = metrics["AE_total"] + loss_cfg.lam_gan * metrics["AEgan"]
        return _global_means(metrics), rec

    return step


# ---------------------------------------------------------------- stage 2

def _decode(dec, feats, remat: bool):
    """The frozen decoder on the transformer's latents, gradients flowing
    through it to them; with ``remat`` its activations are recomputed in
    the backward (``jax.checkpoint(dec_apply)``)."""
    if remat:
        return checkpoint(dec, feats, use_reentrant=False, preserve_rng_state=False)
    return dec(feats)


def _inputs(state: Stage2TrainState, past, future):
    past, future = _frames(_device(state.transformer), past, future)
    x = torch.cat([past, future[:, :-1]], dim=1)
    target = torch.cat([past[:, 1:], future], dim=1)
    return x, target, future


def make_far_train_step(enc, dec, transformer, optimizer: Optimizer, loss_cfg,
                        *, disc=None, d_optimizer=None, remat_decoder: bool = False):
    """``step(state, past, future) -> (state, metrics)`` for frames
    (N, T, H, W, C) in [0, 1] (numpy arrays or tensors). ``enc``, ``dec``,
    ``transformer`` and ``disc`` are the modules the state was created with;
    the step runs the ones the state holds (a clone holds its own
    transformer and discriminator). ``disc`` and ``d_optimizer``: the GAN
    term with ``loss.lam_gan``; ``remat_decoder``: the decoder's
    activations recomputed in the backward (module notes)."""
    use_gan = _use_gan(loss_cfg, disc, d_optimizer)
    del enc, dec, transformer, disc  # the state carries the modules

    def step(state: Stage2TrainState, past, future):
        tr = state.transformer
        x, target, future = _inputs(state, past, future)
        weights = (temporal_weight(target.shape[1], target.device)
                   if loss_cfg.temporal_weight else None)
        with torch.no_grad():
            gt_feats = state.enc(x)
        tr.train()
        params = state.params()
        _zero_grads(params)
        pred = _decode(state.dec, tr(gt_feats, generator=state.generator),
                       remat_decoder)
        l_mse = mse_loss(pred, target, weights=weights)
        l_gdl = gdl_loss(target, pred, alpha=loss_cfg.gdl_alpha, weights=weights)
        total, l_gan, d_metrics = _with_gan(state, d_optimizer, pred, future,
                                            l_gdl + l_mse, loss_cfg, use_gan)
        norm = _update(state, optimizer, total, params)
        metrics = {"T_MSE": l_mse.detach(), "T_GDL": l_gdl.detach(),
                   "T_gan": l_gan.detach(), "T_total": total.detach(),
                   **d_metrics, "grad_norm": norm}
        return state, _global_means(metrics)

    return step


def make_far_eval_step(enc, dec, transformer, loss_cfg):
    """``step(state, past, future) -> (metrics, pred_frames)``: the
    teacher-forced prediction in eval mode, unweighted losses."""
    del enc, dec, transformer

    @torch.no_grad()
    def step(state: Stage2TrainState, past, future):
        x, target, _ = _inputs(state, past, future)
        state.transformer.eval()
        pred = state.dec(state.transformer(state.enc(x)))
        l_mse = mse_loss(pred, target)
        l_gdl = gdl_loss(target, pred, alpha=loss_cfg.gdl_alpha)
        return _global_means({"T_MSE": l_mse, "T_GDL": l_gdl,
                              "T_total": l_mse + l_gdl}), pred

    return step


def _nce(tr, pred_feats, future_feats, loss_cfg):
    """BiPatchNCE between the L2-normalised NCE projections of the future
    (ground-truth) and the predicted latents."""
    return bi_patch_nce(l2_normalize_channels(tr.nce_project(future_feats)),
                        l2_normalize_channels(tr.nce_project(pred_feats)),
                        loss_cfg.nce_temperature)


def make_nar_train_step(enc, dec, transformer, optimizer: Optimizer, loss_cfg,
                        *, disc=None, d_optimizer=None, remat_decoder: bool = False):
    """``step(state, past, future) -> (state, metrics)`` for frames
    (N, Tp, H, W, C) and (N, Tf, H, W, C) in [0, 1]; see the module notes
    (``disc``, ``d_optimizer`` and ``remat_decoder`` as
    :func:`make_far_train_step`'s).
    Metrics: ``T_MSE``, ``T_GDL``, ``T_bpc`` (0 without ``lam_nce``),
    ``T_gan``, ``T_total``, ``Dtotal``, ``Dfake``, ``Dreal``,
    ``grad_norm``."""
    use_gan = _use_gan(loss_cfg, disc, d_optimizer)
    del enc, dec, transformer, disc  # the state carries the modules
    lam_nce = loss_cfg.lam_nce

    def step(state: Stage2TrainState, past, future):
        tr = state.transformer
        past, future = _frames(_device(tr), past, future)
        weights = (temporal_weight(future.shape[1], future.device)
                   if loss_cfg.temporal_weight else None)
        with torch.no_grad():
            past_feats = state.enc(past)
            future_feats = state.enc(future) if lam_nce is not None else None
        tr.train()
        params = state.params()
        _zero_grads(params)
        pred_feats = tr(past_feats, generator=state.generator)
        pred = _decode(state.dec, pred_feats, remat_decoder)
        l_mse = mse_loss(future, pred, weights=weights)
        l_gdl = gdl_loss(future, pred, alpha=loss_cfg.gdl_alpha, weights=weights)
        total = l_gdl + l_mse
        l_nce = torch.zeros((), device=total.device)
        if lam_nce is not None:
            l_nce = _nce(tr, pred_feats, future_feats, loss_cfg)
            total = total + lam_nce * l_nce
        total, l_gan, d_metrics = _with_gan(state, d_optimizer, pred, future,
                                            total, loss_cfg, use_gan)
        norm = _update(state, optimizer, total, params)
        metrics = {"T_MSE": l_mse.detach(), "T_GDL": l_gdl.detach(),
                   "T_bpc": l_nce.detach(), "T_gan": l_gan.detach(),
                   "T_total": total.detach(), **d_metrics, "grad_norm": norm}
        return state, _global_means(metrics)

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
        past, future = _frames(_device(state.transformer), past, future)
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
        return _global_means(metrics), pred

    return step
