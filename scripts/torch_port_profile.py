"""Where the time goes in the port's predict call or train step, on one
GPU: far_mnist (FAR) or, with --nar, nar_mnist (NAR); --ffn-route turns on
the fused feed-forward route (transformer.fused_ffn and fused_dw: kernels
#7-#10), --conv-route the conv-FFN route with the folded temporal sublayer
(transformer.fused_conv_ffn and fused_full_temporal: kernels #11/#12, and
#1/#3 on the temporal sublayer); --tslma (with --nar) puts TSLMA in every
decoder block (transformer.tslma: the enc-dec attention over 160-token
space-time windows, #2/#4 on their long route); --gan adds the GAN term (lam_gan 0.01
and the PatchGAN discriminator) to the train step; --ae traces the
stage-1 AE/GAN train step of ae_mnist instead (batch 32, 10 + 10 frames,
lam_gan 0.01). --trainer times ``Trainer.train`` itself (far_mnist, or
ae_mnist with --ae; the synthetic loader, no validation): two untraced
epochs of 20 steps (the second warm), then ``--steps`` steady steps of
another run traced from the third (the trainer's ``profile_dir`` window),
split into device time and the host spans of the loop (loader wait,
batch staging, step enqueue, metric fetch), then one bare train step of
the same modules on a batch already on the card, traced as above.

    python3 scripts/torch_port_profile.py [--nar [--tslma]] [--train [--gan]] [--ae]
        [--ffn-route | --conv-route] [--kernels cuda|plain] [--top 15]
        [--around NAME] [--window 4] [--root DIR]
    python3 scripts/torch_port_profile.py --trainer [--ae] [--steps 5]

Builds the preset at full width from a seed (as chip_smoke.py does), warms
the predict call (far_rip, batch 10, 10 frames; --nar: nar, batch 16,
10 -> 10) or, with --train, the train step (FAR: batch 10, T = 19; NAR:
batch 16, Tp = Tf = 10; dropout 0.1, clip -> AdamW) up, then traces one
call with torch.profiler
and prints: the wall time of the traced call, the summed device time of
its kernels, the device idle share (1 - device time / wall time; one
stream, so kernels do not overlap), and the top kernels by device time
with their launch counts. ``--around NAME`` also prints, over the launches
of every kernel whose name holds NAME (e.g. ``attention_core_bwd``), the
device events within ``--window`` launches before and after each, in time
order, counted by name, and the events around one launch in order: what
runs beside a kernel (layout copies, for one). ``--root`` imports the package of another checkout (e.g. the parent,
unpacked with git archive). Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernels", default="cuda", choices=("cuda", "plain"))
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--train", action="store_true",
                        help="trace one train step instead of a predict call")
    parser.add_argument("--nar", action="store_true",
                        help="nar_mnist (NAR) instead of far_mnist (FAR)")
    parser.add_argument("--gan", action="store_true",
                        help="with --train: the GAN term (lam_gan 0.01) and its discriminator")
    parser.add_argument("--ae", action="store_true",
                        help="the ae_mnist AE/GAN train step instead")
    parser.add_argument("--tslma", action="store_true",
                        help="with --nar: transformer.tslma on")
    parser.add_argument("--ffn-route", action="store_true",
                        help="transformer.fused_ffn and fused_dw on")
    parser.add_argument("--conv-route", action="store_true",
                        help="transformer.fused_conv_ffn and fused_full_temporal on")
    parser.add_argument("--around", help="count the device events beside this kernel's")
    parser.add_argument("--window", type=int, default=4)
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--trainer", action="store_true",
                        help="trace Trainer.train's steady steps (module notes)")
    parser.add_argument("--steps", type=int, default=5,
                        help="with --trainer: the traced steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    if args.trainer:
        return trainer_trace(args)
    if args.ae:
        return trace(*ae_step(torch.device("cuda")), args, "ae_mnist")
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step, make_nar_train_step

    cfg = get_preset("nar_mnist" if args.nar else "far_mnist")
    if args.ffn_route:
        cfg = cfg.override({"transformer": {"fused_ffn": True, "fused_dw": True}})
    if args.conv_route:
        cfg = cfg.override({"transformer": {"fused_conv_ffn": True,
                                            "fused_full_temporal": True}})
    if args.tslma:
        if not args.nar:
            parser.error("--tslma needs --nar")
        cfg = cfg.override({"transformer": {"tslma": True}})
    batch = cfg.data.batch_size if args.nar else 10
    dev = torch.device("cuda")
    enc, dec = build_autoencoder(cfg.ae, torch.bfloat16, dev,
                                 torch.Generator().manual_seed(0))
    tr = build_transformer(cfg.transformer, torch.bfloat16, dev,
                           torch.Generator().manual_seed(1),
                           kernels=args.kernels)
    frames = torch.rand(batch, 20, 64, 64, 1,
                        generator=torch.Generator().manual_seed(2)).to(dev)
    past, future = frames[:, :10], frames[:, 10:]
    if args.train:
        opt = build_optimizer(cfg.optim, cfg.transformer.d_model)
        gan = {}
        if args.gan:
            from vptr_tpu_torch.models.discriminator import build_discriminator

            cfg = cfg.override({"loss": {"lam_gan": 0.01}})
            gan = {"disc": build_discriminator(cfg.disc, torch.bfloat16, dev,
                                               torch.Generator().manual_seed(4)),
                   "d_optimizer": build_optimizer(cfg.optim_d)}
        state = create_far_train_state(enc, dec, tr, opt, seed=3, **gan)
        make_step = make_nar_train_step if args.nar else make_far_train_step
        step = make_step(enc, dec, tr, opt, cfg.loss, **gan)
        run = lambda: step(state, past, future)
        what = (f"NAR train step (batch {batch}, 10 -> 10)" if args.nar
                else "train step (batch 10, T 19)") + (" with the GAN term" if args.gan else "")
    else:
        mode = "nar" if args.nar else "far_rip"
        predict = make_predict_fn(cfg, enc, dec, tr, mode, 10, dev)
        run = lambda: predict(past)
        what = f"{mode} predict (batch {batch}, 10 frames)"
    route = " + ".join(name for name, on in (("fused-FFN route", args.ffn_route),
                                             ("conv-FFN route", args.conv_route),
                                             ("TSLMA", args.tslma))
                       if on) or "default route"
    return trace(run, what, args, route)


def ae_step(dev):
    """(one ae_mnist AE/GAN train step at full width from a seed, its
    label)."""
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.discriminator import build_discriminator
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_ae_train_state
    from vptr_tpu_torch.train.steps import make_ae_train_step

    cfg = get_preset("ae_mnist")
    enc, dec = build_autoencoder(cfg.ae, torch.bfloat16, dev, torch.Generator().manual_seed(0))
    disc = build_discriminator(cfg.disc, torch.bfloat16, dev, torch.Generator().manual_seed(1))
    g_opt, d_opt = build_optimizer(cfg.optim), build_optimizer(cfg.optim_d)
    state = create_ae_train_state(enc, dec, disc, g_opt, d_opt, seed=3)
    step = make_ae_train_step(enc, dec, disc, g_opt, d_opt, cfg.loss)
    batch = cfg.data.batch_size
    frames = torch.rand(batch, 20, 64, 64, 1,
                        generator=torch.Generator().manual_seed(2)).to(dev)
    return (lambda: step(state, frames[:, :10], frames[:, 10:]),
            f"AE/GAN train step (batch {batch}, 10 + 10 frames)")


SPANS = ("trainer.loader_wait", "trainer.put_batch", "trainer.step",
         "trainer.fetch_metrics")


def trainer_trace(args) -> int:
    """Time ``Trainer.train`` untraced (a first epoch that warms up, then a
    steady one), trace ``args.steps`` steady steps of another run and print
    the window's wall, device time and idle share a step and each host span
    of the loop a step; then the bare step (module notes)."""
    import tempfile
    from contextlib import closing

    from torch.autograd import DeviceType

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.data.loader import build_loader
    from vptr_tpu_torch.train.trainer import Trainer

    preset = "ae_mnist" if args.ae else "far_mnist"
    with tempfile.TemporaryDirectory() as root:
        base = get_preset(preset).override({"epochs": 1, "val_per_epochs": 10 ** 6,
                                            "ckpt_dir": root})
        d = base.data
        frames = d.batch_size * (d.num_past_frames + d.num_future_frames
                                 - (preset == "far_mnist"))
        trainer = Trainer(base.override({"steps_per_epoch": 20}), device="cuda",
                          write_outputs=False)
        state = trainer.train()
        state = trainer.train(state)
        sps = trainer.history["train"]["steps_per_sec"]
        print(f"{preset} Trainer.train untraced, 20 steps an epoch: first epoch "
              f"{sps[0][1]:.4f} steps/s, second {sps[1][1]:.4f} steps/s = "
              f"{1e3 / sps[1][1]:.3f} ms a step, {sps[1][1] * frames:.1f} training "
              f"frames/s ({frames} a step)")
        del trainer, state
        traced = Trainer(base.override({"steps_per_epoch": 2 + args.steps + 1,
                                        "profile_dir": root,
                                        "profile_steps": args.steps}),
                         device="cuda", write_outputs=False)
        state = traced.train()
        prof = traced.profiler
    events = prof.events()
    # the loop's spans also appear on the device track (as annotations that
    # cover their kernels): count kernels, copies and sets only
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and e.name not in SPANS)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    wall_us = max(e.time_range.end for e in cpu) - min(e.time_range.start for e in cpu)
    n = args.steps
    spans = {name: sum(e.cpu_time_total for e in cpu if e.name == name) for name in SPANS}
    print(f"  traced window of {n} steps (the profiler slows the host): wall "
          f"{wall_us / n / 1e3:.3f} ms a step, device {dev_us / n / 1e3:.3f} ms a step, "
          f"idle share {1 - dev_us / wall_us:.3f}; host spans a step: "
          + ", ".join(f"{k.split('.')[1]} {v / n / 1e3:.3f} ms" for k, v in spans.items())
          + f", outside them {(wall_us - sum(spans.values())) / n / 1e3:.3f} ms")

    loader = build_loader(traced.cfg.data, split="train", seed=traced.cfg.seed)
    with closing(iter(loader)) as it:
        past, future = traced.put_batch(*next(it))
    return trace(lambda: traced.train_step(state, past, future),
                 f"bare {preset} train step (the trainer's modules, a batch on the card)",
                 args, "default route")


def trace(run, what, args, route) -> int:
    """Warm ``run`` up, trace one call and print the readings (module notes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []   # device-side events only (kernels, memcpy/memset)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    print(f"kernels={args.kernels} {route} {what}, traced: wall {wall_ms:.3f} ms, "
          f"device {dev_ms:.3f} ms, idle share {1 - dev_ms / wall_ms:.3f}")
    for ms, count, key in rows[:args.top]:
        print(f"  {ms:9.3f} ms {100 * ms / dev_ms:5.1f}% x{count:<5d} {key[:90]}")
    if args.around:
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        hits = [i for i, e in enumerate(events) if args.around in e.name]
        beside = {}
        for i in hits:
            for e in events[max(0, i - args.window):i] + events[i + 1:i + 1 + args.window]:
                beside[e.name[:90]] = beside.get(e.name[:90], 0) + 1
        print(f"  {len(hits)} launches of *{args.around}*; the device events within "
              f"{args.window} launches of them, by name:")
        for name, n in sorted(beside.items(), key=lambda kv: -kv[1]):
            print(f"    x{n:<5d} {name}")
        if hits:
            i = hits[len(hits) // 2]
            print(f"  in time order around launch {len(hits) // 2} of them:")
            for e in events[max(0, i - args.window):i + 1 + args.window]:
                print(f"    {'>>' if args.around in e.name else '  '} {e.name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
