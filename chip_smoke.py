"""On-card smoke run of the PyTorch/CUDA port (vptr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, without the final result line):
1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
   and print the build time and ptxas's register / spill report;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the far_mnist paths give it, in bf16 and f32: the forwards at the
   far_rip shapes, a rectangular attention core and the residual/scale
   window variant; the forwards with dropout 0.1 at the training shapes;
   both backward kernels at the training shapes (window 760 x 16 x 528,
   core 640 x 8 x 19 x 66), dropout 0 and 0.1, with a per-head bias for
   the bias gradients;
4. build far_mnist at full width from a seed (AE ngf 64 / feat 528 / 9 res
   blocks, FAR 12 layers / d 528 / 8 heads), run the far_rip predict entry
   point for 10 frames from 10 past frames at batch 10 with every launch
   counter set to 0 just before and read just after (each forward kernel
   must run 12 layers x 10 steps = 120 times), check the frames, and
   compare the teacher-forced "far" mode with kernels against
   kernels="plain";
5. train far_mnist at full width (the step make_far_train_step builds:
   batch 10, T = 19 teacher-forced, dropout / DropPath 0.1, clip -> AdamW
   with the preset's bf16 first moment): one step with every counter at 0
   just before and read just after (each of the four kernels must run 12
   times); one step with the kernels and one with kernels="plain" from one
   cloned state; 10 steps on one fixed batch, losses finite and falling;
6. time the far_rip predict call, the train step (median of 8 after 2
   warm-ups, and with kernels="plain") and each kernel beside its plain
   version, a PyTorch library yardstick and its bound (bytes or
   operations over the card's published peak);
7. the NAR slice's kernels against their plain versions at the nar_mnist
   shapes (640 windows x 16 x 528), bf16 and f32, dropout 0 and 0.1:
   the two-stream kernels #5/#6 with an 8-head and a 1-head relative-
   position bias (forward, dx_qk, dx_v, every dW and db, dbias), and #1/#3
   with the 8-head bias, no position table and the bias gradient;
8. build nar_mnist at full width from a seed (AE as far_mnist, NAR 4 + 8
   layers / d 528 / 8 heads, RPE) and run the "nar" predict entry point
   for 10 frames from 10 past frames at batch 16, every counter at 0 just
   before and read just after (#1 4, #5 8, #2 20 launches), check the
   frames and compare with kernels="plain";
9. train nar_mnist at full width (make_nar_train_step: batch 16, Tp = Tf
   = 10, dropout / DropPath 0.1, MSE + GDL + 0.1 BiPatchNCE, clip ->
   AdamW): one step with every counter at 0 (#1/#3 4, #5/#6 8, #2/#4 20
   launches); one step with the kernels and one with kernels="plain" from
   one cloned state; 10 steps on one batch, losses finite and falling;
10. time the nar predict call and the NAR train step (in turns with
   kernels="plain"), kernels #5/#6 beside their plain versions, library
   yardsticks and bounds, and #1/#3 at the NAR shape with the RPE bias;
11. the fused-FFN route's kernels (#7/#8 fused_ffn, #9/#10 fused_dw_chain)
   against their plain versions at the far_mnist shapes (FFN rows 12,800
   for the forward, 12,160 for the backward, C 528, hidden 2112; dw chain
   200 and 190 samples of 8 x 8 x 2112), bf16 and f32, dropout 0 and 0.1;
12. far_mnist with transformer.fused_ffn and fused_dw: the far_rip predict
   with every counter at 0 just before and read just after (#7, #9, #1
   and #2 120 launches each), the frames checked and compared with
   kernels="plain" and with the default route (same weights);
13. its train step: one step with every counter at 0 (#1-#4 and #7-#10 12
   launches each), kernels vs kernels="plain" from one cloned state, 10
   steps on one batch with a falling loss;
14. times: #7-#10 beside their plain versions, a library yardstick and the
   bound; the far_rip predict and the train step on the fused route and the
   default route in turns, and each step's memory peak above what is held;
15. print {"kernels": [...]} (all ten kernels) and, last,
   {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package. Exits non-zero when
torch.cuda.is_available() is false.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and flop/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEED = 0
BATCH, PAST, FUTURE = 10, 10, 10
LAYERS = 12
TRAIN_STEPS = 10              # the loss-falling run
TIMED_STEPS, WARMUP_STEPS = 8, 2

failures = []


def phase(name):
    print(f"\n=== {name}", flush=True)


def check(ok: bool, what: str):
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(a, b) -> float:
    """max |a - b| over the larger of 1 and max |b|."""
    return max_err(a, b) / max(1.0, b.float().abs().max().item())


def zero_counters(*wrappers):
    for w in wrappers:
        w.launches = 0
        w.bwd_launches = 0


def bound(nbytes: float, flops: float, dtype=torch.bfloat16):
    """(least ms for the work on the card, "bytes" or "operations"): the
    larger of bytes over the memory rate and flops over the peak of their
    type (bf16 tensor-core products, or f32 arithmetic on the CUDA cores)."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def timed_turns(fn, plain):
    """plain, kernel, kernel, plain (CUDA-event ms each): two versions
    compared within one call, in turns; returns (kernel ms, plain ms),
    the better reading of each."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(fn), cuda_ms(fn), cuda_ms(plain)
    return min(k1, k2), min(p1, p2)


def nar_phases(dev):
    """Phases 7-10: the nar_mnist NAR path. Returns (kernel rows of #5 and
    #6, a text line per extra reading, the summary numbers)."""
    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.layers import relative_position_index, use_kernels
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.ops import fused_window_attention as tfw
    from vptr_tpu_torch.ops.attention_core import attention_core
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_nar_train_state
    from vptr_tpu_torch.train.steps import make_nar_train_step

    cfg = get_preset("nar_mnist")
    tc = cfg.transformer
    c, heads = tc.d_model, tc.n_heads
    hd = c // heads
    batch, n_past, n_fut = cfg.data.batch_size, tc.num_past_frames, tc.num_future_frames
    tokens = tc.window_size ** 2
    per_frame = (tc.enc_h // tc.window_size) * (tc.enc_w // tc.window_size)
    windows = batch * n_fut * per_frame       # 640: the decoder's (and encoder's)
    rows = windows * tokens
    rate = tc.dropout
    g = torch.Generator().manual_seed(SEED + 20)
    kseed = torch.tensor([SEED + 54321], dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    tol = {torch.float32: 1e-3, bf: 6.25e-2}            # as phase 3
    bwd_tol = {torch.float32: 1e-4, bf: 2 ** -5}
    idx = torch.from_numpy(relative_position_index(tc.window_size).reshape(-1))

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g) * std

    def rpe_bias(nb):
        table = randn((2 * tc.window_size - 1) ** 2, nb, std=0.5)
        return table[idx].reshape(tokens, tokens, nb).permute(2, 0, 1).contiguous().to(dev)

    def weights(dtype):
        w = [randn(c, c, std=c ** -0.5).to(dev, dtype) for _ in range(4)]
        b = [randn(c, std=0.02).to(dev) for _ in range(4)]
        return (w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3])

    def two_stream(dtype):
        x_v = randn(windows, tokens, c)
        x_qk = x_v + randn(windows, tokens, c, std=0.5)
        return (x_qk.to(dev, dtype), x_v.to(dev, dtype)) + weights(dtype)

    def ln_operands(dtype):
        return ((randn(windows, tokens, c).to(dev, dtype),) + weights(dtype)
                + ((1 + randn(c, std=0.1)).to(dev), randn(c, std=0.1).to(dev), None))

    def worst_rel(got, want, names):
        worst = {n: rel_err(a, b) for n, a, b in zip(names, got, want)
                 if b is not None}
        name = max(worst, key=worst.get)
        return name, worst[name]

    two_names = ("dx_qk", "dx_v", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv",
                 "dwo", "dbo", "dbias")
    ln_names = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo",
                "dls", "dlb", "dbias")
    rpe8, rpe1 = rpe_bias(heads), rpe_bias(1)
    errs = {}

    phase("7. NAR kernels against their plain versions (card)")
    for dtype in (bf, torch.float32):
        name = str(dtype).replace("torch.", "")
        ops = two_stream(dtype)
        gout = randn(windows, tokens, c).to(dev, dtype)
        for bias, what in ((rpe8, "8-head RPE bias"), (rpe1, "1-head bias")):
            for r in (0.0, rate):
                e = max_err(tfw.fused_attention(*ops, bias, kseed, heads, r),
                            tfw.fused_attention_plain(*ops, bias, kseed, heads, r))
                check(e <= tol[dtype], f"fused_attention {name} {what} dropout {r} "
                      f"{tuple(ops[0].shape)} ({tfw.kernel_route(tokens, c, dtype)})"
                      f" max|err| {e:.3e} <= {tol[dtype]}")
                got = tfw.fused_attention_backward(*ops, bias, kseed, gout, heads, r)
                want = tfw.fused_attention_backward_plain(*ops, bias, kseed, gout,
                                                          heads, r)
                n_worst, worst = worst_rel(got, want, two_names)
                check(worst <= bwd_tol[dtype], f"fused_attention backward {name} "
                      f"{what} dropout {r} worst {n_worst} rel err {worst:.2e} <= "
                      f"{bwd_tol[dtype]:.2e}")
                if dtype == bf and r > 0 and bias is rpe8:
                    errs["two"] = e
                    errs["two_bwd"] = max(max_err(a, b) for a, b in zip(got, want))
        lops = ln_operands(dtype)
        for r in (0.0, rate):
            e = max_err(tfw.fused_attention_ln(*lops, rpe8, kseed, heads, r),
                        tfw.fused_attention_ln_plain(*lops, rpe8, kseed, heads, r))
            check(e <= tol[dtype], f"fused_attention_ln {name} 8-head RPE bias, no "
                  f"pos, dropout {r} max|err| {e:.3e} <= {tol[dtype]}")
            got = tfw.fused_attention_ln_backward(*lops, rpe8, kseed, gout, heads, r)
            want = tfw.fused_attention_ln_backward_plain(*lops, rpe8, kseed, gout,
                                                         heads, r)
            check(got[-1] is not None and tuple(got[-1].shape) == (heads, tokens, tokens),
                  f"fused_attention_ln backward {name} returns the 8-head dbias")
            n_worst, worst = worst_rel(got, want, ln_names)
            check(worst <= bwd_tol[dtype], f"fused_attention_ln backward {name} "
                  f"8-head RPE bias dropout {r} worst {n_worst} rel err "
                  f"{worst:.2e} <= {bwd_tol[dtype]:.2e}")
    torch.cuda.synchronize()

    phase("8. nar_mnist full width, nar predict")
    dtype = bf if cfg.dtype == "bfloat16" else torch.float32
    enc, dec = build_autoencoder(cfg.ae, dtype, dev, torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    n_params = sum(p.numel() for m in (enc, dec, tr) for p in m.parameters())
    print(f"  params {n_params} (enc+dec+NAR {tc.num_encoder_layers}+"
          f"{tc.num_decoder_layers} layers, rpe {tc.rpe}), dtype {dtype}")
    frames = torch.rand(batch, n_past + n_fut, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 2))
    past, future = frames[:, :n_past].to(dev), frames[:, n_past:].to(dev)
    predict = make_predict_fn(cfg, enc, dec, tr, "nar", n_fut, dev)
    counters = (attention_core, tfw.fused_attention_ln, tfw.fused_attention)
    zero_counters(*counters)
    pred = predict(past)
    torch.cuda.synchronize()
    pred_launches = {"fused_attention_ln": tfw.fused_attention_ln.launches,
                     "fused_attention": tfw.fused_attention.launches,
                     "attention_core": attention_core.launches}
    enc_l, dec_l = tc.num_encoder_layers, tc.num_decoder_layers
    want = {"fused_attention_ln": enc_l, "fused_attention": dec_l,
            "attention_core": enc_l + 2 * dec_l}
    for name, n in pred_launches.items():
        check(n == want[name], f"{name} launches in the nar predict: {n} == {want[name]}")
    check(tuple(pred.shape) == (batch, n_fut, 64, 64, 1),
          f"nar output shape {tuple(pred.shape)}")
    check(bool(torch.isfinite(pred.float()).all()), "nar output finite")
    lo, hi = pred.float().min().item(), pred.float().max().item()
    check(0.0 <= lo and hi <= 1.0, f"nar output in [0, 1] ({lo:.4f}, {hi:.4f})")
    use_kernels(tr, "plain")
    ref = predict(past)
    use_kernels(tr, "cuda")
    e_nar = max_err(pred, ref)
    check(e_nar <= 5e-2, f"nar predict kernels vs kernels='plain' max|err| "
          f"{e_nar:.3e} <= 5e-2 (bf16 sigmoid frames after 12 layers)")

    phase("9. nar_mnist full width, train step")
    opt = build_optimizer(cfg.optim, c)
    print(f"  optimizer {cfg.optim.optimizer} lr {cfg.optim.lr} clip "
          f"{cfg.optim.max_grad_norm}; dropout {tc.dropout} drop_path "
          f"{tc.drop_path}; lam_nce {cfg.loss.lam_nce} at temperature "
          f"{cfg.loss.nce_temperature}")
    state = create_nar_train_state(enc, dec, tr, opt, seed=SEED + 3)
    train_step = make_nar_train_step(enc, dec, tr, opt, cfg.loss)
    zero_counters(*counters)
    state, m0 = train_step(state, past, future)
    torch.cuda.synchronize()
    step_launches = {
        "fused_attention_ln": tfw.fused_attention_ln.launches,
        "fused_attention_ln_bwd": tfw.fused_attention_ln.bwd_launches,
        "fused_attention": tfw.fused_attention.launches,
        "fused_attention_bwd": tfw.fused_attention.bwd_launches,
        "attention_core": attention_core.launches,
        "attention_core_bwd": attention_core.bwd_launches}
    want = {"fused_attention_ln": enc_l, "fused_attention_ln_bwd": enc_l,
            "fused_attention": dec_l, "fused_attention_bwd": dec_l,
            "attention_core": enc_l + 2 * dec_l,
            "attention_core_bwd": enc_l + 2 * dec_l}
    for name, n in step_launches.items():
        check(n == want[name], f"{name} launches in one NAR train step: {n} == "
              f"{want[name]}")
    check(all(bool(torch.isfinite(v)) for v in m0.values()),
          f"first NAR step metrics finite: "
          f"{ {k: round(float(v), 6) for k, v in m0.items()} }")
    a, b = state.clone(), state.clone()
    use_kernels(b.transformer, "plain")
    a, ma = train_step(a, past, future)
    b, mb = train_step(b, past, future)
    d_total = abs(float(ma["T_total"]) - float(mb["T_total"]))
    d_norm = abs(float(ma["grad_norm"]) / float(mb["grad_norm"]) - 1)
    check(d_total <= 2e-3 * max(1.0, float(mb["T_total"])),
          f"NAR step kernels vs kernels='plain' |dT_total| {d_total:.3e} "
          f"(T_total {float(ma['T_total']):.6f} vs {float(mb['T_total']):.6f})")
    check(d_norm <= 0.05, f"NAR step kernels vs kernels='plain' grad norm rel "
          f"diff {d_norm:.3e} <= 0.05 ({float(ma['grad_norm']):.6e} vs "
          f"{float(mb['grad_norm']):.6e})")
    del a, b
    fixed = state.clone()
    losses = []
    for _ in range(TRAIN_STEPS):
        fixed, m = train_step(fixed, past, future)
        losses.append(float(m["T_total"]))
    print(f"  NAR T_total over {TRAIN_STEPS} steps on one batch: "
          f"{[round(x, 6) for x in losses]}")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "NAR train losses finite")
    check(losses[-1] < losses[0], f"NAR T_total falls over {TRAIN_STEPS} steps: "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    del fixed

    phase("10. NAR timing")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(past)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    pred_ms = statistics.median(times)
    pred_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    use_kernels(tr, "plain")
    plain_pred_ms = statistics.median(
        [cuda_ms(lambda: predict(past), iters=1, warmup=0) for _ in range(3)])
    use_kernels(tr, "cuda")
    print(f"  nar predict (batch {batch}, {n_past} -> {n_fut} frames): median "
          f"{pred_ms:.3f} ms of {len(times)} ({[round(t, 3) for t in times]}), "
          f"{batch * n_fut / pred_ms * 1e3:.1f} frames/s, peak {pred_peak:.3f} "
          f"GiB (with the train state held); kernels='plain' {plain_pred_ms:.3f} ms")

    def timed_step(st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = train_step(st, past, future)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    kstate, pstate = state.clone(), state.clone()
    use_kernels(pstate.transformer, "plain")
    del state
    step_times, plain_times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        order = ((kstate, step_times), (pstate, plain_times))
        for which, out in (order if i % 2 == 0 else order[::-1]):
            ms = timed_step(which)
            if i >= WARMUP_STEPS:
                out.append(ms)
    del pstate
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed_step(kstate)
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del kstate
    step_ms, plain_step_ms = statistics.median(step_times), statistics.median(plain_times)
    train_fps = batch * n_fut / step_ms * 1e3
    print(f"  NAR train step (batch {batch}, {n_past} -> {n_fut}): median "
          f"{step_ms:.3f} ms of {len(step_times)} ({[round(t, 3) for t in step_times]}),"
          f" {train_fps:.1f} training frames/s; kernels='plain' median "
          f"{plain_step_ms:.3f} ms ({[round(t, 3) for t in plain_times]}); peak "
          f"{step_peak:.3f} GiB with one state")

    # kernels at the NAR shapes, bf16, the training dropout, the RPE bias
    ops = two_stream(bf)
    x_qk, x_v, wq, bq, wk, bk, wv, bv, wo, bo = ops
    gwin = randn(windows, tokens, c).to(dev, bf)
    mask = rpe8.to(bf)[None]

    def split(z):
        return z.view(windows, tokens, heads, hd).transpose(1, 2)

    def two_library(x_qk=x_qk, x_v=x_v, wq=wq, wk=wk, wv=wv, wo=wo):
        o = F.scaled_dot_product_attention(
            split(F.linear(x_qk, wq.t(), bq.to(bf))),
            split(F.linear(x_qk, wk.t(), bk.to(bf))),
            split(F.linear(x_v, wv.t(), bv.to(bf))), attn_mask=mask)
        return F.linear(o.transpose(1, 2).reshape(windows, tokens, c), wo.t(),
                        bo.to(bf))

    lib_in = [z.clone().requires_grad_() for z in (x_qk, x_v, wq, wk, wv, wo)]
    lib_out = two_library(*lib_in)
    lops = ln_operands(bf)
    x, ls, lb = lops[0], lops[9], lops[10]

    def ln_library(x=x, wq=wq, wk=wk, wv=wv, wo=wo):
        xn = F.layer_norm(x, (c,), ls.to(bf), lb.to(bf))
        return two_library(xn, xn, wq, wk, wv, wo)

    ln_in = [z.clone().requires_grad_() for z in (x, wq, wk, wv, wo)]
    ln_out = ln_library(*ln_in)
    s = 2   # bytes per bf16 element
    vec = 4 * c * 4 + heads * tokens * tokens * 4
    fwd_flops = 8 * rows * c * c + 4 * rows * tokens * c
    bwd_flops = 22 * rows * c * c + 12 * rows * tokens * c
    cases = (
        # name, fn, plain, library, bytes, flops
        ("fused_attention",
         lambda: tfw.fused_attention(*ops, rpe8, kseed, heads, rate),
         lambda: tfw.fused_attention_plain(*ops, rpe8, kseed, heads, rate),
         two_library, 3 * rows * c * s + 4 * c * c * s + vec, fwd_flops),
        ("fused_attention_bwd",
         lambda: tfw.fused_attention_backward(*ops, rpe8, kseed, gwin, heads, rate),
         lambda: tfw.fused_attention_backward_plain(*ops, rpe8, kseed, gwin, heads,
                                                    rate),
         lambda: torch.autograd.grad(lib_out, lib_in, gwin, retain_graph=True),
         5 * rows * c * s + 8 * c * c * s + 2 * vec, bwd_flops),
        ("fused_attention_ln (NAR shape, RPE bias)",
         lambda: tfw.fused_attention_ln(*lops, rpe8, kseed, heads, rate),
         lambda: tfw.fused_attention_ln_plain(*lops, rpe8, kseed, heads, rate),
         ln_library, 2 * rows * c * s + 4 * c * c * s + vec + 2 * c * 4,
         fwd_flops),
        ("fused_attention_ln_bwd (NAR shape, RPE bias)",
         lambda: tfw.fused_attention_ln_backward(*lops, rpe8, kseed, gwin, heads,
                                                 rate),
         lambda: tfw.fused_attention_ln_backward_plain(*lops, rpe8, kseed, gwin,
                                                       heads, rate),
         lambda: torch.autograd.grad(ln_out, ln_in, gwin, retain_graph=True),
         3 * rows * c * s + 8 * c * c * s + 2 * vec + 4 * c * 4, bwd_flops),
    )
    readings = {}
    for name, fn, plain, lib, nbytes, flops in cases:
        k_ms, p_ms = timed_turns(fn, plain)
        lib_ms = cuda_ms(lib)
        b_ms, b_by = bound(nbytes, flops)
        readings[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by)
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} "
              f"MB, {flops / 1e9:.2f} GFLOP)")
    rows_out = []
    for name, src, replaces, err, launches in (
            ("fused_attention", "vptr_tpu_torch/csrc/fused_window_attention.cu",
             "vptr_tpu/ops/fused_window_attention.py:239", errs["two"],
             pred_launches["fused_attention"]),
            ("fused_attention_bwd",
             "vptr_tpu_torch/csrc/fused_window_attention_bwd.cu",
             "vptr_tpu/ops/fused_window_attention.py:386", errs["two_bwd"],
             step_launches["fused_attention_bwd"])):
        rows_out.append({"name": name, "route": "cuda", "source": src,
                         "replaces": replaces, "launches": launches,
                         "max_abs_err": err, **readings[name],
                         "train_step_launches": step_launches[name]})
    summary = (f"nar_predict_ms {pred_ms:.3f} nar_plain_predict_ms "
               f"{plain_pred_ms:.3f} nar_train_step_ms {step_ms:.3f} "
               f"nar_plain_train_step_ms {plain_step_ms:.3f} "
               f"nar_train_frames_per_s {train_fps:.1f} nar_train_peak_gib "
               f"{step_peak:.3f}")
    extra = {"nar_predict_launches": pred_launches,
             "nar_step_launches": step_launches,
             "nar_shape_ln_kernels": {k: v for k, v in readings.items()
                                      if k.startswith("fused_attention_ln")}}
    return rows_out, extra, summary


def ffn_phases(dev):
    """Phases 11-14: the far_mnist fused-FFN route (transformer.fused_ffn
    and fused_dw). Returns (kernel rows of #7-#10, extra readings, the
    summary line)."""
    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.layers import use_kernels
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.ops import fused_dw_chain as tdw
    from vptr_tpu_torch.ops import fused_ffn as tff
    from vptr_tpu_torch.ops import fused_window_attention as tfw
    from vptr_tpu_torch.ops.attention_core import attention_core
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step

    base = get_preset("far_mnist")
    cfg = base.override({"transformer": {"fused_ffn": True, "fused_dw": True}})
    tc = cfg.transformer
    c, hid, hw, w = tc.d_model, tc.spatial_ffn_hidden_ratio * tc.d_model, \
        tc.enc_h * tc.enc_w, tc.enc_w
    ctx = tc.num_past_frames + tc.num_future_frames
    s_pred, s_step = BATCH * ctx * hw, BATCH * (ctx - 1) * hw     # FFN rows
    n_pred, n_step = BATCH * ctx, BATCH * (ctx - 1)               # dw samples
    rate = tc.dropout
    bf = torch.bfloat16
    kseed = torch.tensor([SEED + 777], dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(SEED + 30)
    tol = {torch.float32: 1e-3, bf: 6.25e-2}            # as phase 3
    bwd_tol = {torch.float32: 1e-4, bf: 2 ** -5}
    counters = (attention_core, tfw.fused_attention_ln, tff.fused_ffn,
                tdw.fused_dw_chain)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g) * std

    def ffn_ops(rows, dtype):
        return (randn(rows, c).to(dev, dtype), randn(c, hid, std=c ** -0.5).to(dev, dtype),
                randn(hid, std=0.1).to(dev), randn(hid, c, std=hid ** -0.5).to(dev, dtype),
                randn(c, std=0.1).to(dev), (1 + randn(c, std=0.1)).to(dev),
                randn(c, std=0.1).to(dev))

    def dw_ops(n, dtype):
        return (randn(n, hw, hid).to(dev, dtype), randn(9, hid, std=0.3).to(dev),
                randn(hid, std=0.1).to(dev), (1 + randn(hw, hid, std=0.1)).to(dev),
                randn(hw, hid, std=0.1).to(dev), (1 + randn(hw, hid, std=0.1)).to(dev),
                randn(hw, hid, std=0.1).to(dev))

    def worst_rel(got, want, names):
        worst = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
        name = max(worst, key=worst.get)
        return name, worst[name]

    ffn_names = ("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb")
    dw_names = ("dx", "dtaps", "ddwb", "ds1", "db1", "ds2", "db2")
    errs = {}

    phase("11. fused-FFN route kernels (#7-#10) against their plain versions (card)")
    for dtype in (bf, torch.float32):
        name = str(dtype).replace("torch.", "")
        fops, fops_t = ffn_ops(s_pred, dtype), ffn_ops(s_step, dtype)
        dops, dops_t = dw_ops(n_pred, dtype), dw_ops(n_step, dtype)
        gffn = randn(s_step, c).to(dev, dtype)
        gdw = randn(n_step, hw, hid).to(dev, dtype)
        for r in (0.0, rate):
            e = max_err(tff.fused_ffn(*fops, kseed, r), tff.fused_ffn_plain(*fops, kseed, r))
            check(e <= tol[dtype], f"fused_ffn {name} dropout {r} {tuple(fops[0].shape)} "
                  f"({tff.kernel_route(c, hid, dtype)}) max|err| {e:.3e} <= {tol[dtype]}")
            got = tff.fused_ffn_backward(*fops_t, kseed, gffn, r)
            want = tff.fused_ffn_backward_plain(*fops_t, kseed, gffn, r)
            n_worst, worst = worst_rel(got, want, ffn_names)
            check(worst <= bwd_tol[dtype], f"fused_ffn backward {name} dropout {r} "
                  f"{tuple(fops_t[0].shape)} worst {n_worst} rel err {worst:.2e} <= "
                  f"{bwd_tol[dtype]:.2e}")
            if dtype == bf and r > 0:
                errs["ffn"] = e
                errs["ffn_bwd"] = max(max_err(a, b) for a, b in zip(got, want))
            e = max_err(tdw.fused_dw_chain(*dops, kseed, w, r),
                        tdw.fused_dw_chain_plain(*dops, kseed, w, r))
            check(e <= tol[dtype], f"fused_dw_chain {name} dropout {r} "
                  f"{tuple(dops[0].shape)} max|err| {e:.3e} <= {tol[dtype]}")
            got = tdw.fused_dw_chain_backward(*dops_t, kseed, gdw, w, r)
            want = tdw.fused_dw_chain_backward_plain(*dops_t, kseed, gdw, w, r)
            n_worst, worst = worst_rel(got, want, dw_names)
            check(worst <= bwd_tol[dtype], f"fused_dw_chain backward {name} dropout {r} "
                  f"{tuple(dops_t[0].shape)} worst {n_worst} rel err {worst:.2e} <= "
                  f"{bwd_tol[dtype]:.2e}")
            if dtype == bf and r > 0:
                errs["dw"] = e
                errs["dw_bwd"] = max(max_err(a, b) for a, b in zip(got, want))
        del fops, fops_t, dops, dops_t, gffn, gdw, got, want
    torch.cuda.synchronize()

    phase("12. far_mnist fused-FFN route (fused_ffn + fused_dw), far_rip predict")
    dtype = bf if cfg.dtype == "bfloat16" else torch.float32
    enc, dec = build_autoencoder(cfg.ae, dtype, dev, torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    # the default route with the same weights (the parameter trees agree)
    tr_default = build_transformer(base.transformer, dtype, dev,
                                   torch.Generator().manual_seed(SEED + 1))
    frames = torch.rand(BATCH, PAST + FUTURE, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 2))
    past, future = frames[:, :PAST].to(dev), frames[:, PAST:].to(dev)
    predict = make_predict_fn(cfg, enc, dec, tr, "far_rip", FUTURE, dev)
    predict_default = make_predict_fn(base, enc, dec, tr_default, "far_rip", FUTURE, dev)
    zero_counters(*counters)
    pred = predict(past)
    torch.cuda.synchronize()
    pred_launches = {"fused_ffn": tff.fused_ffn.launches,
                     "fused_dw_chain": tdw.fused_dw_chain.launches,
                     "fused_attention_ln": tfw.fused_attention_ln.launches,
                     "attention_core": attention_core.launches}
    for name, n in pred_launches.items():
        check(n == LAYERS * FUTURE, f"{name} launches in the fused-route far_rip "
              f"run: {n} == {LAYERS * FUTURE}")
    check(tuple(pred.shape) == (BATCH, FUTURE, 64, 64, 1),
          f"fused-route far_rip output shape {tuple(pred.shape)}")
    check(bool(torch.isfinite(pred.float()).all()), "fused-route far_rip output finite")
    lo, hi = pred.float().min().item(), pred.float().max().item()
    check(0.0 <= lo and hi <= 1.0, f"fused-route far_rip output in [0, 1] ({lo:.4f}, "
          f"{hi:.4f})")
    use_kernels(tr, "plain")
    e_plain = max_err(pred, predict(past))
    use_kernels(tr, "cuda")
    check(e_plain <= 5e-2, f"fused-route far_rip kernels vs kernels='plain' max|err| "
          f"{e_plain:.3e} <= 5e-2")
    e_default = max_err(pred, predict_default(past))
    check(e_default <= 5e-2, f"fused-route far_rip vs the default route max|err| "
          f"{e_default:.3e} <= 5e-2 (the GELU's form and the rounding points differ)")

    phase("13. far_mnist fused-FFN route, train step")
    opt = build_optimizer(cfg.optim, c)
    state = create_far_train_state(enc, dec, tr, opt, seed=SEED + 3)
    train_step = make_far_train_step(enc, dec, tr, opt, cfg.loss)
    zero_counters(*counters)
    state, m0 = train_step(state, past, future)
    torch.cuda.synchronize()
    step_launches = {"fused_ffn": tff.fused_ffn.launches,
                     "fused_ffn_bwd": tff.fused_ffn.bwd_launches,
                     "fused_dw_chain": tdw.fused_dw_chain.launches,
                     "fused_dw_chain_bwd": tdw.fused_dw_chain.bwd_launches,
                     "fused_attention_ln": tfw.fused_attention_ln.launches,
                     "fused_attention_ln_bwd": tfw.fused_attention_ln.bwd_launches,
                     "attention_core": attention_core.launches,
                     "attention_core_bwd": attention_core.bwd_launches}
    for name, n in step_launches.items():
        check(n == LAYERS, f"{name} launches in one fused-route train step: {n} == "
              f"{LAYERS}")
    check(all(bool(torch.isfinite(v)) for v in m0.values()),
          f"first fused-route step metrics finite: "
          f"{ {k: round(float(v), 6) for k, v in m0.items()} }")
    a, b = state.clone(), state.clone()
    use_kernels(b.transformer, "plain")
    a, ma = train_step(a, past, future)
    b, mb = train_step(b, past, future)
    d_total = abs(float(ma["T_total"]) - float(mb["T_total"]))
    d_norm = abs(float(ma["grad_norm"]) / float(mb["grad_norm"]) - 1)
    check(d_total <= 2e-3 * max(1.0, float(mb["T_total"])),
          f"fused-route step kernels vs kernels='plain' |dT_total| {d_total:.3e} "
          f"(T_total {float(ma['T_total']):.6f} vs {float(mb['T_total']):.6f})")
    check(d_norm <= 0.05, f"fused-route step kernels vs kernels='plain' grad norm rel "
          f"diff {d_norm:.3e} <= 0.05 ({float(ma['grad_norm']):.6e} vs "
          f"{float(mb['grad_norm']):.6e})")
    del a, b
    fixed = state.clone()
    losses = []
    for _ in range(TRAIN_STEPS):
        fixed, m = train_step(fixed, past, future)
        losses.append(float(m["T_total"]))
    print(f"  fused-route T_total over {TRAIN_STEPS} steps on one batch: "
          f"{[round(x, 6) for x in losses]}")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "fused-route train losses finite")
    check(losses[-1] < losses[0], f"fused-route T_total falls over {TRAIN_STEPS} "
          f"steps: {losses[0]:.6f} -> {losses[-1]:.6f}")
    del fixed

    phase("14. fused-FFN route timing (against the default route, in turns)")

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    predict(past)
    predict_default(past)
    pred_times = {"fused": [], "default": []}
    for i in range(6):                 # default, fused, fused, default, ...
        order = ("default", "fused") if i % 2 == 0 else ("fused", "default")
        for route in order:
            fn = predict if route == "fused" else predict_default
            pred_times[route].append(host_ms(lambda: fn(past)))
    pred_ms = {k: statistics.median(v) for k, v in pred_times.items()}
    print(f"  far_rip predict (batch {BATCH}, {FUTURE} frames): fused route median "
          f"{pred_ms['fused']:.3f} ms ({[round(t, 3) for t in pred_times['fused']]}), "
          f"default route {pred_ms['default']:.3f} ms "
          f"({[round(t, 3) for t in pred_times['default']]})")

    dstate = create_far_train_state(enc, dec, tr_default, opt, seed=SEED + 3)
    default_step = make_far_train_step(enc, dec, tr_default, opt, base.loss)
    steps = {"fused": (train_step, state), "default": (default_step, dstate)}
    del state, dstate
    step_times = {"fused": [], "default": []}
    act_peak = {}
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        order = ("default", "fused") if i % 2 == 0 else ("fused", "default")
        for route in order:
            fn, st = steps[route]
            if i == WARMUP_STEPS - 1:   # the activation peak above what is held
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            ms = host_ms(lambda: fn(st, past, future))
            if i == WARMUP_STEPS - 1:
                act_peak[route] = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
            if i >= WARMUP_STEPS:
                step_times[route].append(ms)
    step_ms = {k: statistics.median(v) for k, v in step_times.items()}
    print(f"  FAR train step (batch {BATCH}, T {ctx - 1}): fused route median "
          f"{step_ms['fused']:.3f} ms ({[round(t, 3) for t in step_times['fused']]}), "
          f"default route {step_ms['default']:.3f} ms "
          f"({[round(t, 3) for t in step_times['default']]}); peak above the held "
          f"memory: fused {act_peak['fused']:.3f} GiB, default "
          f"{act_peak['default']:.3f} GiB")
    del steps, train_step, default_step, enc, dec, tr, tr_default, predict, predict_default
    torch.cuda.empty_cache()

    # the kernels beside their plain versions, a library yardstick and the
    # bound: #7/#9 at the far_rip shapes (dropout 0), #8/#10 at the step's
    # (dropout 0.1), bf16
    fops, fops_t, gffn = ffn_ops(s_pred, bf), ffn_ops(s_step, bf), randn(s_step, c).to(dev, bf)
    dops, dops_t = dw_ops(n_pred, bf), dw_ops(n_step, bf)
    gdw = randn(n_step, hw, hid).to(dev, bf)

    def ffn_library(x, w1, b1, w2, b2, ls, lb):
        xn = F.layer_norm(x, (c,), ls.to(bf), lb.to(bf))
        return F.linear(F.gelu(F.linear(xn, w1.t(), b1.to(bf))), w2.t(), b2.to(bf))

    def dw_library(x, taps, dwb, s1, b1, s2, b2):
        n = x.shape[0]
        img = x.view(n, tc.enc_h, w, hid).permute(0, 3, 1, 2)
        aff = lambda p: p.t().reshape(hid, tc.enc_h, w).to(bf)
        z = F.gelu(F.layer_norm(img, img.shape[1:], aff(s1), aff(b1)))
        z = F.conv2d(z, taps.t().reshape(hid, 1, 3, 3).to(bf), dwb.to(bf), padding=1,
                     groups=hid)
        return F.gelu(F.layer_norm(z, z.shape[1:], aff(s2), aff(b2)))

    def grads_of(lib, ops, gout):
        ins = [t.clone().requires_grad_() for t in ops]
        out = lib(*ins)
        if out.dim() == 4:                 # the conv yardstick's NCHW output
            gout = gout.view(out.shape[0], tc.enc_h, w, hid).permute(0, 3, 1, 2)
        return lambda: torch.autograd.grad(out, ins, gout, retain_graph=True)

    e_pred, e_step = s_pred * c, s_step * c
    d_pred, d_step = n_pred * hw * hid, n_step * hw * hid
    s2b = 2   # bytes per bf16 element
    # f32 arithmetic per element of the dw chain on the CUDA cores (two
    # LayerNorms, two A&S GELUs, the nine-tap conv, the dropout: ~80; the
    # backward recomputes them and adds two GELU derivatives, two LayerNorm
    # backwards, the transposed conv, the tap and affine sums: ~210)
    cases = (
        # name, fn, plain, library, bytes, flops, flop dtype
        ("fused_ffn", lambda: tff.fused_ffn(*fops, kseed, 0.0),
         lambda: tff.fused_ffn_plain(*fops, kseed, 0.0),
         lambda: ffn_library(*fops),
         2 * e_pred * s2b + 2 * c * hid * s2b + (hid + 3 * c) * 4,
         4 * s_pred * c * hid, bf),
        ("fused_ffn_bwd", lambda: tff.fused_ffn_backward(*fops_t, kseed, gffn, rate),
         lambda: tff.fused_ffn_backward_plain(*fops_t, kseed, gffn, rate),
         grads_of(ffn_library, fops_t, gffn),
         3 * e_step * s2b + 4 * c * hid * s2b + 2 * hid * 4 + 6 * c * 4,
         10 * s_step * c * hid, bf),
        ("fused_dw_chain", lambda: tdw.fused_dw_chain(*dops, kseed, w, 0.0),
         lambda: tdw.fused_dw_chain_plain(*dops, kseed, w, 0.0),
         lambda: dw_library(*dops),
         2 * d_pred * s2b + (10 * hid + 4 * hw * hid) * 4, 80 * d_pred, torch.float32),
        ("fused_dw_chain_bwd",
         lambda: tdw.fused_dw_chain_backward(*dops_t, kseed, gdw, w, rate),
         lambda: tdw.fused_dw_chain_backward_plain(*dops_t, kseed, gdw, w, rate),
         grads_of(dw_library, dops_t, gdw),
         3 * d_step * s2b + (20 * hid + 8 * hw * hid) * 4, 210 * d_step, torch.float32),
    )
    clusters = tdw.resident_clusters(hw, hid)
    print(f"  fused_dw_chain clusters of 8 blocks resident at once: forward "
          f"{clusters[0]}, backward {clusters[1]}")
    readings = {}
    for name, fn, plain, lib, nbytes, flops, fdt in cases:
        k_ms, p_ms = timed_turns(fn, plain)
        lib_ms = cuda_ms(lib)
        b_ms, b_by = bound(nbytes, flops, fdt)
        readings[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by)
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP {str(fdt).replace('torch.', '')})")
    rows_out = []
    for name, src, replaces, err, launches, step_n in (
            ("fused_ffn", "vptr_tpu_torch/csrc/fused_ffn.cu",
             "vptr_tpu/ops/fused_ffn.py:188", errs["ffn"], pred_launches["fused_ffn"],
             step_launches["fused_ffn"]),
            ("fused_ffn_bwd", "vptr_tpu_torch/csrc/fused_ffn_bwd.cu",
             "vptr_tpu/ops/fused_ffn.py:214", errs["ffn_bwd"],
             step_launches["fused_ffn_bwd"], step_launches["fused_ffn_bwd"]),
            ("fused_dw_chain", "vptr_tpu_torch/csrc/fused_dw_chain.cu",
             "vptr_tpu/ops/fused_dw_chain.py:294", errs["dw"],
             pred_launches["fused_dw_chain"], step_launches["fused_dw_chain"]),
            ("fused_dw_chain_bwd", "vptr_tpu_torch/csrc/fused_dw_chain_bwd.cu",
             "vptr_tpu/ops/fused_dw_chain.py:318", errs["dw_bwd"],
             step_launches["fused_dw_chain_bwd"], step_launches["fused_dw_chain_bwd"])):
        rows_out.append({"name": name, "route": "cuda", "source": src,
                         "replaces": replaces, "launches": launches,
                         "max_abs_err": err, **readings[name],
                         "train_step_launches": step_n})
    summary = (f"ffn_route_predict_ms {pred_ms['fused']:.3f} default_predict_ms "
               f"{pred_ms['default']:.3f} ffn_route_train_step_ms {step_ms['fused']:.3f} "
               f"default_train_step_ms {step_ms['default']:.3f} ffn_route_step_peak_gib "
               f"{act_peak['fused']:.3f} default_step_peak_gib {act_peak['default']:.3f}")
    extra = {"ffn_route_predict_launches": pred_launches,
             "ffn_route_step_launches": step_launches,
             "dw_chain_resident_clusters": clusters}
    return rows_out, extra, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.layers import use_kernels
    from vptr_tpu_torch.models.position import position_embedding_2d
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.ops import _build
    from vptr_tpu_torch.ops import attention_core as tac
    from vptr_tpu_torch.ops import fused_window_attention as tfw
    from vptr_tpu_torch.ops.attention_core import (
        attention_core,
        attention_core_backward_plain,
        attention_core_plain,
    )
    from vptr_tpu_torch.ops.fused_window_attention import (
        fused_attention_ln,
        fused_attention_ln_backward_plain,
        fused_attention_ln_plain,
        fused_attention_ln_res,
        kernel_route,
    )
    from vptr_tpu_torch.train.optim import build_optimizer
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step

    torch.backends.cuda.matmul.allow_tf32 = False    # plain f32 = full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    phase("1. card")
    print(f"  {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")

    phase("2. build")
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"  built {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.is_file() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- shapes of the far_rip path: N=10, context 20, 8x8 latent, C=528
    cfg = get_preset("far_mnist")
    tc = cfg.transformer
    c, heads = tc.d_model, tc.n_heads
    hd = c // heads
    ctx = tc.num_past_frames + tc.num_future_frames
    windows = BATCH * ctx * (tc.enc_h // tc.window_size) * (
        tc.enc_w // tc.window_size)
    tokens = tc.window_size ** 2
    cols = BATCH * tc.enc_h * tc.enc_w
    g = torch.Generator().manual_seed(SEED)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g) * std

    def window_operands(dtype, bw=windows, l=tokens):
        w = [randn(c, c, std=(1.0 / c) ** 0.5).to(dev, dtype) for _ in range(4)]
        b = [randn(c, std=0.02).to(dev) for _ in range(4)]
        pos = position_embedding_2d(4, 4, c).reshape(16, c)[:l]
        if l > 16:
            pos = torch.cat([pos, randn(l - 16, c)])
        return (randn(bw, l, c).to(dev, dtype), w[0], b[0], w[1], b[1], w[2],
                b[2], w[3], b[3], (1 + randn(c, std=0.1)).to(dev),
                randn(c, std=0.1).to(dev), pos.to(dev))

    causal = torch.full((ctx, ctx), -1e30).triu(1)[None].to(dev)

    def core_operands(dtype, b=cols, tq=ctx, tk=ctx):
        return tuple(randn(b, heads, t, hd).to(dev, dtype)
                     for t in (tq, tk, tk))

    # tolerances: f32 — kernel and plain differ in summation order only
    # (528-long dot products, four chained products in the window kernel);
    # bf16 — one bf16 ulp of an output of magnitude <= 8 is 2^-5, and a
    # rounding that flips at an intermediate (xn, q/k/v, weights) moves
    # the output by less than that
    tol = {torch.float32: 1e-3, torch.bfloat16: 6.25e-2}

    # the training path: T = 19 teacher-forced frames, dropout 0.1
    tt = ctx - 1
    twindows = windows // ctx * tt
    rate = tc.dropout
    kseed = torch.tensor([SEED + 12345], dtype=torch.int32, device=dev)
    # backward tolerances, relative to the larger of 1 and the largest
    # magnitude of each gradient: f32 1e-4 — summation order (the weight
    # gradients sum 12,160 rows); bf16 2^-5 — every gradient is rounded to
    # bf16 (2^-8), and an intermediate rounding (xn, q/k/v, the dropped
    # weights) that falls the other way moves the terms it feeds by one
    # bf16 ulp; the weight gradients are cast to bf16 at the end
    bwd_tol = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}
    grad_names = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo",
                  "dbo", "dls", "dlb", "dbias")

    phase("3. kernels against their plain versions (card)")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        ops = window_operands(dtype)
        e = max_err(fused_attention_ln(*ops, None, num_heads=heads),
                    fused_attention_ln_plain(*ops, None, num_heads=heads))
        check(e <= tol[dtype], f"fused_attention_ln {name} {tuple(ops[0].shape)}"
              f" ({kernel_route(tokens, c, dtype)}) max|err| {e:.3e} <= "
              f"{tol[dtype]}")
        errs[("window", dtype)] = e
        scale = (torch.rand(windows, generator=g) * 2).to(dev)
        e = max_err(fused_attention_ln_res(*ops, None, scale, num_heads=heads),
                    fused_attention_ln_plain(*ops, None, num_heads=heads,
                                             scale=scale, res=True))
        check(e <= tol[dtype], f"fused_attention_ln_res {name} (scale, res) "
              f"max|err| {e:.3e} <= {tol[dtype]}")
        ops19 = window_operands(dtype, bw=64, l=19)
        e = max_err(fused_attention_ln(*ops19, causal[:, :19, :19],
                                       num_heads=heads),
                    fused_attention_ln_plain(*ops19, causal[:, :19, :19],
                                             num_heads=heads))
        check(e <= tol[dtype], f"fused_attention_ln {name} L=19 causal bias "
              f"max|err| {e:.3e} <= {tol[dtype]}")
        q, k, v = core_operands(dtype)
        e = max_err(attention_core(q, k, v, causal),
                    attention_core_plain(q, k, v, causal))
        check(e <= tol[dtype], f"attention_core {name} {tuple(q.shape)} causal "
              f"max|err| {e:.3e} <= {tol[dtype]}")
        errs[("core", dtype)] = e
        q, k, v = core_operands(dtype, b=256, tq=10, tk=20)
        hb = torch.randn(heads, 10, 20, generator=g).to(dev)
        e = max_err(attention_core(q, k, v, hb),
                    attention_core_plain(q, k, v, hb))
        check(e <= tol[dtype], f"attention_core {name} rectangular "
              f"{tuple(q.shape)}x{tuple(k.shape)} per-head bias "
              f"max|err| {e:.3e} <= {tol[dtype]}")

        # dropout forwards at the training shapes (hash masks are exact)
        tops = window_operands(dtype, bw=twindows)
        e = max_err(fused_attention_ln(*tops, None, kseed, heads, rate),
                    fused_attention_ln_plain(*tops, None, kseed, heads, rate))
        check(e <= tol[dtype], f"fused_attention_ln {name} dropout {rate} "
              f"{tuple(tops[0].shape)} max|err| {e:.3e} <= {tol[dtype]}")
        tq_, tk_, tv_ = core_operands(dtype, tq=tt, tk=tt)
        tcausal = causal[:, :tt, :tt]
        e = max_err(attention_core(tq_, tk_, tv_, tcausal, kseed, rate),
                    attention_core_plain(tq_, tk_, tv_, tcausal, kseed, rate))
        check(e <= tol[dtype], f"attention_core {name} dropout {rate} "
              f"{tuple(tq_.shape)} causal max|err| {e:.3e} <= {tol[dtype]}")

        # backward kernels at the training shapes
        for r in (0.0, rate):
            gout = randn(twindows, tokens, c).to(dev, dtype)
            wbias = torch.randn(heads, tokens, tokens, generator=g).to(dev)
            for bias, sc, res in ((None, None, False),
                                  (wbias, (torch.rand(twindows, generator=g)
                                           * 2).to(dev), True)):
                got = tfw.fused_attention_ln_backward(
                    *tops, bias, kseed, gout, heads, r, sc, res)
                want = fused_attention_ln_backward_plain(
                    *tops, bias, kseed, gout, heads, r, sc, res)
                worst = {n: rel_err(a, b) for n, a, b in
                         zip(grad_names, got, want) if b is not None}
                n_worst = max(worst, key=worst.get)
                what = "res, scale, per-head bias" if res else "no bias"
                check(worst[n_worst] <= bwd_tol[dtype],
                      f"fused_attention_ln backward {name} dropout {r} ({what})"
                      f" worst {n_worst} rel err {worst[n_worst]:.2e} <= "
                      f"{bwd_tol[dtype]:.2e}")
                if dtype == torch.bfloat16 and r > 0 and not res:
                    errs[("window_bwd", dtype)] = max(
                        max_err(a, b) for a, b in zip(got, want) if b is not None)
            gcore = core_operands(dtype, tq=tt, tk=tt)[0]
            hbias = torch.randn(heads, tt, tt, generator=g).to(dev)
            for bias in (tcausal, hbias):
                got = tac.attention_core_backward(
                    tq_, tk_, tv_, bias, kseed, gcore, r,
                    need_dbias=bias is hbias)
                want = attention_core_backward_plain(
                    tq_, tk_, tv_, bias, kseed, gcore, r, bias is hbias)
                worst = {n: rel_err(a, b) for n, a, b in
                         zip(("dq", "dk", "dv", "dbias"), got, want)
                         if b is not None}
                n_worst = max(worst, key=worst.get)
                what = "per-head bias, dbias" if bias is hbias else "causal"
                check(worst[n_worst] <= bwd_tol[dtype],
                      f"attention_core backward {name} dropout {r} ({what}) "
                      f"worst {n_worst} rel err {worst[n_worst]:.2e} <= "
                      f"{bwd_tol[dtype]:.2e}")
                if dtype == torch.bfloat16 and r > 0 and bias is tcausal:
                    errs[("core_bwd", dtype)] = max(
                        max_err(a, b) for a, b in zip(got, want) if b is not None)
    torch.cuda.synchronize()

    phase("4. far_mnist full width, far_rip predict")
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    enc, dec = build_autoencoder(cfg.ae, dtype, dev,
                                 torch.Generator().manual_seed(SEED))
    tr = build_transformer(tc, dtype, dev, torch.Generator().manual_seed(SEED + 1))
    n_params = sum(p.numel() for m in (enc, dec, tr) for p in m.parameters())
    print(f"  params {n_params} (enc+dec+FAR), dtype {dtype}")
    frames = torch.rand(BATCH, PAST + FUTURE, 64, 64, 1,
                        generator=torch.Generator().manual_seed(SEED + 2))
    past, future = frames[:, :PAST], frames[:, PAST:]
    predict = make_predict_fn(cfg, enc, dec, tr, "far_rip", FUTURE, dev)
    zero_counters(attention_core, fused_attention_ln)
    pred = predict(past)
    torch.cuda.synchronize()
    launches = {"fused_attention_ln": fused_attention_ln.launches,
                "attention_core": attention_core.launches}
    want = LAYERS * FUTURE
    for name, n in launches.items():
        check(n == want, f"{name} launches in the far_rip run: {n} == {want}")
    check(tuple(pred.shape) == (BATCH, FUTURE, 64, 64, 1),
          f"far_rip output shape {tuple(pred.shape)}")
    check(bool(torch.isfinite(pred.float()).all()), "far_rip output finite")
    lo, hi = pred.float().min().item(), pred.float().max().item()
    check(0.0 <= lo and hi <= 1.0, f"far_rip output in [0, 1] ({lo:.4f}, "
          f"{hi:.4f})")

    far = make_predict_fn(cfg, enc, dec, tr, "far", FUTURE, dev)
    got = far(past, future)
    use_kernels(tr, "plain")
    ref = far(past, future)
    use_kernels(tr, "cuda")
    e_far = max_err(got, ref)
    check(e_far <= 5e-2, f"far mode kernels vs kernels='plain' max|err| "
          f"{e_far:.3e} <= 5e-2 (bf16 sigmoid frames after 12 layers)")

    phase("5. far_mnist full width, train step")
    opt = build_optimizer(cfg.optim, tc.d_model)
    print(f"  optimizer {cfg.optim.optimizer} lr {cfg.optim.lr} clip "
          f"{cfg.optim.max_grad_norm} mu_dtype {cfg.optim.mu_dtype}; dropout "
          f"{tc.dropout} attention dropout {tc.attention_dropout} drop_path "
          f"{tc.drop_path}")
    state = create_far_train_state(enc, dec, tr, opt, seed=SEED + 3)
    train_step = make_far_train_step(enc, dec, tr, opt, cfg.loss)
    tpast, tfuture = past.to(dev), future.to(dev)
    zero_counters(attention_core, fused_attention_ln)
    state, m0 = train_step(state, tpast, tfuture)
    torch.cuda.synchronize()
    train_launches = {
        "fused_attention_ln": fused_attention_ln.launches,
        "attention_core": attention_core.launches,
        "fused_attention_ln_bwd": fused_attention_ln.bwd_launches,
        "attention_core_bwd": attention_core.bwd_launches}
    for name, n in train_launches.items():
        check(n == LAYERS, f"{name} launches in one train step: {n} == {LAYERS}")
    check(all(bool(torch.isfinite(v)) for v in m0.values()),
          f"first step metrics finite: "
          f"{ {k: round(float(v), 6) for k, v in m0.items()} }")

    a, b = state.clone(), state.clone()
    use_kernels(b.transformer, "plain")
    a, ma = train_step(a, tpast, tfuture)
    b, mb = train_step(b, tpast, tfuture)
    d_total = abs(float(ma["T_total"]) - float(mb["T_total"]))
    d_norm = abs(float(ma["grad_norm"]) / float(mb["grad_norm"]) - 1)
    # bf16 through 12 layers and the decoder: the step's loss agrees to
    # about 1e-3 of its value; the gradient norm to a few percent
    check(d_total <= 2e-3 * max(1.0, float(mb["T_total"])),
          f"train step kernels vs kernels='plain' |dT_total| {d_total:.3e} "
          f"(T_total {float(ma['T_total']):.6f} vs {float(mb['T_total']):.6f})")
    check(d_norm <= 0.05, f"train step kernels vs kernels='plain' grad norm "
          f"rel diff {d_norm:.3e} <= 0.05 ({float(ma['grad_norm']):.6e} vs "
          f"{float(mb['grad_norm']):.6e})")
    del a, b

    fixed = state.clone()
    losses = []
    for i in range(TRAIN_STEPS):
        fixed, m = train_step(fixed, tpast, tfuture)
        losses.append(float(m["T_total"]))
    print(f"  T_total over {TRAIN_STEPS} steps on one batch: "
          f"{[round(x, 6) for x in losses]}")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "train losses finite")
    check(losses[-1] < losses[0], f"T_total falls over {TRAIN_STEPS} steps: "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    del fixed

    phase("6. timing")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30   # weights + train state
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(past)
        torch.cuda.synchronize()
        if i:                       # the first call warms up
            times.append((time.perf_counter() - t0) * 1e3)
    pred_ms = statistics.median(times)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  far_rip predict (batch {BATCH}, {FUTURE} frames): median "
          f"{pred_ms:.3f} ms of {len(times)} ({[round(t, 3) for t in times]}),"
          f" {BATCH * FUTURE / pred_ms * 1e3:.1f} frames/s, peak "
          f"{peak_gib:.3f} GiB ({held:.3f} GiB of it held before the call: "
          f"the modules and the train state)")

    use_kernels(tr, "plain")
    plain_pred_ms = statistics.median(
        [cuda_ms(lambda: predict(past), iters=1, warmup=0) for _ in range(3)])
    use_kernels(tr, "cuda")
    print(f"  far_rip predict with kernels='plain': {plain_pred_ms:.3f} ms")

    def timed_step(st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = train_step(st, tpast, tfuture)
        torch.cuda.synchronize()
        return st, (time.perf_counter() - t0) * 1e3

    # the kernels' state and the plain one take steps in turns (kernels,
    # plain, plain, kernels, ...), so host noise falls on both alike
    frames_per_step = BATCH * tt
    kstate, pstate = state.clone(), state.clone()
    use_kernels(pstate.transformer, "plain")
    del state
    torch.cuda.reset_peak_memory_stats()
    step_times, plain_times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        order = ((kstate, step_times), (pstate, plain_times))
        for which, out in (order if i % 2 == 0 else order[::-1]):
            st, ms = timed_step(which)
            if i >= WARMUP_STEPS:
                out.append(ms)
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(step_times)
    plain_step_ms = statistics.median(plain_times)
    del kstate, pstate
    print(f"  train step (batch {BATCH}, T {tt}): median {step_ms:.3f} ms of "
          f"{len(step_times)} ({[round(t, 3) for t in step_times]}), "
          f"{frames_per_step / step_ms * 1e3:.1f} frames/s; kernels='plain' "
          f"median {plain_step_ms:.3f} ms ({[round(t, 3) for t in plain_times]});"
          f" peak {step_peak:.3f} GiB with both states held")

    bf = torch.bfloat16
    wops = window_operands(bf)
    x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos = wops
    s = 2   # bytes per bf16 element

    def window_library(x=x, wq=wq, wk=wk, wv=wv, wo=wo):
        xn = F.layer_norm(x, (c,), ls.to(bf), lb.to(bf))
        xqk = xn + pos.to(bf)
        split = lambda z: z.view(x.shape[0], tokens, heads, hd).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            split(F.linear(xqk, wq.t(), bq.to(bf))),
            split(F.linear(xqk, wk.t(), bk.to(bf))),
            split(F.linear(xn, wv.t(), bv.to(bf))))
        return F.linear(o.transpose(1, 2).reshape(x.shape[0], tokens, c),
                        wo.t(), bo.to(bf))

    w_bytes = 2 * windows * tokens * c * s + 4 * c * c * s + (6 * c + tokens * c) * 4
    w_flops = 8 * windows * tokens * c * c + 4 * windows * heads * tokens * tokens * hd
    q, k, v = core_operands(bf)
    c_bytes = 4 * cols * heads * ctx * hd * s + ctx * ctx * 4
    c_flops = 4 * cols * heads * ctx * ctx * hd

    # the backward kernels at the training shapes (bf16, dropout 0.1, the
    # path's operands: no window bias, the causal temporal mask)
    rows = twindows * tokens
    tops = window_operands(bf, bw=twindows)
    gwin = randn(twindows, tokens, c).to(dev, bf)
    # x, g read; dx written; four weights read, four dW written; vectors
    wb_bytes = 3 * rows * c * s + 8 * c * c * s + (14 * c + tokens * c) * 4
    # eleven R x C x C products (q, k, v recomputed, d(attn), four dW, three
    # for d(xn)) plus the per-head attention backward
    wb_flops = 22 * rows * c * c + 12 * twindows * tokens * tokens * c
    tq_, tk_, tv_ = core_operands(bf, tq=tt, tk=tt)
    gcore = core_operands(bf, tq=tt, tk=tt)[0]
    tcausal = causal[:, :tt, :tt]
    cb_bytes = 7 * cols * heads * tt * hd * s + tt * tt * 4
    cb_flops = 10 * cols * heads * tt * tt * hd

    # the library yardstick's backward: dx and the four weight gradients
    lib_in = [z.clone().requires_grad_() for z in (tops[0], wq, wk, wv, wo)]
    lib_out = window_library(*lib_in)
    lib_g = torch.randn(lib_out.shape, generator=g).to(dev, bf)
    lq, lk, lv = (z.clone().requires_grad_() for z in (tq_, tk_, tv_))
    core_lib_out = F.scaled_dot_product_attention(lq, lk, lv,
                                                  attn_mask=tcausal.to(bf))

    rows_out = []
    for name, src, replaces, fn, plain, lib, nbytes, flops, err, n_launch in (
        ("fused_attention_ln", "vptr_tpu_torch/csrc/fused_window_attention_ln.cu",
         "vptr_tpu/ops/fused_window_attention.py:586",
         lambda: fused_attention_ln(*wops, None, num_heads=heads),
         lambda: fused_attention_ln_plain(*wops, None, num_heads=heads),
         window_library, w_bytes, w_flops, errs[("window", bf)],
         launches["fused_attention_ln"]),
        ("attention_core", "vptr_tpu_torch/csrc/attention_core.cu",
         "vptr_tpu/ops/attention_core.py:188",
         lambda: attention_core(q, k, v, causal),
         lambda: attention_core_plain(q, k, v, causal),
         lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=causal.to(bf)),
         c_bytes, c_flops, errs[("core", bf)], launches["attention_core"]),
        ("fused_attention_ln_bwd",
         "vptr_tpu_torch/csrc/fused_window_attention_ln_bwd.cu",
         "vptr_tpu/ops/fused_window_attention.py:769",
         lambda: tfw.fused_attention_ln_backward(*tops, None, kseed, gwin, heads,
                                                 rate),
         lambda: fused_attention_ln_backward_plain(*tops, None, kseed, gwin,
                                                   heads, rate),
         lambda: torch.autograd.grad(lib_out, lib_in, lib_g, retain_graph=True),
         wb_bytes, wb_flops, errs[("window_bwd", bf)],
         train_launches["fused_attention_ln_bwd"]),
        ("attention_core_bwd", "vptr_tpu_torch/csrc/attention_core.cu",
         "vptr_tpu/ops/attention_core.py:317",
         lambda: tac.attention_core_backward(tq_, tk_, tv_, tcausal, kseed,
                                             gcore, rate, need_dbias=False),
         lambda: attention_core_backward_plain(tq_, tk_, tv_, tcausal, kseed,
                                               gcore, rate, False),
         lambda: torch.autograd.grad(core_lib_out, (lq, lk, lv), gcore,
                                     retain_graph=True),
         cb_bytes, cb_flops, errs[("core_bwd", bf)],
         train_launches["attention_core_bwd"]),
    ):
        before = (attention_core.launches, fused_attention_ln.launches,
                  attention_core.bwd_launches, fused_attention_ln.bwd_launches)
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(fn), cuda_ms(fn), cuda_ms(plain))
        (attention_core.launches, fused_attention_ln.launches,
         attention_core.bwd_launches, fused_attention_ln.bwd_launches) = before
        lib_ms = cuda_ms(lib)
        b_ms, b_by = bound(nbytes, flops)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": n_launch,
               "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "train_step_launches": train_launches[name]}
        rows_out.append(row)
        print(f"  {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f}"
              f" ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")

    # the FAR path's modules and operands go before the NAR phases
    del enc, dec, tr, predict, far, wops, tops, q, k, v, lib_in, lib_out
    del lq, lk, lv, core_lib_out, gwin, gcore, tq_, tk_, tv_
    torch.cuda.empty_cache()
    nar_rows, nar_extra, nar_summary = nar_phases(dev)
    rows_out += nar_rows
    torch.cuda.empty_cache()
    ffn_rows, ffn_extra, ffn_summary = ffn_phases(dev)
    rows_out += ffn_rows

    phase("15. result")
    print(f"  predict_ms {pred_ms:.3f} plain_predict_ms {plain_pred_ms:.3f} "
          f"train_step_ms {step_ms:.3f} plain_train_step_ms {plain_step_ms:.3f} "
          f"train_frames_per_s {frames_per_step / step_ms * 1e3:.1f} "
          f"train_peak_gib {step_peak:.3f}")
    print(f"  {nar_summary}")
    print(f"  {json.dumps(nar_extra)}")
    print(f"  {ffn_summary}")
    print(f"  {json.dumps(ffn_extra)}")
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
