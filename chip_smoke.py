"""On-card smoke run of the PyTorch/CUDA port (vptr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, without the final result line):
1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
   and print the build time and ptxas's register / spill report;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the far_mnist far_rip path gives it, in bf16 and f32, plus a
   rectangular attention core and the residual/scale window variant;
4. build far_mnist at full width from a seed (AE ngf 64 / feat 528 / 9 res
   blocks, FAR 12 layers / d 528 / 8 heads), run the far_rip predict entry
   point for 10 frames from 10 past frames at batch 10 with every launch
   counter set to 0 just before and read just after (each kernel must run
   12 layers x 10 steps = 120 times), check the frames, and compare the
   teacher-forced "far" mode with kernels against kernels="plain";
5. time the far_rip predict call and each kernel beside its plain version,
   a PyTorch library yardstick and its bound (bytes or operations over the
   card's published peak);
6. print {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

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
    from vptr_tpu_torch.ops.attention_core import (
        attention_core,
        attention_core_plain,
    )
    from vptr_tpu_torch.ops.fused_window_attention import (
        fused_attention_ln,
        fused_attention_ln_plain,
        fused_attention_ln_res,
        kernel_route,
    )

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
    attention_core.launches = 0
    fused_attention_ln.launches = 0
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

    phase("5. timing")
    torch.cuda.reset_peak_memory_stats()
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
          f"{peak_gib:.3f} GiB")

    use_kernels(tr, "plain")
    plain_pred_ms = statistics.median(
        [cuda_ms(lambda: predict(past), iters=1, warmup=0) for _ in range(3)])
    use_kernels(tr, "cuda")
    print(f"  far_rip predict with kernels='plain': {plain_pred_ms:.3f} ms")

    bf = torch.bfloat16
    wops = window_operands(bf)
    x, wq, bq, wk, bk, wv, bv, wo, bo, ls, lb, pos = wops
    s = 2   # bytes per bf16 element

    def window_library():
        xn = F.layer_norm(x, (c,), ls.to(bf), lb.to(bf))
        xqk = xn + pos.to(bf)
        split = lambda z: z.view(windows, tokens, heads, hd).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            split(F.linear(xqk, wq.t(), bq.to(bf))),
            split(F.linear(xqk, wk.t(), bk.to(bf))),
            split(F.linear(xn, wv.t(), bv.to(bf))))
        return F.linear(o.transpose(1, 2).reshape(windows, tokens, c), wo.t(),
                        bo.to(bf))

    w_bytes = 2 * windows * tokens * c * s + 4 * c * c * s + (6 * c + tokens * c) * 4
    w_flops = 8 * windows * tokens * c * c + 4 * windows * heads * tokens * tokens * hd
    q, k, v = core_operands(bf)
    c_bytes = 4 * cols * heads * ctx * hd * s + ctx * ctx * 4
    c_flops = 4 * cols * heads * ctx * ctx * hd

    def bound(nbytes, flops):
        tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[bf] * 1e3
        return (tf, "operations") if tf >= tb else (tb, "bytes")

    rows = []
    for name, src, replaces, fn, plain, lib, nbytes, flops, err in (
        ("fused_attention_ln", "vptr_tpu_torch/csrc/fused_window_attention_ln.cu",
         "vptr_tpu/ops/fused_window_attention.py:586",
         lambda: fused_attention_ln(*wops, None, num_heads=heads),
         lambda: fused_attention_ln_plain(*wops, None, num_heads=heads),
         window_library, w_bytes, w_flops, errs[("window", bf)]),
        ("attention_core", "vptr_tpu_torch/csrc/attention_core.cu",
         "vptr_tpu/ops/attention_core.py:188",
         lambda: attention_core(q, k, v, causal),
         lambda: attention_core_plain(q, k, v, causal),
         lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=causal.to(bf)),
         c_bytes, c_flops, errs[("core", bf)]),
    ):
        before = (attention_core.launches, fused_attention_ln.launches)
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(fn), cuda_ms(fn), cuda_ms(plain))
        attention_core.launches, fused_attention_ln.launches = before
        lib_ms = cuda_ms(lib)
        b_ms, b_by = bound(nbytes, flops)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": min(k1, k2), "plain_ms": min(p1, p2),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        rows.append(row)
        print(f"  {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f}"
              f" ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")

    phase("6. result")
    print(f"  predict_ms {pred_ms:.3f} plain_predict_ms {plain_pred_ms:.3f}")
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
