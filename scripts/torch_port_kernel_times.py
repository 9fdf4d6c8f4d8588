"""Forward-kernel and far_rip predict times of one checkout of the port, for
comparing two checkouts on one GPU.

    python3 scripts/torch_port_kernel_times.py [--root DIR] [--repeats 5]

Imports ``vptr_tpu_torch`` from ``--root`` (default: the checkout holding
this script), builds its kernels there, and times at dropout 0 and the
far_rip shapes (bf16):
* ``fused_attention_ln``: 800 windows x 16 tokens x 528 channels, 8 heads,
  the position table, no bias;
* ``attention_core``: 640 x 8 heads x 20 x 66, causal;
each as the mean CUDA-event time of 50 back-to-back calls after 5 warm-ups,
``--repeats`` times; and the full-width far_mnist far_rip predict (batch 10,
10 past -> 10 predicted frames, random weights from a seed), host clock
around a synchronised call, ``--repeats`` calls after one warm-up. Prints
one JSON line with every reading and their medians. To compare two trees,
run it on each in turns (A B B A) within one machine. Needs a GPU; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
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


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_kernel_times: no GPU", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import vptr_tpu_torch
    if Path(vptr_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"vptr_tpu_torch imported from {vptr_tpu_torch.__file__}, "
                           f"not from {root}")
    from vptr_tpu_torch.config import get_preset
    from vptr_tpu_torch.eval.harness import make_predict_fn
    from vptr_tpu_torch.models.autoencoder import build_autoencoder
    from vptr_tpu_torch.models.transformer import build_transformer
    from vptr_tpu_torch.ops.attention_core import attention_core
    from vptr_tpu_torch.ops.fused_window_attention import fused_attention_ln

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    c, heads, ctx = 528, 8, 20

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    w = [r(c, c, std=c ** -0.5).to(bf) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    win = (r(800, 16, c).to(bf), w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3],
           1 + r(c, std=0.1), r(c, std=0.1), r(16, c))
    q, k, v = (r(640, heads, ctx, c // heads).to(bf) for _ in range(3))
    causal = torch.full((ctx, ctx), -1e30, device=dev).triu(1)[None]

    cfg = get_preset("far_mnist")
    enc, dec = build_autoencoder(cfg.ae, bf, dev, torch.Generator().manual_seed(0))
    tr = build_transformer(cfg.transformer, bf, dev, torch.Generator().manual_seed(1))
    past = torch.rand(10, 10, 64, 64, 1, generator=torch.Generator().manual_seed(2))
    predict = make_predict_fn(cfg, enc, dec, tr, "far_rip", 10, dev)

    readings = {"fused_attention_ln_ms": [], "attention_core_ms": [],
                "predict_ms": []}
    predict(past)
    for _ in range(args.repeats):
        readings["fused_attention_ln_ms"].append(
            cuda_ms(lambda: fused_attention_ln(*win, None, num_heads=heads)))
        readings["attention_core_ms"].append(
            cuda_ms(lambda: attention_core(q, k, v, causal)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(past)
        torch.cuda.synchronize()
        readings["predict_ms"].append((time.perf_counter() - t0) * 1e3)
    out = {"root": str(root)}
    for name, xs in readings.items():
        out[name] = statistics.median(xs)
        out[name.replace("_ms", "_all")] = xs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
