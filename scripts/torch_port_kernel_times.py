"""Kernel, far_rip predict and FAR train step times of one checkout of the
port, for comparing two checkouts on one GPU.

    python3 scripts/torch_port_kernel_times.py [--root DIR] [--repeats 5]
        [--conv-route] [--kernels-only] [--only NAME ...]

Imports ``vptr_tpu_torch`` from ``--root`` (default: the checkout holding
this script), builds its kernels there, and times in bf16, at the far_mnist
shapes:
* ``fused_attention_ln`` (#1): 800 windows x 16 tokens x 528 channels, 8
  heads, the position table, no bias, dropout 0 (the far_rip shape); as
  the folded temporal sublayer calls it, 640 x 20 causal with the position
  table (``..._t20_ms``) and 1024 x 10 (``..._t10_ms``); and as the NAR
  encoder does, 640 x 16 with the 8-head relative-position bias, no
  position table (``..._nar_ms``);
* ``fused_attention`` (#5): 640 x 16 x 528 with the 8-head relative-position
  bias, dropout 0 (the nar_mnist decoder's shape);
* ``attention_core`` (#2): 640 x 8 heads x 20 x 66, causal, dropout 0,
  contiguous q, k, v; in the attention layer's strided layout (the (B, H,
  T, D) view of its projections' (B, T, H*D), ``..._strided_ms``; a tree
  whose kernel refuses that layout is timed as its layer ran it: the
  three contiguous copies, the call and the output copied back); and at
  nar_mnist's 1024 x 8 x 10 x 66, no bias, contiguous (``..._nar_ms``);
* ``fused_attention_ln_backward`` (#3): 760 windows, dropout 0.1 (the
  train step's shape), and 640 x 19 causal with the position table, as
  the folded temporal sublayer's step calls it (``..._t19_ms``);
* ``fused_attention_backward`` (#6): 640 x 16 x 528 with the 8-head
  relative-position bias, dropout 0.1 (the nar_mnist step's shape);
* ``attention_core_backward`` (#4): 640 x 8 x 19 x 66, causal, dropout 0.1,
  contiguous q, k, v, g; in the attention layer's layout (q, k, v and g
  the (B, H, T, D) views of (B, T, H*D) tensors, ``..._strided_ms``; a
  tree whose kernel refuses that layout is timed as its layer ran it: the
  four contiguous copies, the call and dq, dk, dv copied into the
  projections' layout); and at nar_mnist's step shape, 1024 x 8 x 10 x 66,
  no bias, dropout 0.1, in the layer's layout (``..._nar_ms``, with the
  copies where the tree refuses it);
* #2 and #4 on their long route at TSLMA's (64 windows, 8 heads, 160,
  160, 66) in the layer's layout, no bias, dropout 0 forward and 0.1
  backward (``attention_core_long_ms``, ``attention_core_bwd_long_ms``;
  null for a tree without the long route);
* where the tree has the fused feed-forward route: ``fused_ffn`` (#7)
  12,800 x 528 rows, hidden 2112, dropout 0; its backward (#8) 12,160 rows,
  dropout 0.1; ``fused_dw_chain`` (#9) 200 x 64 x 2112, dropout 0; its
  backward (#10) 190 samples, dropout 0.1;
* with ``--conv-route``, where the tree has it: ``conv_ln_gelu`` (#11) over
  200 samples of 64 positions at both conv-FFN stages (fc1 528 -> 2112,
  fc2 2112 -> 528), its backward (#12) over 190;
each as the mean CUDA-event time of 50 back-to-back calls after 5 warm-ups,
``--repeats`` times; the full-width far_mnist far_rip predict (batch 10,
10 past -> 10 predicted frames, random weights from a seed), host clock
around a synchronised call, ``--repeats`` calls after one warm-up; and the
far_mnist train step (batch 10, T = 19, dropout 0.1), host clock around a
synchronised step, ``2 * --repeats`` steps after two warm-ups; both again
on the fused feed-forward route (``ffn_route_*``; null for a tree without
it) and, with ``--conv-route``, on the conv-FFN route with the folded
temporal sublayer (``conv_route_*``; null for a tree without it);
``--kernels-only`` times the kernels alone (no model, predict or step);
``--only`` times only the kernels named (e.g. ``fused_dw_chain_ms``), so
that a kernel can be read in a process of its own; ``--graph`` times each
kernel's call replayed from a CUDA graph instead (the device time alone,
without the wrapper's host time between calls). Prints
one JSON line with every reading and their medians. To compare
two trees, run it on each in turns (A B B A) within one machine. Needs a
GPU; exits non-zero without one.
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


def graph_ms(fn) -> float:
    """cuda_ms of the replays of fn captured in a CUDA graph (one warm-up
    call on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--conv-route", action="store_true",
                        help="also time #11/#12 and the conv-FFN route")
    parser.add_argument("--kernels-only", action="store_true",
                        help="time the kernels alone, no predict or train step")
    parser.add_argument("--only", nargs="*", help="the kernels to time (default: all)")
    parser.add_argument("--graph", action="store_true",
                        help="time the kernels' calls replayed from CUDA graphs")
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
    from vptr_tpu_torch.ops.attention_core import (
        attention_core,
        attention_core_backward,
    )
    from vptr_tpu_torch.ops.fused_window_attention import (
        fused_attention,
        fused_attention_backward,
        fused_attention_ln,
        fused_attention_ln_backward,
    )
    from vptr_tpu_torch.train.optim import build_optimizer
    try:
        from vptr_tpu_torch.ops import fused_dw_chain as tdw
        from vptr_tpu_torch.ops import fused_ffn as tff
    except ImportError:         # a tree from before the fused-FFN route
        tdw = tff = None
    tcl = None
    if args.conv_route:
        try:
            from vptr_tpu_torch.ops import conv_ln_gelu as tcl
        except ImportError:     # a tree from before the conv-FFN route
            pass
    from vptr_tpu_torch.train.state import create_far_train_state
    from vptr_tpu_torch.train.steps import make_far_train_step

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
    sq, sk, sv = (r(640, ctx, c).to(bf).view(640, ctx, heads, c // heads).transpose(1, 2)
                  for _ in range(3))
    nq, nk, nv = (r(1024, heads, ctx // 2, c // heads).to(bf) for _ in range(3))
    try:
        attention_core(sq, sk, sv, causal)
        strided_core = lambda: attention_core(sq, sk, sv, causal)
    except ValueError:          # a tree from before the strided layout: its layer's copies
        def strided_core():
            out = attention_core(sq.contiguous(), sk.contiguous(), sv.contiguous(), causal)
            return out.transpose(1, 2).reshape(640, ctx, c)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)

    def strided(b_, t_):
        return r(b_, t_, c).to(bf).view(b_, t_, heads, c // heads).transpose(1, 2)

    def strided_core_bwd(ops, bias):
        """#4 on the layer's operands: the call, or (a tree that refuses the
        layout) the copies in, the call and the copies out."""
        try:
            attention_core_backward(*ops[:3], bias, seed, ops[3], 0.1, need_dbias=False)
            return lambda: attention_core_backward(*ops[:3], bias, seed, ops[3], 0.1,
                                                   need_dbias=False)
        except ValueError:
            def copied():
                grads = attention_core_backward(*(x.contiguous() for x in ops[:3]), bias,
                                                seed, ops[3].contiguous(), 0.1,
                                                need_dbias=False)
                return [x.transpose(1, 2).reshape(x.shape[0], x.shape[2], c)
                        for x in grads[:3]]
            return copied
    lq, lk, lv, lg = (strided(64, 160) for _ in range(4))
    try:
        attention_core(lq, lk, lv)
        long_core = {
            "attention_core_long_ms": lambda: attention_core(lq, lk, lv),
            "attention_core_bwd_long_ms": lambda: attention_core_backward(
                lq, lk, lv, None, seed, lg, 0.1, need_dbias=False)}
    except ValueError:          # a tree from before the long route
        long_core = {}
    twin = (r(760, 16, c).to(bf),) + win[1:]
    gwin = r(760, 16, c).to(bf)
    tq, tk, tv, gcore = (r(640, heads, ctx - 1, c // heads).to(bf) for _ in range(4))
    tcausal = causal[:, :ctx - 1, :ctx - 1]
    core_bwd_strided = strided_core_bwd([strided(640, ctx - 1) for _ in range(4)], tcausal)
    core_bwd_nar = strided_core_bwd([strided(1024, ctx // 2) for _ in range(4)], None)
    t19 = (r(640, ctx - 1, c).to(bf),) + win[1:11] + (r(ctx - 1, c), tcausal)
    g19 = r(640, ctx - 1, c).to(bf)
    two = (r(640, 16, c).to(bf), r(640, 16, c).to(bf)) + win[1:9] + (
        r(heads, 16, 16, std=0.5),)
    gtwo = r(640, 16, c).to(bf)
    t20 = (r(640, ctx, c).to(bf),) + win[1:11] + (r(ctx, c), causal)
    t10 = (r(1024, 10, c).to(bf),) + win[1:11] + (r(10, c), None)
    nar = (r(640, 16, c).to(bf),) + win[1:11] + (None, two[-1])

    cfg = get_preset("far_mnist")
    routes = {} if args.kernels_only else {"": cfg}
    if tff is not None and routes:
        routes["ffn_route_"] = cfg.override(
            {"transformer": {"fused_ffn": True, "fused_dw": True}})
    if tcl is not None and routes:
        routes["conv_route_"] = cfg.override(
            {"transformer": {"fused_conv_ffn": True, "fused_full_temporal": True}})
    enc, dec = (build_autoencoder(cfg.ae, bf, dev, torch.Generator().manual_seed(0))
                if routes else (None, None))
    trs = {route: build_transformer(rc.transformer, bf, dev,
                                    torch.Generator().manual_seed(1))
           for route, rc in routes.items()}
    past = torch.rand(10, 10, 64, 64, 1, generator=torch.Generator().manual_seed(2))
    predicts = {route: make_predict_fn(routes[route], enc, dec, tr, "far_rip", 10, dev)
                for route, tr in trs.items()}

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    kernels = {
        "fused_attention_ln_ms": lambda: fused_attention_ln(*win, None,
                                                            num_heads=heads),
        "fused_attention_ln_t20_ms": lambda: fused_attention_ln(*t20, num_heads=heads),
        "fused_attention_ln_t10_ms": lambda: fused_attention_ln(*t10, num_heads=heads),
        "fused_attention_ln_nar_ms": lambda: fused_attention_ln(*nar, num_heads=heads),
        "fused_attention_ms": lambda: fused_attention(*two, num_heads=heads),
        "attention_core_ms": lambda: attention_core(q, k, v, causal),
        "attention_core_strided_ms": strided_core,
        "attention_core_nar_ms": lambda: attention_core(nq, nk, nv),
        "fused_attention_ln_bwd_ms": lambda: fused_attention_ln_backward(
            *twin, None, seed, gwin, heads, 0.1),
        "fused_attention_ln_bwd_t19_ms": lambda: fused_attention_ln_backward(
            *t19, seed, g19, heads, 0.1, need_dbias=False),
        "fused_attention_bwd_ms": lambda: fused_attention_backward(
            *two, seed, gtwo, heads, 0.1),
        "attention_core_bwd_ms": lambda: attention_core_backward(
            tq, tk, tv, tcausal, seed, gcore, 0.1, need_dbias=False),
        "attention_core_bwd_strided_ms": core_bwd_strided,
        "attention_core_bwd_nar_ms": core_bwd_nar,
        **long_core,
    }
    if tff is not None:
        hid = 4 * c
        fops = (r(12800, c).to(bf), r(c, hid, std=c ** -0.5).to(bf), r(hid, std=0.1),
                r(hid, c, std=hid ** -0.5).to(bf), r(c, std=0.1), 1 + r(c, std=0.1),
                r(c, std=0.1))
        fops_t, gffn = (r(12160, c).to(bf),) + fops[1:], r(12160, c).to(bf)
        dops = (r(200, 64, hid).to(bf), r(9, hid, std=0.3), r(hid, std=0.1),
                1 + r(64, hid, std=0.1), r(64, hid, std=0.1), 1 + r(64, hid, std=0.1),
                r(64, hid, std=0.1))
        dops_t, gdw = (r(190, 64, hid).to(bf),) + dops[1:], r(190, 64, hid).to(bf)
        kernels.update({
            "fused_ffn_ms": lambda: tff.fused_ffn(*fops, seed, 0.0),
            "fused_ffn_bwd_ms": lambda: tff.fused_ffn_backward(*fops_t, seed, gffn, 0.1),
            "fused_dw_chain_ms": lambda: tdw.fused_dw_chain(*dops, seed, 8, 0.0),
            "fused_dw_chain_bwd_ms": lambda: tdw.fused_dw_chain_backward(
                *dops_t, seed, gdw, 8, 0.1),
        })
    if tcl is not None:
        hid = 4 * c

        def conv_ops(n, cin, cout):
            return (r(n, 64, cin).to(bf), r(cin, cout, std=cin ** -0.5).to(bf),
                    r(cout, std=0.1), 1 + r(64, cout, std=0.1), r(64, cout, std=0.1))

        for stage, (cin, cout) in (("fc1", (c, hid)), ("fc2", (hid, c))):
            cops, cops_t = conv_ops(200, cin, cout), conv_ops(190, cin, cout)
            gconv = r(190, 64, cout).to(bf)
            kernels.update({
                f"conv_ln_gelu_{stage}_ms":
                    lambda cops=cops: tcl.conv_ln_gelu(*cops),
                f"conv_ln_gelu_bwd_{stage}_ms":
                    lambda cops_t=cops_t, gconv=gconv: tcl.conv_ln_gelu_backward(
                        *cops_t, gconv),
            })
    if args.only:
        kernels = {name: fn for name, fn in kernels.items() if name in args.only}
    readings = {name: [] for name in kernels}
    for route in routes:
        readings.update({f"{route}predict_ms": [], f"{route}train_step_ms": []})
    for predict in predicts.values():
        predict(past)
    for _ in range(args.repeats):
        for name, fn in kernels.items():
            readings[name].append(graph_ms(fn) if args.graph else cuda_ms(fn))
        for route, predict in predicts.items():
            readings[f"{route}predict_ms"].append(host_ms(lambda: predict(past)))

    opt = build_optimizer(cfg.optim, cfg.transformer.d_model)
    future = torch.rand(10, 10, 64, 64, 1,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    past = past.to(dev)
    for route, tr in trs.items():
        state = create_far_train_state(enc, dec, tr, opt, seed=3)
        step = make_far_train_step(enc, dec, tr, opt, cfg.loss)
        for i in range(2 + 2 * args.repeats):
            ms = host_ms(lambda: step(state, past, future))
            if i >= 2:
                readings[f"{route}train_step_ms"].append(ms)
        del state, step
    out = {"root": str(root), "graph": args.graph}
    for name, xs in readings.items():
        out[name] = statistics.median(xs)
        out[name.replace("_ms", "_all")] = xs
    if not long_core:
        out["attention_core_long_ms"] = out["attention_core_bwd_long_ms"] = None
    if tff is None:
        for name in ("fused_ffn_ms", "fused_ffn_bwd_ms", "fused_dw_chain_ms",
                     "fused_dw_chain_bwd_ms", "ffn_route_predict_ms",
                     "ffn_route_train_step_ms"):
            out[name] = None
    if args.conv_route and tcl is None:
        for name in ("conv_ln_gelu_fc1_ms", "conv_ln_gelu_bwd_fc1_ms",
                     "conv_ln_gelu_fc2_ms", "conv_ln_gelu_bwd_fc2_ms",
                     "conv_route_predict_ms", "conv_route_train_step_ms"):
            out[name] = None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
