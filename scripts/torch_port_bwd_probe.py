"""Where the time goes inside the port's backward kernels, on one GPU.

    python3 scripts/torch_port_bwd_probe.py [--calls 10] [--root DIR]

Runs the window-attention backwards -- ``fused_attention_ln_backward``
(#3: 760 windows x 16 tokens x 528 channels, 8 heads, bf16, dropout 0.1,
one far_mnist training layer; and 640 x 19, causal, the folded temporal
sublayer's) and ``fused_attention_backward`` (#6: 640 x 16 x 528, the
8-head relative-position bias, dropout 0.1, the nar_mnist decoder's) --
and the attention-core backward (640 x 8 heads x 19 x 66, causal) a few
times, then traces ``--calls`` more of each with torch.profiler and
prints, per call, the device time of every kernel they launch (the
window backwards are several passes: LayerNorm rows, the products, the
attention per (window, head), the column sums). Also prints ptxas's
register / spill report of each kernel of the two backward libraries.
``--root`` imports the package of another checkout (e.g. the parent,
unpacked with git archive). Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--calls", type=int, default=10)
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_bwd_probe: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vptr_tpu_torch.ops import _build
    from vptr_tpu_torch.ops import attention_core as tac
    from vptr_tpu_torch.ops import fused_window_attention as tfw

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    c, heads = 528, 8

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    w = [r(c, c, std=c ** -0.5).to(bf) for _ in range(4)]
    b = [r(c, std=0.02) for _ in range(4)]
    win = (r(760, 16, c).to(bf), w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3],
           1 + r(c, std=0.1), r(c, std=0.1), r(16, c), None)
    gwin = r(760, 16, c).to(bf)
    q, k, v, gq = (r(640, heads, 19, c // heads).to(bf) for _ in range(4))
    causal = torch.full((19, 19), -1e30, device=dev).triu(1)[None]
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    temporal = (r(640, 19, c).to(bf),) + win[1:11] + (r(19, c), causal)
    gtemp = r(640, 19, c).to(bf)
    two = (r(640, 16, c).to(bf), r(640, 16, c).to(bf)) + win[1:9] + (
        r(heads, 16, 16, std=0.5),)
    gtwo = r(640, 16, c).to(bf)
    calls = {
        "fused_attention_ln backward": lambda: tfw.fused_attention_ln_backward(
            *win, seed, gwin, heads, 0.1),
        "fused_attention_ln backward 640x19 causal": lambda: tfw.fused_attention_ln_backward(
            *temporal, seed, gtemp, heads, 0.1, need_dbias=False),
        "fused_attention backward 640x16 8-head bias": lambda: tfw.fused_attention_backward(
            *two, seed, gtwo, heads, 0.1),
        "attention_core backward": lambda: tac.attention_core_backward(
            q, k, v, causal, seed, gq, 0.1, need_dbias=False),
    }
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total / 1e3 / args.calls,
                        e.count // args.calls, e.key) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        print(f"{name}: {sum(x[0] for x in rows):.4f} ms of device time per call")
        for ms, n, key in rows:
            print(f"  {ms:8.4f} ms x{n} {key[:110]}")
    for lib in ("fused_window_attention_ln_bwd", "fused_window_attention_bwd"):
        entry = ""
        for line in _build.library_path(lib).with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:70]
            if "registers" in line or "spill" in line:
                print(f"  {lib} {entry}: {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
