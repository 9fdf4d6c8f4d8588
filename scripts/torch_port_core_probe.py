"""Where kernel #2's (attention core forward, bf16 "mma" route) or, with
--bwd, kernel #4's (its backward, bf16 "mma" route) time goes, on one GPU;
with --long, both on their bf16 "long" route.

    python3 scripts/torch_port_core_probe.py [--bwd | --long] [--repeats 3]
        [--only NAME ...]

Times attention_core in bf16 at the shapes its paths give it: far_rip's
640 x 8 heads x 20 x 66 with the causal bias, on contiguous q, k, v
("far_rip contiguous") and on the attention layer's strided ones (the
(B, H, T, D) view of its projections' (B, T, H*D), "far_rip strided");
the FAR step's 640 x 8 x 19 causal with dropout 0.1 ("FAR step
strided"); nar_mnist's 1024 x 8 x 10 ("NAR strided"). The committed
kernel is read first and last; between them, copies of the package under
build/core_probe/ whose csrc/attention_core.cu is changed in one place
(VARIANTS): another design choice (right values), or one part of the work
left out (wrong values by design), whose difference from the committed
kernel is that part's time. Each tree is timed in its own process, each
case two ways: the mean CUDA-event time of 50 back-to-back calls after 5
warm-ups (what a caller that launches one call after another sees; the
wrapper's host time bounds it where that is longer than the kernel's),
and of 50 replays of the call captured in a CUDA graph ("... (graph)":
the device time alone); --repeats times, the best kept; and its largest
difference from the plain version ("... max|err|"; a variant that keeps
the work whole should stay within 2^-4). A last case times far_rip's
contiguous shape again on operands allocated after the others. With
--bwd the cases are the backward's: the FAR step's 640 x 8 x 19 causal
with dropout 0.1 on the layer's strided q, k, v, g ("FAR step strided")
and on contiguous ones ("FAR step contiguous"), and the NAR step's 1024 x
8 x 10 with dropout 0.1, strided ("NAR step strided"); the variants
BWD_VARIANTS, and the error is the largest of dq's, dk's and dv's
relative to max(1, the plain gradient's largest magnitude) (a variant
that keeps the work whole should stay within 2^-5). With --long the cases
are TSLMA's, in the layer's layout: nar_mnist's (64 windows, 8 heads, 160,
160, 66) and nar_bair's 160 x 32, the forward without dropout and the
backward with 0.1 ("... fwd", "... bwd"), and the variants LONG_VARIANTS
(each changes the forward's or the backward's long kernel; the error of
a "bwd" case as --bwd's). The copies'
libraries are all built first, in parallel. Prints
one JSON line with every reading, the card's name, and each variant's
time less the committed kernel's (the mean of its two readings). Exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CORE = "csrc/attention_core.cu"
# variant -> [(text it replaces (every occurrence), replacement), ...]; a
# forward variant's text may also occur in the backward kernel, which the
# forward's cases do not run
VARIANTS = {
    "persistent ring of two stages": [
        ("constexpr int kMmaStages = 1;", "constexpr int kMmaStages = 2;")],
    "q scaled in f32": [
        ("  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&pair), "
         "scale);\n  return *reinterpret_cast<const uint32_t*>(&r);",
         "  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));"
         "\n  const float s = __low2float(scale);\n  return pack_bf16(f.x * s, f.y * s);")],
    "exact expf and division": [
        ("__expf(sc[mt][nt][2 * hh + x] - m)", "expf(sc[mt][nt][2 * hh + x] - m)"),
        ("w = sc[mt][nt][2 * hh + x] * rcp;", "w = sc[mt][nt][2 * hh + x] / sum;")],
    "every row half's softmax computed": [
        ("if (16 * mt + 8 * hh >= tq) {", "if (16 * mt + 8 * hh >= 32) {")],
    "five blocks a SM at Tq, Tk <= 16": [
        ("__launch_bounds__(kMmaThreads, MQ == 1 && KS == 1 ? 4 : 3)",
         "__launch_bounds__(kMmaThreads, MQ == 1 && KS == 1 ? 5 : 3)")],
    "staging and stores alone": [
        ("    for (int h = warp; h < a.heads; h += kMmaWarps) {",
         "    for (int h = warp; h < 0; h += kMmaWarps) {")],
    "without the output store": [
        ("dst[c] = src[c];", "if (src[c].x == 0x12345u) dst[c] = src[c];")],
}

# the same for #4's bf16 kernel, attention_core_bwd_mma_kernel
BWD_VARIANTS = {
    "dropout quotient by division": [
        ("a.drop.apply_rcp(w, kept, keep_rcp)", "a.drop.apply(w, kept)"),
        ("a.drop.apply_rcp(dwd, kept, keep_rcp)", "a.drop.apply(dwd, kept)")],
    "one chunk at a time": [
        ("#pragma unroll 2\n  for (int n0 = 0; n0 < hd; n0 += 8) {",
         "  for (int n0 = 0; n0 < hd; n0 += 8) {")],
    "one barrier for the four copies": [
        ("    mbar_init(bar + 1, 1);\n", ""),
        ("    mbar_expect_tx(bar, 2u * (qn + kn), true);",
         "    mbar_expect_tx(bar, 2u * (2 * qn + 2 * kn), true);"),
        ("    mbar_expect_tx(bar + 1, 2u * (qn + kn), true);\n", ""),
        ("bulk_load(vs, a.v + e * kn, 2u * kn, bar + 1);", "bulk_load(vs, a.v + e * kn, 2u * kn, bar);"),
        ("bulk_load(gs, a.g + e * qn, 2u * qn, bar + 1);", "bulk_load(gs, a.g + e * qn, 2u * qn, bar);"),
        ("    mbar_wait(bar + 1, 0);                         // v and g: in flight under S\n", ""),
        ("  mbar_wait(bar + 1, 0);                           // a warp with no head waits here\n",
         "")],
    "staging and stores alone": [
        ("  for (int h = warp; h < a.heads; h += kMmaWarps) {\n    const bf16* const qh = qs + h",
         "  for (int h = warp; h < 0; h += kMmaWarps) {\n    const bf16* const qh = qs + h")],
    "without the stores": [
        ("d4[c] = s4[c];", "if (s4[c].x == 0x12345u) d4[c] = s4[c];"),
        ("      dst[hh * a.qs.head", "      if (c < 0) dst[hh * a.qs.head")],
    "without the lo terms": [
        ("        mma_16816(ol[mt], al[mt][kk], b[kk][0], b[kk][1]);\n", "")],
    "movmatrix left out": [
        ('asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));',
         "y = x;")],
    "without the three column products": [
        ("  for (int n0 = 0; n0 < hd; n0 += 8) {\n    uint32_t b[KT][2];",
         "  for (int n0 = 0; n0 < 0; n0 += 8) {\n    uint32_t b[KT][2];")],
}

# the same for the long route's bf16 kernels, attention_core_long_kernel
# and attention_core_long_bwd_kernel
LONG_VARIANTS = {
    "forward: staging alone": [
        ("  if (r0 >= tq) return;                          // warp-uniform; no barrier follows",
         "  return;")],
    "forward: four warps a block (64 query rows)": [
        ("constexpr int kLongWarps = 5;", "constexpr int kLongWarps = 4;")],
    "backward: staging alone": [
        ("  scale_rows<PAIRS>(qs, st, tq, hd, scale);\n  __syncthreads();",
         "  scale_rows<PAIRS>(qs, st, tq, hd, scale);\n  __syncthreads();\n  if (tq > 0) return;")],
    "backward: without the query pass": [
        ("  for (int r0 = 16 * warp; r0 < tq; r0 += 16 * kLongBwdWarps) {",
         "  for (int r0 = 16 * warp; r0 < 0; r0 += 16 * kLongBwdWarps) {")],
    "backward: without the key pass": [
        ("  for (int c0 = 16 * warp; c0 < tk; c0 += 16 * kLongBwdWarps) {",
         "  for (int c0 = 16 * warp; c0 < 0; c0 += 16 * kLongBwdWarps) {")],
    "backward: eight warps a block": [
        ("constexpr int kLongBwdWarps = 10;", "constexpr int kLongBwdWarps = 8;")],
    "backward: two blocks a SM (128 registers)": [
        ("__global__ void __launch_bounds__(kLongBwdWarps * 32, 1)\n"
         "attention_core_long_bwd_kernel",
         "__global__ void __launch_bounds__(kLongBwdWarps * 32, 2)\n"
         "attention_core_long_bwd_kernel")],
}

BUILD = ("import sys; sys.path.insert(0, '.'); from vptr_tpu_torch.ops import _build; "
         "_build.build(['attention_core'])")


def time_core(root: str, repeats: int, bwd: bool, long: bool = False) -> dict:
    import torch

    sys.path.insert(0, root)
    from vptr_tpu_torch.ops import attention_core as tac

    if Path(tac.__file__).resolve().parents[2] != Path(root).resolve():
        raise RuntimeError(f"imported {tac.__file__}, not from {root}")
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    heads, hd = 8, 66
    seed = torch.tensor([7], dtype=torch.int32, device=dev)

    def ops(b, t, strided):
        if strided:
            return [torch.randn(b, t, heads * hd, generator=g).to(dev, bf)
                    .view(b, t, heads, hd).transpose(1, 2) for _ in range(3)]
        return [torch.randn(b, heads, t, hd, generator=g).to(dev, bf) for _ in range(3)]

    def causal(t):
        return torch.full((t, t), -1e30, device=dev).triu(1)[None]

    def mean_ms(fn):
        for _ in range(5):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(50):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 50

    def graph_ms(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return mean_ms(graph.replay)

    if long:
        return time_long(tac, ops, seed, mean_ms, graph_ms, repeats)
    if bwd:
        return time_bwd(tac, ops, causal, seed, mean_ms, graph_ms, repeats)
    cases = {
        "far_rip contiguous": (ops(640, 20, False), causal(20), 0.0),
        "far_rip strided": (ops(640, 20, True), causal(20), 0.0),
        "FAR step strided": (ops(640, 19, True), causal(19), 0.1),
        "NAR strided": (ops(1024, 10, True), None, 0.0),
    }
    # the same shape again, allocated after the others (where the operands
    # lie can move a reading: the 50 MB L2 keeps part of the 40 MB read)
    cases["far_rip contiguous, allocated last"] = (ops(640, 20, False), causal(20), 0.0)
    out = {}
    for _ in range(repeats):
        for name, (qkv, bias, rate) in cases.items():
            call = lambda: tac.attention_core(*qkv, bias, seed, rate)
            out.setdefault(name, []).append(mean_ms(call))
            out.setdefault(f"{name} (graph)", []).append(graph_ms(call))
    best = {name: min(ms) for name, ms in out.items()}
    for name, (qkv, bias, rate) in cases.items():
        got = tac.attention_core(*qkv, bias, seed, rate).float()
        want = tac.attention_core_plain(*qkv, bias, seed, rate).float()
        best[f"{name} max|err|"] = (got - want).abs().max().item()
    return best


def time_bwd(tac, ops, causal, seed, mean_ms, graph_ms, repeats) -> dict:
    """The backward's cases (see the module note), as time_core's."""
    cases = {
        "FAR step strided": (ops(640, 19, True) + ops(640, 19, True)[:1], causal(19)),
        "FAR step contiguous": (ops(640, 19, False) + ops(640, 19, False)[:1], causal(19)),
        "NAR step strided": (ops(1024, 10, True) + ops(1024, 10, True)[:1], None),
    }
    out = {}
    for _ in range(repeats):
        for name, (qkvg, bias) in cases.items():
            call = lambda: tac.attention_core_backward(*qkvg[:3], bias, seed, qkvg[3], 0.1,
                                                       need_dbias=False)
            out.setdefault(name, []).append(mean_ms(call))
            out.setdefault(f"{name} (graph)", []).append(graph_ms(call))
    best = {name: min(ms) for name, ms in out.items()}
    for name, (qkvg, bias) in cases.items():
        got = tac.attention_core_backward(*qkvg[:3], bias, seed, qkvg[3], 0.1, need_dbias=False)
        want = tac.attention_core_backward_plain(*qkvg[:3], bias, seed, qkvg[3], 0.1, False)
        best[f"{name} max|err|"] = max(
            ((a.float() - b.float()).abs().max() / max(1.0, b.float().abs().max().item())).item()
            for a, b in zip(got[:3], want[:3]))
    return best


def time_long(tac, ops, seed, mean_ms, graph_ms, repeats) -> dict:
    """The long route's cases (see the module note), as time_core's."""
    def qkvg(tk):
        q, g = ops(64, 160, True)[:2]
        k, v = ops(64, tk, True)[:2]
        return q, k, v, g

    operands = {"160x160": qkvg(160), "160x32": qkvg(32)}
    calls = {}
    for name, (q, k, v, g) in operands.items():
        calls[f"{name} fwd"] = lambda q=q, k=k, v=v: tac.attention_core(q, k, v)
        calls[f"{name} bwd"] = lambda q=q, k=k, v=v, g=g: tac.attention_core_backward(
            q, k, v, None, seed, g, 0.1, need_dbias=False)
    out = {}
    for _ in range(repeats):
        for name, call in calls.items():
            out.setdefault(name, []).append(mean_ms(call))
            out.setdefault(f"{name} (graph)", []).append(graph_ms(call))
    best = {name: min(ms) for name, ms in out.items()}
    for name, (q, k, v, g) in operands.items():
        got = tac.attention_core(q, k, v).float()
        best[f"{name} fwd max|err|"] = (
            got - tac.attention_core_plain(q, k, v).float()).abs().max().item()
        got = tac.attention_core_backward(q, k, v, None, seed, g, 0.1, need_dbias=False)
        want = tac.attention_core_backward_plain(q, k, v, None, seed, g, 0.1, False)
        best[f"{name} bwd max|err|"] = max(
            ((a.float() - b.float()).abs().max() / max(1.0, b.float().abs().max().item())).item()
            for a, b in zip(got[:3], want[:3]))
    return best


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--bwd", action="store_true",
                        help="kernel #4 (the backward) and BWD_VARIANTS")
    parser.add_argument("--long", action="store_true",
                        help="#2's and #4's long route and LONG_VARIANTS")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--only", nargs="*", help="variants to time (default: all)")
    parser.add_argument("--time", help=argparse.SUPPRESS)   # one root, in a child
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_port_core_probe: no GPU", file=sys.stderr)
        return 1
    if args.time:
        print(json.dumps(time_core(args.time, args.repeats, args.bwd, args.long)))
        return 0
    roots = {}
    variants = LONG_VARIANTS if args.long else BWD_VARIANTS if args.bwd else VARIANTS
    for name, edits in variants.items():
        if args.only and name not in args.only:
            continue
        root = REPO / "build" / "core_probe" / "".join(ch if ch.isalnum() else "_" for ch in name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "vptr_tpu_torch", root / "vptr_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = root / "vptr_tpu_torch" / CORE
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the text to replace is not in {CORE}")
            text = text.replace(old, new)
        src.write_text(text)
        roots[name] = str(root)
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=root)
              for root in [str(REPO), *roots.values()]]
    for b in builds:
        b.wait(timeout=900)
    order = [("committed", str(REPO)), *roots.items(), ("committed again", str(REPO))]
    result = {}
    for name, root in order:
        run = subprocess.run([sys.executable, __file__, "--time", root, "--repeats",
                              str(args.repeats)] + (["--bwd"] if args.bwd else [])
                             + (["--long"] if args.long else []),
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:         # a variant that does not build or run
            print(run.stdout + run.stderr, file=sys.stderr)
            if name.startswith("committed"):
                return 1
            continue
        result[name] = json.loads(run.stdout.strip().splitlines()[-1])
    base = {case: (result["committed"][case] + result["committed again"][case]) / 2
            for case in result["committed"]}
    delta = {name: {case: round(ms - base[case], 4) for case, ms in r.items()
                    if "err" not in case}
             for name, r in result.items() if not name.startswith("committed")}
    print(json.dumps({"ms": result, "minus_committed_ms": delta,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
