"""Where kernel #7's (fused_ffn forward) or #8's (its backward) time goes,
on the bf16 wgmma routes, on one GPU.

    python3 scripts/torch_port_ffn_probe.py [--bwd] [--repeats 3] [--only NAME ...]

Times fused_ffn at the far_rip path's shape (12,800 rows x 528 channels,
hidden 2112, bf16; dropout 0, as the predict calls it, and 0.1, as the
train step does) as committed, and copies of the package under
build/ffn_probe/ whose csrc/fused_ffn.cu is changed in one place
(VARIANTS): one part of the work left out (the fc1 product, the fc2
product, the GELU and dropout of the hidden's epilogue, the LayerNorm
prologue: wrong values by design), whose difference from the committed
kernel is that part's time, or another design choice (one row tile a
block, in waves, instead of the work split evenly over the SMs; the
first warpgroup refilling every stage; the next tile's x loaded during
the last chunk; 16-deep ring steps, 7 stages; the exact-division GELU:
right values). With --bwd it times the backward at the train step's shape
(12,160 rows) against copies whose csrc/fused_ffn_bwd.cu leaves out one
part (BWD_VARIANTS: pass 2's two products, pass 2's epilogue, the dW1 and
dW2 products, the dxn product, the LayerNorm and column-sum passes, the
split sums; the LayerNorm pass and pass 2 alone, with and without pass
2's epilogue or products: wrong values by design) or makes another
choice (the dropout as an IEEE division instead of the reciprocal with a
remainder correction, plain stores of the halves instead of streaming
ones, the dW products' K in other numbers of chunks). The committed
kernel is not changed. The copies' libraries are all built first, in
parallel; each copy is then timed in its own process
(mean CUDA-event time of 30 calls after 3 warm-ups, --repeats times).
Prints one JSON line with every reading, the card's name and each
variant's best time less the committed kernel's. Exits non-zero without
a GPU.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = "csrc/fused_ffn.cu"
# variant -> [(text of csrc/fused_ffn.cu, replacement), ...]
VARIANTS = {
    "without fc1": [("      fc1_step(a1, xn, a + wg * kBox1, k, C);\n", "")],
    "without fc2": [("      fc2_step<NY>(y, hid, a + 3 * wg * kBox2, k);\n", "")],
    "without GELU and dropout": [
        ("float v0 = vptr_gelu::gelu_fast(a1[4 * j + 2 * h] + bb.x);",
         "float v0 = a1[4 * j + 2 * h] + bb.x;"),
        ("float v1 = vptr_gelu::gelu_fast(a1[4 * j + 2 * h + 1] + bb.y);",
         "float v1 = a1[4 * j + 2 * h + 1] + bb.y;"),
        ("          if (drop.active()) {", "          if (false) {")],
    "without LN": [("  ln_in_place(xn, ls, lb, C, eps, warp, lane);\n", "")],
    "one tile a block": [("  return {tiles, (H + kHc - 1) / kHc, tiles < sms ? tiles : sms};",
                          "  return {tiles, (H + kHc - 1) / kHc, tiles};")],
    "refills by the first warpgroup": [
        ("    refiller = refiller + 1 == kFfnWgs ? 0 : refiller + 1;\n", "")],
    "x of the next tile early": [
        ("      bar_sync(1, kFfnThreads);        // every warpgroup's fc2 of the last chunk is done\n",
         "      bar_sync(1, kFfnThreads);\n"
         "      {\n"
         "        const bool on = threadIdx.x == 0 && ch == c1 - 1 && u < unit1;\n"
         "        mbar_expect_tx(&bars.x, (C + 63) / 64 * kXBox, on);\n"
         "        for (int i = 0; i < (C + 63) / 64; ++i)\n"
         "          tma_load_2d(xn + i * kXBox, &xmap, &bars.x, 64 * i, u / nch * kFfnRows, on);\n"
         "      }\n"),
        ("    if (threadIdx.x == 0) {\n      const int nbx", "    if (threadIdx.x == 0 && seg == 0) {\n      const int nbx")],
    "16-deep steps": [("constexpr int kDepth = 32;", "constexpr int kDepth = 16;")],
    "exact GELU": [
        ("float v0 = vptr_gelu::gelu_fast(", "float v0 = vptr_gelu::gelu("),
        ("float v1 = vptr_gelu::gelu_fast(", "float v1 = vptr_gelu::gelu(")],
}
BWD_SOURCE = "csrc/fused_ffn_bwd.cu"
_EPILOGUE = ("    // + b1, the GELU and its gradient, the hash mask (drawn once for both):\n",
             "    work.advance(rt, ct);\n")
_PRODUCTS = ("          wgmma_64<0, 1>(a, wg_desc(s + rh * (kP1Box / 2) + 32 * qq),\n"
         "                         wg_desc_mn(s + (4 + chalf) * (kP1Box / 2) + 2048 * qq, kP1Box / 2));\n"
         "          wgmma_64<0, 0>(d, wg_desc(s + kP1Box + rh * (kP1Box / 2) + 32 * qq),\n"
         "                         wg_desc(s + (6 + chalf) * (kP1Box / 2) + 32 * qq));\n", "")
_ALONE = ("    if (int err = hidden_wg(a, s)) return err;\n",
          "    if (int err = hidden_wg(a, s)) return err;\n    return 0;\n")
# variant -> [(text of csrc/fused_ffn_bwd.cu, replacement) or (start, end,
# None): the text from start up to end left out]
BWD_VARIANTS = {
    "without pass 2's products": [_PRODUCTS],
    "without pass 2's epilogue": [(*_EPILOGUE, None)],
    "without dW1 and dW2": [
        ("  if (int err = launch_dw<2>(a.g, hl, hl + plane, f32p(a.wpart2), S, C, H, a.ksplit, s))\n"
         "    return err;\n", ""),
        ("  if (int err = launch_dw<2>(a.xn, hl + 2 * plane, hl + 3 * plane, f32p(a.wpart1), S, C, H,\n"
         "                             a.ksplit, s))\n    return err;\n", "")],
    "without dxn": [("  return wg_groups(C) == 1\n", "  if (depth) return 0;\n  return wg_groups(C) == 1\n")],
    "without the LN and column-sum passes": [
        ("  ln_rows_kernel<T><<<", "  if (!wg) ln_rows_kernel<T><<<"),
        ("  ln_bwd_kernel<T><<<", "  if (!wg) ln_bwd_kernel<T><<<"),
        ("  colsum_partial_kernel<T><<<dim3((H + 127) / 128, hb.parts, 1)",
         "  if (!wg) colsum_partial_kernel<T><<<dim3((H + 127) / 128, hb.parts, 1)"),
        ("  colsum_final_kernel<<<dim3((H + 127) / 128, 1)",
         "  if (!wg) colsum_final_kernel<<<dim3((H + 127) / 128, 1)"),
        ("  colsum_partial_kernel<T><<<dim3((C + 127) / 128, a.parts, 3)",
         "  if (!wg) colsum_partial_kernel<T><<<dim3((C + 127) / 128, a.parts, 3)"),
        ("  colsum_final_kernel<<<dim3((C + 127) / 128, 3)",
         "  if (!wg) colsum_final_kernel<<<dim3((C + 127) / 128, 3)")],
    "pass 2 alone": [_ALONE],
    "pass 2 alone without its epilogue": [_ALONE, (*_EPILOGUE, None)],
    "pass 2 alone without its products": [_ALONE, _PRODUCTS],
    "dropout as a division": [
        ("            gl = drop.apply_rcp(gl, kept, rcp);\n            dh = drop.apply_rcp(dh, kept, rcp);\n",
         "            gl = drop.apply(gl, kept);\n            dh = drop.apply(dh, kept);\n")],
    **{f"K in {n} chunks": [("  if (!wg_route(C, H, dtype)) return weight_splits(S);\n",
                             f"  if (wg_route(C, H, dtype)) return {n};\n"
                             "  return weight_splits(S);\n")]
       for n in (5, 7, 9, 11)},
    "K in chunks of 1024 rows": [("  if (!wg_route(C, H, dtype)) return weight_splits(S);\n",
                                  "  return weight_splits(S);\n")],
    "plain stores": [('#include "wg_dw.cuh"\n',
                      '#include "wg_dw.cuh"\n#define __stcs(p, v) (*(p) = (v))\n')],
    "without the split sums": [
        ("  split_sum_kernel<T><<<", "  if (!wg) split_sum_kernel<T><<<"),
        ("    split_sum_t_kernel<T><<<", "    if (!wg) split_sum_t_kernel<T><<<")],
}
BUILD = ("import sys; sys.path.insert(0, '.'); from vptr_tpu_torch.ops import _build; "
         "_build.build([{lib!r}])")


def time_fused_ffn(root: str, repeats: int, bwd: bool) -> dict:
    import torch

    sys.path.insert(0, root)
    from vptr_tpu_torch.ops import fused_ffn as tff

    if Path(tff.__file__).resolve().parents[2] != Path(root).resolve():
        raise RuntimeError(f"imported {tff.__file__}, not from {root}")
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    c, hid, rows = 528, 2112, 12160 if bwd else 12800
    ops = (r(rows, c).to(bf), r(c, hid, std=c ** -0.5).to(bf), r(hid, std=0.1),
           r(hid, c, std=hid ** -0.5).to(bf), r(c, std=0.1), 1 + r(c, std=0.1),
           r(c, std=0.1))
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    gout = r(rows, c).to(bf)
    out = {}
    for rate in (0.0, 0.1):
        def call():
            if bwd:
                tff.fused_ffn_backward(*ops, seed, gout, rate)
            else:
                tff.fused_ffn(*ops, seed, rate)

        ms = []
        for _ in range(repeats):
            for _ in range(3):
                call()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(30):
                call()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / 30)
        out[f"dropout {rate}"] = ms
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--bwd", action="store_true",
                        help="the backward (#8) and its variants instead of #7")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--only", nargs="*", help="variants to time (default: all)")
    parser.add_argument("--time", help=argparse.SUPPRESS)   # one root, in a child
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_port_ffn_probe: no GPU", file=sys.stderr)
        return 1
    if args.time:
        print(json.dumps(time_fused_ffn(args.time, args.repeats, args.bwd)))
        return 0
    source, variants = (BWD_SOURCE, BWD_VARIANTS) if args.bwd else (SOURCE, VARIANTS)
    roots = {"committed": str(REPO)}
    for name, edits in variants.items():
        if args.only and name not in args.only:
            continue
        root = REPO / "build" / "ffn_probe" / "".join(ch if ch.isalnum() else "_" for ch in name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "vptr_tpu_torch", root / "vptr_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = root / "vptr_tpu_torch" / source
        text = src.read_text()
        for old, new, *cut in edits:
            if text.count(old) != 1 or (cut and text.count(new) != 1):
                raise RuntimeError(f"{name}: the text to replace is not in {source} once")
            if cut:                     # leave out the text from old up to new
                i = text.index(old)
                text = text[:i] + text[text.index(new, i):]
            else:
                text = text.replace(old, new)
        src.write_text(text)
        roots[name] = str(root)
    lib = Path(source).stem
    builds = [subprocess.Popen([sys.executable, "-c", BUILD.format(lib=lib)], cwd=root)
              for root in roots.values()]
    for b in builds:
        b.wait(timeout=900)
    result = {}
    for name, root in roots.items():
        run = subprocess.run([sys.executable, __file__, "--time", root, "--repeats",
                              str(args.repeats)] + (["--bwd"] if args.bwd else []),
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:         # a variant that does not build or run
            print(run.stdout + run.stderr, file=sys.stderr)
            if name == "committed":
                return 1
            continue
        result[name] = json.loads(run.stdout.strip().splitlines()[-1])
    base = {k: min(ms) for k, ms in result["committed"].items()}
    delta = {name: {k: round(min(ms) - base[k], 4) for k, ms in r.items()}
             for name, r in result.items() if name != "committed"}
    print(json.dumps({"ms": result, "minus_committed_ms": delta,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
