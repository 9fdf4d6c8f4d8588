"""Where kernel #9's (fused_dw_chain forward) time goes, on one GPU.

    python3 scripts/torch_port_dw_probe.py [--root DIR] [--samples 200]
    python3 scripts/torch_port_dw_probe.py --variants [NAME ...]
    python3 scripts/torch_port_dw_probe.py --bwd [--root DIR] [--samples 190]
    python3 scripts/torch_port_dw_probe.py --bwd --variants [NAME ...]

Times #9 at N x 64 x 2112 bf16, dropout 0 (the far_rip predict's shape at
N = 200), on each route the checkout has (the per-sample kernel, a cluster
of 8 blocks a sample; and, where the checkout has it, the persistent
route of 16-block clusters), in turns (A B B A, the mean CUDA-event time
of 50 calls after 5 warm-ups), and prints each route's resident clusters.

Then builds a copy of the checkout's ``csrc/`` under build/dw_probe/ with
SM-clock stamps from thread 0 of every block, and runs each route once:
* the per-sample kernel (``dw_chain_kernel`` with ``chain_to_z2`` of
  ``csrc/dw_chain.cuh``, changed in the copy only): the x load and its sum,
  each of the four cluster exchanges (a __syncthreads, a cluster.sync and
  eight DSMEM reads: the wait for the block's slowest warp is in it), the
  two M2 passes, z1, the conv, the final pass with its store and the
  closing cluster.sync; mean cycles a block;
* the persistent kernel (the copy built with ``-DVPTR_DW_STAMPS``, the
  stamps the kernel carries): the prologue (the slices of the affines and
  taps, the barriers), then each step of a sample added up over the
  block's samples: the wait for the staged x, LN1's statistics, the wait
  for the previous sample's second exchange, that sample's final pass with
  its store, the wait for the first exchange, z1, the conv, LN2's
  statistics; mean cycles a block-sample;
and for both, from the global timer, the blocks' start offsets from the
first block's start, their lifetimes, and the share of the SMs' time
between the first start and the last end that no block held. ``--root``
reads another checkout (e.g. the parent, unpacked with git archive), whose
per-sample kernel is stamped the same way. Each stamp costs a few cycles.

``--variants`` instead times the persistent route as committed against
copies of the package's ``csrc/`` under build/dw_probe/ whose
``fused_dw_chain.cu`` is changed in one place (VARIANTS: one part of the
work left out, wrong values by design, whose difference from the committed
kernel is that part's time; or another design choice), all built first in
parallel, each read in turns with the committed kernel (committed,
variant, variant, committed) in one process.

``--bwd`` reads kernel #10 (fused_dw_chain backward) instead, at N x 64 x
2112 bf16, dropout 0.1 (the FAR step's shape at N = 190): each route the
checkout has (the sample-group kernel, a cluster of 8 blocks a group of
samples; and, where the checkout has it, the persistent route of 16-block
clusters) in turns, A B B A; each route's resident clusters; ptxas's
registers and spills of each dw-chain backward kernel; the group kernel
launched with as many groups as clusters are resident (``kGroups``
changed in a copy), in turns with the committed one; ``dw_chain_sum_kernel``
alone; and clock64 stamps of the group kernel (the phases of
``chain_to_z2`` and passes 1-6 of ``csrc/fused_dw_chain_bwd.cu``, changed in
a copy only: mean cycles a block-sample) and of the persistent kernel (the
stamps it carries under ``-DVPTR_DW_STAMPS``), with the blocks' start
offsets and lifetimes. ``--bwd --variants [NAME ...]`` times the persistent
backward as committed against copies with one part left out or another
choice (BWD_VARIANTS), as ``--variants`` does for #9.

Prints one JSON line. Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HW, C, SLOTS = 64, 2112, 16
PER_SAMPLE_PHASES = ("x load + sum", "exchange 1", "M2 pass", "exchange 2", "z1",
                     "conv + sum", "exchange 3", "M2 pass (z2)", "exchange 4",
                     "final pass + store", "closing cluster.sync")
PERSISTENT_PHASES = ("prologue", "wait for the staged x", "LN1 statistics",
                     "exchange 2 of the previous sample", "its final pass", "exchange 1",
                     "z1", "conv", "LN2 statistics", "closing cluster.sync")
PER_BLOCK = (0, 9)                # persistent stamps taken once a block, not a sample
_COLUMNS = ("      if (H == 8)\n"
            "        p_conv_column<8>(z1, z2, tp, j, (c - j * np) * 2, cw, W, H);\n"
            "      else\n"
            "        p_conv_column<0>(z1, z2, tp, j, (c - j * np) * 2, cw, W, H);\n")
_Z1 = "          z.v[e] = p_gelu(fmaf(x.v[e], rstd, shift) * sc.v[e] + bi.v[e]);"
_Y = "          y.v[e] = p_gelu(fmaf(z.v[e], rstd, shift) * sc.v[e] + bi.v[e]);"
_FINAL = "  auto final_pass = [&](int n, float mean, float rstd) {\n"
# variant -> [(text of csrc/fused_dw_chain.cu, replacement), ...]
VARIANTS = {
    "without the conv's whole columns": [(_COLUMNS, "")],
    "the conv without its 8-row form": [
        (_COLUMNS, "      p_conv_column<0>(z1, z2, tp, j, (c - j * np) * 2, cw, W, H);\n")],
    "without the final pass": [(_FINAL, _FINAL + "    if (N > 0) return;\n")],
    "without z1's GELU": [(_Z1, _Z1.replace("p_gelu", ""))],
    "without the final GELU": [(_Y, _Y.replace("p_gelu", ""))],
    "gelu_fast": [(_Z1, _Z1.replace("p_gelu", "vptr_gelu::gelu_fast")),
                  (_Y, _Y.replace("p_gelu", "vptr_gelu::gelu_fast"))],
    "exact GELU": [(_Z1, _Z1.replace("p_gelu", "vptr_gelu::gelu")),
                   (_Y, _Y.replace("p_gelu", "vptr_gelu::gelu"))],
    **{f"{w} warps": [("constexpr int kPWarps = 16;", f"constexpr int kPWarps = {w};"),
                      ("constexpr int kPMaxQ = 5;", f"constexpr int kPMaxQ = {q};")]
       for w, q in ((12, 6), (24, 3))},
}
STAMP = ("\n#define PSTAMP(k) if (threadIdx.x == 0) g_dw_pstamp[blockIdx.x * 16 + (k)] = "
         "clock64();\n#define PTIMER(k) if (threadIdx.x == 0) { long long t_; asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); g_dw_pstamp[blockIdx.x * 16 + (k)] "
         "= t_; }\n")


def instrument(csrc: Path) -> None:
    """Stamps into the copy's per-sample kernel (text edits; each mark must
    be found) and the probe's read-back entry point."""
    head = csrc / "dw_chain.cuh"
    src = head.read_text()
    src = src.replace("namespace {", "__device__ long long g_dw_pstamp[4096 * 16];" + STAMP
                      + "namespace {", 1)
    for slot, (before, after) in enumerate(((1, 2), (3, 4), (6, 7), (8, 9))):
        mark = f"  cluster_sum(v, red, {slot}, cluster);\n"
        if mark not in src:
            raise RuntimeError(f"mark {mark!r} not found in dw_chain.cuh")
        src = src.replace(mark, f"  PSTAMP({before})\n{mark}  PSTAMP({after})\n", 1)
    mark = "  __syncthreads();\n  v[0] = 0.f;\n"
    if mark not in src:
        raise RuntimeError("the z1 pass's end not found in dw_chain.cuh")
    head.write_text(src.replace(mark, "  __syncthreads();\n  PSTAMP(5)\n  v[0] = 0.f;\n", 1))
    body = csrc / "fused_dw_chain.cu"
    src = body.read_text()
    for mark, new in (
            ("  __shared__ Red red;\n", "  __shared__ Red red;\n  PSTAMP(0)\n  PTIMER(12)\n"),
            ("  cluster.sync();                      // the other blocks are done reading red\n",
             "  PSTAMP(10)\n  cluster.sync();\n  PSTAMP(11)\n  PTIMER(13)\n")):
        if mark not in src:
            raise RuntimeError(f"mark {mark!r} not found in fused_dw_chain.cu")
        src = src.replace(mark, new, 1)
    src += ('\nextern "C" int probe_read(long long* host, int n, int persistent) {\n'
            "#ifdef VPTR_DW_STAMPS\n"
            "  if (persistent) return cudaMemcpyFromSymbol(host, g_dw_stamp, n * 8);\n"
            "#endif\n"
            "  return cudaMemcpyFromSymbol(host, g_dw_pstamp, n * 8);\n}\n")
    body.write_text(src)


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


def timeline(starts, ends, sms):
    """Start offsets and lifetimes (us) and the idle share of the SMs."""
    span = ends.max() - starts.min()
    life = ends - starts
    return {"start_offset_us_mean": float((starts - starts.min()).mean() / 1e3),
            "start_offset_us_max": float((starts - starts.min()).max() / 1e3),
            "block_life_us_mean": float(life.mean() / 1e3),
            "span_us": float(span / 1e3),
            "sm_idle_share": float(1 - life.sum() / (sms * span))}


def variants(args, tdw, _build, ops) -> int:
    """The persistent route as committed against each variant, in turns."""
    names = args.variants or list(VARIANTS)
    root = _build.BUILD_DIR.parent / "dw_probe"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, name in enumerate(names):
        csrc = root / f"v{i}" / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        body = csrc / "fused_dw_chain.cu"
        src = body.read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not found in fused_dw_chain.cu")
            src = src.replace(old, new)
        body.write_text(src)
        lib = root / f"v{i}" / "lib.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(body)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    committed = tdw._lib()
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.vptr_error_string.argtypes = [ctypes.c_int]
        lib.vptr_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    fn = lambda: tdw._forward_kernel(*ops, None, 8, 0.0, route="persistent")  # noqa: E731
    out = {"card": torch.cuda.get_device_name(0), "samples": args.samples, "variants": {}}
    for name, lib in libs.items():
        reads = []
        for which in (committed, lib, lib, committed):
            _build._LIBS["fused_dw_chain"] = which
            tdw._lib()                # its argument types
            reads.append(cuda_ms(fn))
        _build._LIBS["fused_dw_chain"] = committed
        out["variants"][name] = {"committed_ms": [reads[0], reads[3]],
                                 "variant_ms": [reads[1], reads[2]],
                                 "less_committed_ms": min(reads[1:3]) - min(reads[0], reads[3])}
        print(f"{name:28s} {reads[1]:.4f} / {reads[2]:.4f} ms vs committed {reads[0]:.4f} / "
              f"{reads[3]:.4f}: {out['variants'][name]['less_committed_ms']:+.4f}")
    print(json.dumps(out))
    return 0


# ---- kernel #10 (--bwd)

GROUP_PHASES = ("x load + sum", "exchange 1", "M2 pass (x)", "exchange 2", "z1",
                "conv + sum", "exchange 3", "M2 pass (z2)", "exchange 4",
                "pass 1 (ds2, db2, norm2 sums)", "exchange 5", "pass 2 (dz2)",
                "pass 3 (dtaps, ddwb)", "pass 4 (dz1)", "pass 5 (ds1, db1, norm1 sums)",
                "exchange 6", "pass 6 (dx)", "tap sums out + closing cluster.sync")
GROUP_PER_BLOCK = (17,)
BSLOTS = 24                       # a block's stamp slots: phases, then its start and end
BSTAMP = ("\n__device__ long long g_dw_bstamp[8192 * 24];\n__shared__ long long s_bst[24];\n"
          "#define BST(k) if (threadIdx.x == 0) { const long long t_ = clock64(); "
          "s_bst[k] += t_ - s_bst[23]; s_bst[23] = t_; }\n"
          "#define BTIMER(k) if (threadIdx.x == 0) { long long t_; asm volatile("
          "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); g_dw_bstamp[blockIdx.x * 24 + (k)] "
          "= t_; }\n")
BWD_PERSISTENT_PHASES = ("prologue", "wait for the staged x", "LN1 statistics", "exchange 1",
                         "z1", "conv", "LN2 statistics + exchange 2 + g staged", "da2 pass",
                         "exchange 3 + dz2", "conv transpose + tap sums + x staged again",
                         "da1 pass (+ the next x requested)", "exchange 4", "dx",
                         "sums out + closing cluster.sync")
BWD_PER_BLOCK = (0, 13)           # persistent stamps taken once a block, not a sample
_B = "fused_dw_chain_bwd.cu"
_Z1_AFF = "        const F4 x = ld4(stage + ox(k)), sc = ld4(s1 + og(k)), bi = ld4(b1 + og(k));\n"
_DA2_AFF = "sc = ld4(s2 + og(k)), bi = ld4(b2 + og(k)),\n"
_DA1_AFF = "sc = ld4(s1 + og(k)),\n                   bi = ld4(b1 + og(k));\n"
_TAPS = ("          b_tap_column<8>(z1, z2, j, cl, cw, W, H, acc);\n",
         "          b_tap_column<0>(z1, z2, j, cl, cw, W, H, acc);\n")
_CONV_T = ("          b_conv_t_column<8>(z2, z1, tp, j, cl, cw, W, H);\n",
           "          b_conv_t_column<0>(z2, z1, tp, j, cl, cw, W, H);\n")
_WALKS = """        if (H == 8)
          b_tap_column<8>(z1, z2, j, cl, cw, W, H, acc);
        else
          b_tap_column<0>(z1, z2, j, cl, cw, W, H, acc);
        int base = 0, held = 20;       // the pair's sums over its W columns, scattered
        b_halve<0>(acc, W, j, mask, base, held);
#pragma unroll
        for (int i = 0; i < 20; ++i)
          if (i < held) tacc[((base + i) >> 1) * cw + cl + ((base + i) & 1)] += acc[i];
        __syncwarp(mask);              // the pair's W lanes are done reading its z1
        if (H == 8)
          b_conv_t_column<8>(z2, z1, tp, j, cl, cw, W, H);
        else
          b_conv_t_column<0>(z2, z1, tp, j, cl, cw, W, H);
"""
_SUMS = _WALKS[_WALKS.index("        int base"):_WALKS.index("        __syncwarp")]
_BUTTERFLY = """        for (int o = 1; o < W; o <<= 1)
#pragma unroll
          for (int v = 0; v < 20; ++v) acc[v] += __shfl_xor_sync(mask, acc[v], o);
#pragma unroll
        for (int v = 0; v < 20; ++v)
          if ((v & (W - 1)) == j) tacc[(v >> 1) * cw + cl + (v & 1)] += acc[v];
"""
# one walk down a column for both: dz1 written over z1 a row behind, the
# column's lanes meeting once a row
_ONE_WALK_FN = """template <int kH>
__device__ __forceinline__ void b_one_walk(float* z1, const float* dz2, const float* tp, int j,
                                           int cl, int cw, int W, int H, unsigned mask,
                                           float (&acc)[20]) {
  if (kH) H = kH;
  F2 t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = ld2(tp + k * cw + cl);
  const Column z = {z1, j * cw + cl, W * cw, cw, H, j > 0, j + 1 < W};
  const Column d = {dz2, j * cw + cl, W * cw, cw, H, j > 0, j + 1 < W};
  const F2 zero = {{0.f, 0.f}};
  F2 zu[3] = {zero, zero, zero}, zm[3], zd[3], du[3] = {zero, zero, zero}, dm[3], dd[3];
  z.load(zm, 0);
  d.load(dm, 0);
  auto row = [&](int i) {
    z.load(zd, i + 1);
    d.load(dd, i + 1);
    __syncwarp(mask);
    F2 o;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float c = dm[1].v[e];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        acc[2 * b + e] = fmaf(zu[b].v[e], c, acc[2 * b + e]);
        acc[2 * (3 + b) + e] = fmaf(zm[b].v[e], c, acc[2 * (3 + b) + e]);
        acc[2 * (6 + b) + e] = fmaf(zd[b].v[e], c, acc[2 * (6 + b) + e]);
      }
      acc[18 + e] += c;
      float v = dd[2].v[e] * t[0].v[e];
      v = fmaf(dd[1].v[e], t[1].v[e], v);
      v = fmaf(dd[0].v[e], t[2].v[e], v);
      v = fmaf(dm[2].v[e], t[3].v[e], v);
      v = fmaf(dm[1].v[e], t[4].v[e], v);
      v = fmaf(dm[0].v[e], t[5].v[e], v);
      v = fmaf(du[2].v[e], t[6].v[e], v);
      v = fmaf(du[1].v[e], t[7].v[e], v);
      v = fmaf(du[0].v[e], t[8].v[e], v);
      o.v[e] = v;
    }
    st2(z1 + i * z.rs + z.col, o);
    roll(zu, zm, zd);
    roll(du, dm, dd);
  };
  if constexpr (kH > 0) {
#pragma unroll
    for (int i = 0; i < kH; ++i) row(i);
  } else {
    for (int i = 0; i < H; ++i) row(i);
  }
}

"""
_HALVE_DOC = "// acc summed over the gw lanes l = 0 .. gw - 1 of a group"
_ONE_WALK = """        if (H == 8)
          b_one_walk<8>(z1, z2, tp, j, cl, cw, W, H, mask, acc);
        else
          b_one_walk<0>(z1, z2, tp, j, cl, cw, W, H, mask, acc);
""" + _SUMS
# variant -> {file of csrc/: [(text, replacement), ...]}: the persistent
# backward with one part left out (wrong values by design) or another choice
BWD_VARIANTS = {
    "z1's affines from shared memory": {_B: [(_Z1_AFF, _Z1_AFF.replace(
        "s1 + og(k)", "sums + os(k)").replace("b1 + og(k)", "sums + E + os(k)"))]},
    "da2's affines from shared memory": {_B: [(_DA2_AFF, _DA2_AFF.replace(
        "s2 + og(k)", "sums + os(k)").replace("b2 + og(k)", "sums + E + os(k)"))]},
    "da1's affines from shared memory": {_B: [(_DA1_AFF, _DA1_AFF.replace(
        "s1 + og(k)", "sums + 2 * E + os(k)").replace("b1 + og(k)", "sums + 3 * E + os(k)"))]},
    "the exact GELU derivative": {_B: [("p_gelu_grad(", "vptr_gelu::gelu_grad(")]},
    "without the dropout": {_B: [("if (drop.active())\n              gk", "if (false)\n              gk")]},
    "without the tap walk": {_B: [(_TAPS[0], "          ;\n"), (_TAPS[1], "          ;\n")]},
    "without the transpose walk": {_B: [(_CONV_T[0], "          ;\n"),
                                        (_CONV_T[1], "          ;\n")]},
    "without the second round of columns": {_B: [(
        "    for (int u0 = 0; u0 < P; u0 += kPThreads) {",
        "    for (int u0 = 0; u0 < P / kPThreads * kPThreads; u0 += kPThreads) {")]},
    "without the affine-gradient sums": {_B: [
        ("          st4(sums + 2 * E + os(k), ps);\n          st4(sums + 3 * E + os(k), pb);\n", ""),
        ("          st4(sums + os(k), ps);\n          st4(sums + E + os(k), pb);\n", "")]},
    "column sums by butterfly": {_B: [(_SUMS, _BUTTERFLY)]},
    "one walk for the taps and the transpose": {_B: [(_HALVE_DOC, _ONE_WALK_FN + _HALVE_DOC),
                                                     (_WALKS, _ONE_WALK)]},
    "g read from device memory, not staged": {_B: [
        ("                               bf16* __restrict__ dx,\n",
         "                               const bf16* __restrict__ g, bf16* __restrict__ dx,\n"),
        ("      cf(s2), cf(b2), static_cast<bf16*>(dx),",
         "      cf(s2), cf(b2), static_cast<const bf16*>(g), static_cast<bf16*>(dx),"),
        ("    stage_load(&gmap, n);              // g, for the da2 pass\n", ""),
        ("    const float sh2 = -mean2 * rstd2;\n    stage_wait();\n",
         "    const float sh2 = -mean2 * rstd2;\n"),
        ("gv = ld4(stage + ox(k));", "gv = ld4(g + at + og(k));"),
        ("    stage_load(&xmap, n);              // x again, for the da1 pass\n", ""),
        ("    __syncthreads();                   // dz1 is complete\n    stage_wait();\n",
         "    __syncthreads();                   // dz1 is complete\n")]},
}


def _edit(path: Path, edits) -> None:
    """Apply (old, new) text edits to path; each old text must be found."""
    src = path.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{old!r} not found in {path.name}")
        src = src.replace(old, new, 1)
    path.write_text(src)


def instrument_bwd(csrc: Path) -> None:
    """Stamps into the copy's group kernel (dw_chain_bwd_kernel and the
    chain_to_z2 it calls), the read-back and a launch of the sum kernel."""
    head = csrc / "dw_chain.cuh"
    edits = [("namespace {", BSTAMP + "namespace {")]
    for slot, (before, after) in enumerate(((0, 1), (2, 3), (5, 6), (7, 8))):
        mark = f"  cluster_sum(v, red, {slot}, cluster);\n"
        edits.append((mark, f"  BST({before})\n{mark}  BST({after})\n"))
    edits.append(("  __syncthreads();\n  v[0] = 0.f;\n",
                  "  __syncthreads();\n  BST(4)\n  v[0] = 0.f;\n"))
    _edit(head, edits)
    body = csrc / "fused_dw_chain_bwd.cu"
    edits = [
        ("  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;\n"
         "  for (int i = threadIdx.x; i < 10 * cw; i += kBwdThreads) tacc[i] = 0.f;\n",
         "  const uint32_t seed = drop.active() ? drop.seed_u32() : 0u;\n"
         "  for (int i = threadIdx.x; i < 10 * cw; i += kBwdThreads) tacc[i] = 0.f;\n"
         "  BTIMER(20)\n  if (threadIdx.x == 0) { for (int k_ = 0; k_ < 23; ++k_) s_bst[k_] = 0;"
         " s_bst[23] = clock64(); }\n"),
        ("    cluster_sum(v, red, 4, cluster);\n",
         "    BST(9)\n    cluster_sum(v, red, 4, cluster);\n    BST(10)\n"),
        ("    __syncthreads();\n    // 3)", "    __syncthreads();\n    BST(11)\n    // 3)"),
        ("    __syncthreads();\n    // 4)", "    __syncthreads();\n    BST(12)\n    // 4)"),
        ("    __syncthreads();\n    // 5)", "    __syncthreads();\n    BST(13)\n    // 5)"),
        ("    cluster_sum(v, red, 5, cluster);\n",
         "    BST(14)\n    cluster_sum(v, red, 5, cluster);\n    BST(15)\n"),
        ("    __syncthreads();                   // the next sample overwrites the slices\n",
         "    __syncthreads();\n    BST(16)\n"),
        ("  cluster.sync();                      // the other blocks are done reading red\n}",
         "  cluster.sync();\n  BST(17)\n  BTIMER(21)\n  if (threadIdx.x == 0)\n"
         "    for (int k_ = 0; k_ < 18; ++k_) g_dw_bstamp[blockIdx.x * 24 + k_] = s_bst[k_];\n}"),
    ]
    _edit(body, edits)
    src = body.read_text()
    src += ('\nextern "C" int probe_read(long long* host, int n, int persistent) {\n'
            "#ifdef VPTR_DW_STAMPS\n"
            "  if (persistent) return cudaMemcpyFromSymbol(host, g_dw_stamp, n * 8);\n"
            "#endif\n"
            "  return cudaMemcpyFromSymbol(host, g_dw_bstamp, n * 8);\n}\n"
            'extern "C" int probe_sum(const void* part, const void* tpart, void* ds1, void* db1,'
            " void* ds2, void* db2, void* dtaps, void* ddwb, int ng, long hwc, int C) {\n"
            "  const long total = 4 * hwc + 10L * C;\n"
            "  dw_chain_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256>>>(\n"
            "      static_cast<const float*>(part), static_cast<const float*>(tpart),\n"
            "      static_cast<float*>(ds1), static_cast<float*>(db1), static_cast<float*>(ds2),\n"
            "      static_cast<float*>(db2), static_cast<float*>(dtaps), static_cast<float*>(ddwb),"
            "\n      ng, hwc, C);\n"
            "  return cudaGetLastError();\n}\n")
    body.write_text(src)


def ptxas_report(log: Path, needle: str) -> dict:
    """{entry function: registers and spills} of nvcc's -Xptxas -v log for
    the entries whose (mangled) name holds needle."""
    out, entry = {}, None
    if not log.is_file():
        return {"log": f"{log} not found (the library was not built in this run)"}
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            entry = entry if needle in entry else None
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.strip())
    return out


def _build_copy(_build, csrc: Path, out: Path, flags=()):
    return subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
                             str(csrc / "fused_dw_chain_bwd.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(path: Path, proc) -> ctypes.CDLL:
    """The library a copy's nvcc (proc) built, with its ptxas report of the
    persistent kernel as ``.spills``."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{path} did not build:\n{log}")
    lib = ctypes.CDLL(str(path))
    lib.vptr_error_string.argtypes = [ctypes.c_int]
    lib.vptr_error_string.restype = ctypes.c_char_p
    entry, lib.spills = None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = "persistent" in line
        elif entry and "spill" in line:
            lib.spills = line.strip()
    return lib


def bwd(args, root: Path) -> int:
    """Kernel #10's routes, resident clusters, registers, the group count
    check, the sum kernel and the stamps (see the module docstring)."""
    from vptr_tpu_torch.ops import _build
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    routed = hasattr(tdw, "backward_route")
    routes = ("groups", "persistent") if routed else ("groups",)
    dev, bf, n, rate = torch.device("cuda"), torch.bfloat16, args.samples or 190, 0.1
    g = torch.Generator().manual_seed(0)

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    ops = (r(n, HW, C).to(bf), r(9, C, std=0.3), r(C, std=0.1), 1 + r(HW, C, std=0.1),
           r(HW, C, std=0.1), 1 + r(HW, C, std=0.1), r(HW, C, std=0.1))
    gout = r(n, HW, C).to(bf)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)

    def call(route):
        if not routed:
            return lambda: tdw.fused_dw_chain_backward(*ops, seed, gout, 8, rate)
        return lambda: tdw._backward_kernel(*ops, seed, gout, 8, rate, route=route)

    committed = tdw._lib_bwd()
    out = {"root": str(root), "card": torch.cuda.get_device_name(0), "samples": n,
           "group_clusters": tdw.resident_clusters(HW, C)[1],
           "groups": committed.vptr_fused_dw_chain_bwd_groups(n),
           "ptxas": ptxas_report(_build.library_path("fused_dw_chain_bwd").with_suffix(".log"),
                                 "dw_chain")}
    if routed:
        out["persistent_clusters"] = tdw.backward_clusters(HW, C, 8)
    if args.variants is not None:
        return bwd_variants(args, tdw, _build, call("persistent"), out)
    times = {route: [] for route in routes}
    for route in routes + routes[::-1]:
        times[route].append(cuda_ms(call(route)))
    out["ms"] = times
    print(f"routes A B B A: {times}; resident clusters: groups {out['group_clusters']}"
          + (f", persistent {out['persistent_clusters']}" if routed else ""))
    for entry, lines in out["ptxas"].items():
        print(f"  ptxas {entry[:60]}: {lines}")

    probe = _build.BUILD_DIR.parent / "dw_bwd_probe"
    shutil.rmtree(probe, ignore_errors=True)
    shutil.copytree(_build.CSRC, probe / "csrc")
    shutil.copytree(_build.CSRC, probe / "kg" / "csrc")
    resident = out["group_clusters"]
    _edit(probe / "kg" / "csrc" / "fused_dw_chain_bwd.cu",
          [("constexpr int kGroups = 16;", f"constexpr int kGroups = {min(16, resident)};")])
    instrument_bwd(probe / "csrc")
    flags = ["-DVPTR_DW_STAMPS"] if routed else []
    procs = {"stamped": (probe / "libprobe.so",
                         _build_copy(_build, probe / "csrc", probe / "libprobe.so", flags)),
             "kg": (probe / "libkg.so",
                    _build_copy(_build, probe / "kg" / "csrc", probe / "libkg.so"))}
    libs = {k: _load(path, proc) for k, (path, proc) in procs.items()}

    # the group kernel with as many groups as clusters are resident
    reads = []
    for which in (committed, libs["kg"], libs["kg"], committed):
        _build._LIBS["fused_dw_chain_bwd"] = which
        tdw._lib_bwd()
        reads.append(cuda_ms(call("groups")))
    out["groups_resident"] = {"groups": libs["kg"].vptr_fused_dw_chain_bwd_groups(n),
                              "committed_ms": [reads[0], reads[3]],
                              "variant_ms": [reads[1], reads[2]]}
    print(f"groups = {min(16, resident)} (resident): {reads[1]:.4f} / {reads[2]:.4f} ms "
          f"({out['groups_resident']['groups']} groups) vs 16: {reads[0]:.4f} / {reads[3]:.4f}")

    lib = libs["stamped"]
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_sum.argtypes = [p] * 8 + [i, ctypes.c_long, i]
    _build._LIBS["fused_dw_chain_bwd"] = lib
    tdw._lib_bwd()
    # the sum kernel alone, over each route's partial count
    f32 = torch.float32
    outs = [torch.empty(HW, C, dtype=f32, device=dev) for _ in range(4)] + [
        torch.empty(9, C, dtype=f32, device=dev), torch.empty(C, dtype=f32, device=dev)]
    counts = {"groups": out["groups"]}
    if routed:
        counts["persistent"] = min(n, out["persistent_clusters"])
    out["sum_kernel_ms"] = {}
    for route, ng in counts.items():
        part = torch.zeros(ng, 4, HW, C, dtype=f32, device=dev)
        tpart = torch.zeros(ng, 10, C, dtype=f32, device=dev)
        args_ = [t.data_ptr() for t in (part, tpart, *outs)] + [ng, HW * C, C]
        out["sum_kernel_ms"][route] = cuda_ms(lambda: lib.probe_sum(*args_))
        print(f"dw_chain_sum_kernel over {ng} partials: {out['sum_kernel_ms'][route]:.4f} ms")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for route in routes:
        fn = call(route)
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if route == "groups":
            ng = out["groups"]
            gs = -(-n // ng)
            per_block = np.repeat([min(gs, n - k * gs) for k in range(ng)], 8).astype(float)
            blocks, slots = ng * 8, BSLOTS
        else:
            ncl = min(n, out["persistent_clusters"])
            per_block = np.repeat([len(range(k, n, ncl)) for k in range(ncl)], 16).astype(float)
            blocks, slots = ncl * 16, SLOTS
        buf = (ctypes.c_longlong * (blocks * slots))()
        if lib.probe_read(buf, blocks * slots, int(route == "persistent")) != 0:
            raise RuntimeError("reading the stamps failed")
        st = np.array(buf, dtype=np.float64).reshape(blocks, slots)
        if route == "groups":
            names, once = GROUP_PHASES, GROUP_PER_BLOCK
            starts, ends = st[:, 20], st[:, 21]
        else:
            names, once = BWD_PERSISTENT_PHASES, BWD_PER_BLOCK
            starts, ends = st[:, slots - 2], st[:, slots - 1]
        cycles = st[:, :len(names)]
        total = cycles.sum()
        rep = {"stamped_ms": start.elapsed_time(end), "blocks": blocks,
               "block_cycles_mean": float(cycles.sum(axis=1).mean()),
               "phases": {name: {"cycles_mean": float(
                   cycles[:, k].mean() if k in once else cycles[:, k].sum() / per_block.sum()),
                   "share": float(cycles[:, k].sum() / total)}
                   for k, name in enumerate(names)},
               **timeline(starts, ends, sms)}
        out[f"{route}_stamps"] = rep
        print(f"{route}: stamped kernel {rep['stamped_ms']:.4f} ms, {blocks} blocks, "
              f"block {rep['block_cycles_mean']:.0f} cycles, life {rep['block_life_us_mean']:.2f}"
              f" us, start offset mean {rep['start_offset_us_mean']:.2f} us (max "
              f"{rep['start_offset_us_max']:.2f}), SM idle share {rep['sm_idle_share']:.3f}")
        for k, (name, ph) in enumerate(rep["phases"].items()):
            print(f"  {name:36s} {ph['cycles_mean']:10.0f} cycles a "
                  f"{'block' if k in once else 'block-sample'}, share {ph['share']:.3f}")
    print(json.dumps(out))
    return 0


def bwd_variants(args, tdw, _build, fn, out) -> int:
    """The persistent backward as committed against each BWD_VARIANTS copy,
    in turns."""
    names = args.variants or list(BWD_VARIANTS)
    root = _build.BUILD_DIR.parent / "dw_bwd_probe"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for k, name in enumerate(names):
        csrc = root / f"v{k}" / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        for fname, edits in BWD_VARIANTS[name].items():
            src = (csrc / fname).read_text()
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"{name}: {old!r} not found in {fname}")
                src = src.replace(old, new)
            (csrc / fname).write_text(src)
        lib = root / f"v{k}" / "lib.so"
        procs[name] = (lib, _build_copy(_build, csrc, lib))
    committed = tdw._lib_bwd()
    libs = {name: _load(path, proc) for name, (path, proc) in procs.items()}
    out["variants"] = {}
    for name, lib in libs.items():
        reads = []
        for which in (committed, lib, lib, committed):
            _build._LIBS["fused_dw_chain_bwd"] = which
            tdw._lib_bwd()
            reads.append(cuda_ms(fn))
        _build._LIBS["fused_dw_chain_bwd"] = committed
        out["variants"][name] = {"committed_ms": [reads[0], reads[3]],
                                 "variant_ms": [reads[1], reads[2]],
                                 "less_committed_ms": min(reads[1:3]) - min(reads[0], reads[3]),
                                 "ptxas": lib.spills}
        print(f"{name:40s} {reads[1]:.4f} / {reads[2]:.4f} ms vs committed {reads[0]:.4f} / "
              f"{reads[3]:.4f}: {out['variants'][name]['less_committed_ms']:+.4f} ({lib.spills})")
    print(json.dumps(out))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--samples", type=int, default=None,
                        help="samples (default: 200, with --bwd 190)")
    parser.add_argument("--bwd", action="store_true", help="read kernel #10, not #9")
    parser.add_argument("--variants", nargs="*", choices=list(VARIANTS) + list(BWD_VARIANTS),
                        help="time these variants of the persistent route (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_dw_probe: no GPU", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if args.bwd:
        return bwd(args, root)
    args.samples = args.samples or 200
    from vptr_tpu_torch.ops import _build
    from vptr_tpu_torch.ops import fused_dw_chain as tdw

    routes = ("per_sample", "persistent") if hasattr(tdw, "kernel_route") else ("per_sample",)
    dev, bf, n = torch.device("cuda"), torch.bfloat16, args.samples
    g = torch.Generator().manual_seed(0)

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    ops = (r(n, HW, C).to(bf), r(9, C, std=0.3), r(C, std=0.1), 1 + r(HW, C, std=0.1),
           r(HW, C, std=0.1), 1 + r(HW, C, std=0.1), r(HW, C, std=0.1))

    def call(route):
        if len(routes) == 1:
            return lambda: tdw.fused_dw_chain(*ops, 0, 8, 0.0)
        return lambda: tdw._forward_kernel(*ops, None, 8, 0.0, route=route)

    if args.variants is not None:
        return variants(args, tdw, _build, ops)
    out = {"root": str(root), "card": torch.cuda.get_device_name(0), "samples": n,
           "per_sample_clusters": tdw.resident_clusters(HW, C)[0]}
    if "persistent" in routes:
        out["persistent_clusters"] = tdw.persistent_clusters(HW, C, 8)
    order = routes + routes[::-1]
    times = {route: [] for route in routes}
    for route in order:
        times[route].append(cuda_ms(call(route)))
    out["ms"] = times

    probe = _build.BUILD_DIR.parent / "dw_probe"
    shutil.rmtree(probe, ignore_errors=True)
    shutil.copytree(_build.CSRC, probe / "csrc")
    instrument(probe / "csrc")
    lib_path = probe / "libprobe.so"
    flags = list(_build.NVCC_FLAGS) + (["-DVPTR_DW_STAMPS"] if len(routes) == 2 else [])
    subprocess.run([_build.nvcc(), *flags, "-o", str(lib_path),
                    str(probe / "csrc" / "fused_dw_chain.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.vptr_error_string.argtypes = [ctypes.c_int]
    lib.vptr_error_string.restype = ctypes.c_char_p
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    _build._LIBS["fused_dw_chain"] = lib     # the wrapper now runs the stamped copy
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for route in routes:
        fn = call(route)
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if route == "per_sample":
            blocks = n * 8
        else:
            blocks = min(n, out["persistent_clusters"]) * 16
        buf = (ctypes.c_longlong * (blocks * SLOTS))()
        if lib.probe_read(buf, blocks * SLOTS, int(route == "persistent")) != 0:
            raise RuntimeError("reading the stamps failed")
        st = np.array(buf, dtype=np.float64).reshape(blocks, SLOTS)
        if route == "per_sample":
            cycles = np.diff(st[:, :12], axis=1)
            names, per = PER_SAMPLE_PHASES, 1.0
            starts, ends = st[:, 12], st[:, 13]
        else:
            cycles = st[:, :len(PERSISTENT_PHASES)]
            names = PERSISTENT_PHASES
            per = n / (blocks // 16)      # samples a block
            starts, ends = st[:, 14], st[:, 15]
        total = cycles.sum()
        rep = {"stamped_ms": start.elapsed_time(end), "blocks": blocks,
               "block_cycles_mean": float(cycles.sum(axis=1).mean()),
               "phases": {name: {"cycles_mean": float(cycles[:, i].mean() / (
                   1.0 if i in PER_BLOCK else per)),
                   "share": float(cycles[:, i].sum() / total)}
                   for i, name in enumerate(names)},
               **timeline(starts, ends, sms)}
        out[f"{route}_stamps"] = rep
        print(f"{route}: stamped kernel {rep['stamped_ms']:.4f} ms, {blocks} blocks, "
              f"block {rep['block_cycles_mean']:.0f} cycles, life {rep['block_life_us_mean']:.2f}"
              f" us, start offset mean {rep['start_offset_us_mean']:.2f} us, SM idle share "
              f"{rep['sm_idle_share']:.3f}")
        for name, p in rep["phases"].items():
            print(f"  {name:24s} {p['cycles_mean']:10.0f} cycles"
                  f"{'' if route == 'per_sample' else ' a sample'}, share {p['share']:.3f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
