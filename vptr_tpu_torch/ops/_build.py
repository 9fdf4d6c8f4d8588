"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file exports a plain C interface and is compiled on its
own into a shared library for ``sm_90a`` (Hopper) at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so <name>.cu

The library name carries a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded from ``build/kernels/``
(listed in ``.gitignore``). :func:`build` starts one nvcc per missing
library, all at once, and waits for all of them; a failed build raises with
nvcc's output. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("attention_core", "fused_window_attention_ln",
           "fused_window_attention_ln_bwd", "fused_window_attention",
           "fused_window_attention_bwd", "fused_ffn", "fused_ffn_bwd",
           "fused_dw_chain", "fused_dw_chain_bwd", "conv_ln_gelu",
           "conv_ln_gelu_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH, $CUDA_HOME or /usr/local/cuda)")


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, every header of
    ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one nvcc process per source, all running together. Returns
    {name: library path}; nvcc's ``-Xptxas -v`` report of each fresh build
    (registers, shared memory, spills) is kept beside it as ``.log``."""
    names = tuple(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.is_file():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])   # atomic: a concurrent loader never
                                        # sees a half-written library
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.vptr_error_string.argtypes = [ctypes.c_int]
        lib.vptr_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C entry points return
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        msg = lib.vptr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


F16_QUEUED = ("float16 runs on kernels #1-#6's FMA routes only; f16 kernels for #7-#12 "
              "and for #2/#4's long route are queued (ROADMAP.md §1)")


def dtype_code(dtypes: Dict[torch.dtype, int], dtype: torch.dtype, what: str) -> int:
    """``dtypes[dtype]``, the code a kernel's entry points take for the
    dtype; a dtype the kernel has no instantiation for raises ValueError
    before any launch, naming what it takes (for float16, where f16 runs
    and that the rest is queued)."""
    if dtype in dtypes:
        return dtypes[dtype]
    takes = " or ".join(str(d).replace("torch.", "") for d in dtypes)
    queued = f"; {F16_QUEUED}" if dtype == torch.float16 else ""
    raise ValueError(f"{what} kernel takes {takes}, got {dtype}{queued}")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor as a Python int, None for None."""
    return None if t is None else t.data_ptr()
