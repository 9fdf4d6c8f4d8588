"""Which kernels' machine code differs between two checkouts of the port.

    python3 scripts/torch_port_sass_diff.py --parent DIR [--child DIR]
        [--libs NAME ...]

Builds the kernel libraries of both trees (``vptr_tpu_torch/ops/_build.py``
of each, all nvcc processes at once), disassembles each library with
cuobjdump (beside nvcc) and compares the SASS function by function, with
the instruction addresses and encodings left out. Prints one JSON line:
for each library, the functions only in one tree, the functions whose code
differs, and the HGMMA (wgmma) count of each tree. Needs nvcc (the CUDA
toolkit), not a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BUILD = ("import sys, json; sys.path.insert(0, '.'); from vptr_tpu_torch.ops import _build; "
         "print(json.dumps({{k: str(v) for k, v in _build.build({libs}).items()}}))")


def functions(library: str, cuobjdump: str) -> dict:
    """{function name: its SASS instructions, addresses and encodings left
    out}; in the names, hex runs (the hashes nvcc gives an anonymous
    namespace) read as #."""
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                         check=True, timeout=600).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"[0-9a-f]{8,}", "#", m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name and m:
            funcs[name].append(m.group(1).strip())
    return funcs


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True)
    parser.add_argument("--child", default=str(REPO))
    parser.add_argument("--libs", nargs="*", help="libraries (default: all)")
    args = parser.parse_args()
    libs = repr(list(args.libs)) if args.libs else "None"
    roots = {"parent": Path(args.parent).resolve(), "child": Path(args.child).resolve()}
    procs = {k: subprocess.Popen([sys.executable, "-c", BUILD.format(libs=libs)], cwd=root,
                                 stdout=subprocess.PIPE, text=True)
             for k, root in roots.items()}
    paths = {}
    for k, proc in procs.items():
        out, _ = proc.communicate(timeout=1200)
        if proc.returncode != 0:
            print(f"torch_port_sass_diff: the {k} tree did not build", file=sys.stderr)
            return 1
        paths[k] = json.loads(out.strip().splitlines()[-1])
    sys.path.insert(0, str(REPO))
    from vptr_tpu_torch.ops import _build

    cuobjdump = str(Path(_build.nvcc()).parent / "cuobjdump")
    result = {}
    for lib in sorted(set(paths["parent"]) & set(paths["child"])):
        a = functions(paths["parent"][lib], cuobjdump)
        b = functions(paths["child"][lib], cuobjdump)
        result[lib] = {
            "only_parent": sorted(set(a) - set(b)), "only_child": sorted(set(b) - set(a)),
            "differ": sorted(f for f in set(a) & set(b) if a[f] != b[f]),
            "hgmma": [sum("HGMMA" in i for f in x.values() for i in f) for x in (a, b)]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
