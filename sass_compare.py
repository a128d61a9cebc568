#!/usr/bin/env python3
"""Compare the flat search's group-min sweep, as compiled, with another checkout's.

    python3 sass_compare.py --root DIR

Builds the kernel library of this checkout and of the checkout at DIR (e.g.
``git archive`` of an earlier commit unpacked into a git-ignored directory
such as ``build/``), each by its own ``ops/_kernels.py`` in a subprocess,
disassembles both with ``cuobjdump -sass`` and compares, instruction for
instruction, every ``groupmin_mma_kernel`` instantiation the flat search
launches (``csrc/groupmin_mma.cuh``: bf16 and int8, each query tile, copy
width and tile residency; where a checkout has output policies, the
search's own, ``QueryMajorMins``), keyed by their template arguments.
Instruction addresses and encodings are left out of the comparison. Prints
one JSON line (identical, differing and missing instantiations) and exits
non-zero unless all of the other checkout's are identical here. Needs the
CUDA toolkit (``nvcc``, ``cuobjdump``, ``cu++filt``): run it on the card's
machine.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from image_search_engine_tpu_torch.ops import _kernels

BUILD = ("from image_search_engine_tpu_torch.ops import _kernels; "
         "print(_kernels.build()[0])")


def build(root: Path) -> Path:
    """The kernel library of the checkout at ``root``, built there."""
    out = subprocess.run([sys.executable, "-c", BUILD], cwd=root, capture_output=True,
                         text=True, check=True)
    return Path(out.stdout.split()[-1])


def tool(name: str) -> str:
    nvcc = Path(_kernels.find_nvcc())
    return shutil.which(name) or str(nvcc.parent / name)


def sweeps(lib: Path) -> dict:
    """{template arguments: SASS instructions} of the library's production
    sweep instantiations."""
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    code, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            code[fn] = []
        elif fn and re.search(r"/\*[0-9a-f]{4}\*/", line):
            code[fn].append(re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0].strip())
    names = list(code)
    demangled = subprocess.run([tool("cu++filt")], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    out = {}
    for name, pretty in zip(names, demangled):
        m = re.search(r"groupmin_mma_kernel<(.*?)>\(", pretty)
        if not m:
            continue
        args = [a.strip() for a in m.group(1).split(",")]
        if len(args) == 4 or args[4].endswith("QueryMajorMins"):
            out[", ".join(args[:4])] = code[name]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, required=True, help="the other checkout")
    args = ap.parse_args(argv)
    theirs, ours = sweeps(build(args.root)), sweeps(build(Path(__file__).resolve().parent))
    same = sorted(k for k, v in theirs.items() if ours.get(k) == v)
    differ = sorted(k for k, v in theirs.items() if k in ours and ours[k] != v)
    missing = sorted(k for k in theirs if k not in ours)
    print(json.dumps({"identical": len(same), "of": len(theirs), "differ": differ,
                      "missing": missing}))
    return 0 if theirs and len(same) == len(theirs) else 1


if __name__ == "__main__":
    sys.exit(main())
