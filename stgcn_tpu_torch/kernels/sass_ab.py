"""Hold the compiled kernels of one checkout to another's, SASS for SASS.

    python3 stgcn_tpu_torch/kernels/sass_ab.py --tree PARENT --tree . \\
        --match gate_gemm_kernel --match tail_h_kernel

Each ``--tree`` is the root of a checkout of this repository. Each builds its
kernels (``_build.build()`` in a process of its own, into that checkout's
``_build/``), then ``cuobjdump -sass`` lists the library's kernels. For every
kernel of the first tree whose mangled name holds a ``--match`` string (all
kernels without one), the tool looks in each later tree for a kernel with
the same SASS: every instruction and its encoding (the lines between the
function's name line and the next one, without the headers of the ELF
sections that follow a cubin's last function). Names are not compared (a kernel that gained a template
parameter, such as the operand type, keeps its code under a new name). It
prints one JSON line: per kernel of the first tree, the names of the later
tree's kernels with identical SASS (empty: none), and whether every kernel
found one. Needs ``nvcc`` and ``cuobjdump`` (``/usr/local/cuda/bin``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from stgcn_tpu_torch.kernels import _build; print(_build.build().path)")


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("cuobjdump not found (checked PATH and /usr/local/cuda/bin)")


def kernels(tree: str) -> dict[str, str]:
    """Mangled name → SASS body of every kernel of ``tree``'s library."""
    out = subprocess.run([sys.executable, "-c", BUILD, os.path.abspath(tree)],
                         capture_output=True, text=True, check=True)
    lib = out.stdout.strip().splitlines()[-1]
    dump = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    found: dict[str, list[str]] = {}
    name = None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            found[name] = []
        elif name is not None and line.strip().startswith("/*"):   # an instruction, its encoding
            found[name].append(line.strip())
    return {n: "\n".join(body) for n, body in found.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--match", action="append", default=[])
    ap.add_argument("--dump", help="write each tree's matched kernels' SASS under this directory")
    args = ap.parse_args()
    if len(args.tree) < 2:
        ap.error("give two trees or more")
    every = [kernels(tree) for tree in args.tree]
    if args.dump:
        for i, found in enumerate(every):
            os.makedirs(os.path.join(args.dump, str(i)), exist_ok=True)
            for n, b in found.items():
                if not args.match or any(s in n for s in args.match):
                    with open(os.path.join(args.dump, str(i), n[-150:] + ".sass"), "w") as f:
                        f.write(b + "\n")
    first = {n: b for n, b in every[0].items()
             if not args.match or any(s in n for s in args.match)}
    result = {"trees": args.tree, "match": args.match, "kernels": len(first), "same": {}}
    for tree, found in zip(args.tree[1:], every[1:]):
        by_body: dict[str, list[str]] = {}
        for n, b in found.items():
            by_body.setdefault(b, []).append(n)
        result["same"][tree] = {n: by_body.get(b, []) for n, b in first.items()}
    result["all_same"] = bool(first) and all(
        names for per in result["same"].values() for names in per.values())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
