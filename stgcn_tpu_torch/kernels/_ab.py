"""The harness of the A/B timing tools (``bwd_ab.py``, ``sparse_ab.py``):
each ``--tree`` (the root of a checkout of this repository) runs in a
process of its own, which swaps this directory for the checkout on
``sys.path`` and imports its ``stgcn_tpu_torch``, so that checkout builds
its own kernels; trees run in the order given (two commits compare as A,
B, B, A on one card). Each process prints one JSON line, the tool's result
for its tree; then the card's ``nvidia-smi`` name and power limit.

A tool supplies ``run_one(tree, reps, data) -> dict`` and, where every tree
needs the same input, ``prepare(tmpdir) -> path``, run once before the
trees (``data`` is that path, else None). This module imports nothing of
the package: the tools load it beside themselves.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile


def timed(torch, fn, reps: int, warmup: int) -> tuple[float, str]:
    """(median CUDA-event ms of ``reps`` calls of ``fn`` after ``warmup``
    more, SHA-256 prefix of one call's outputs' bytes, so trees whose sums
    run in the same order show the same digest)."""
    out = fn()
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for o in out if isinstance(out, (tuple, list)) else (out,):
        if o is not None:
            digest.update(o.detach().cpu().numpy().tobytes())
    del out
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), digest.hexdigest()[:16]


def main(script: str, description: str, run_one, *, reps: int, prepare=None) -> int:
    """The command line of the tool at ``script``: ``--tree`` (repeated)
    and ``--reps``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--reps", type=int, default=reps)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        sys.path[0] = os.path.abspath(args.tree[0])   # the tool's directory out, the checkout in
        print(json.dumps(run_one(args.tree[0], args.reps, args.data)), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        data = prepare(tmp) if prepare is not None else None
        for tree in args.tree:
            cmd = [sys.executable, os.path.abspath(script), "--one", "--tree", tree,
                   "--reps", str(args.reps)] + ([] if data is None else ["--data", data])
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0:
                sys.stderr.write(out.stderr)
                return out.returncode
            print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0
