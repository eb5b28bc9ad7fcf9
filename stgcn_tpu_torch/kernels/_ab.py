"""The harness of the A/B timing tools (``fwd_ab.py``, ``bwd_ab.py``,
``sparse_ab.py``): each ``--tree`` (the root of a checkout of this
repository) runs in a process of its own, which swaps this directory for
the checkout on ``sys.path`` and imports its ``stgcn_tpu_torch``, so that
checkout builds its own kernels; trees run in the order given (two commits
compare as A, B, B, A on one card). Each process prints one JSON line, the
tool's result for its tree; then the card's ``nvidia-smi`` name and power
limit. ``launches`` lists the device kernels of one call, as
``torch.profiler`` sees them, and ``retired_launches`` picks out of such a
list the launches of the kernels that the redesigns of K4b, K12b and K12f
retired (``RETIRED``).

A tool supplies ``run_one(tree, reps, data) -> dict`` and, where every tree
needs the same input, ``prepare(tmpdir) -> path``, run once before the
trees (``data`` is that path, else None). This module imports nothing of
the package: the tools load it beside themselves.

The first run of each distinct tree keeps what every timed call returned
(outputs of more than 2^24 elements as an even sample of that many); after
the trees, one more JSON line holds each later tree's outputs against the
first tree's: per output the max |Δ| and max |ref|, and whether every
element lies within 1e-4·max |ref| + 1e-4·|ref|, so trees whose sums run
in another order can be held to each other where their digests differ.
That is ``chip_smoke.py``'s kernel tolerance, 1e-4·min(1, max |ref|) +
1e-4·|ref|, wherever max |ref| <= 1, as for a real step's gradients; the
tools' inputs are random and unscaled, so a weight gradient summed over
1e7 lanes reaches 1e4, and there the floor scales with the output.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

KEEP: str | None = None    # where this tree keeps its outputs (--keep), else None
SAMPLE = 1 << 24           # elements kept of a larger output
TOL = 1e-4                 # chip_smoke.py's KERNEL_TOL


def _kept(torch, o):
    flat = o.detach().reshape(-1)
    step = -(-flat.numel() // SAMPLE)
    return flat[::step].cpu() if step > 1 else flat.cpu()


def timed(torch, fn, reps: int, warmup: int, key: str | None = None) -> tuple[float, str]:
    """(median CUDA-event ms of ``reps`` calls of ``fn`` after ``warmup``
    more, SHA-256 prefix of one call's outputs' bytes, so trees whose sums
    run in the same order show the same digest). With ``key`` and a keep
    directory, that call's outputs are kept under ``key``."""
    out = fn()
    torch.cuda.synchronize()
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,)) if o is not None]
    digest = hashlib.sha256()
    for o in outs:   # in pieces of 2^26 elements: K11's output holds 3.3e9 floats
        flat = o.detach().reshape(-1)
        if flat.dtype == torch.bfloat16:   # numpy has no bf16: its 16-bit patterns
            flat = flat.view(torch.int16)
        for i in range(0, flat.numel(), 1 << 26):
            digest.update(flat[i:i + (1 << 26)].cpu().numpy().tobytes())
    if KEEP and key:
        torch.save([_kept(torch, o) for o in outs],
                    os.path.join(KEEP, key.replace("/", "__") + ".pt"))
    del out, outs
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


def launches(torch, fn) -> list:
    """The device kernels of one call of ``fn`` (after a warm-up call), in
    launch order: name and device ms, as ``torch.profiler`` records them.
    Two elementwise marker kernels run first inside the profile and are cut
    off with every kernel before them (the profiler can miss its first
    kernel), so ``fn`` itself must not start with an elementwise kernel. A
    profile that comes back without a kernel (seen once for a whole call) is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev: list = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            marker.add_(1.0)
            marker.add_(1.0)
            fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                    key=lambda e: e.time_range.start)
        while ev and "elementwise" in ev[0].name:
            ev.pop(0)
        if ev:
            break
    return [{"name": e.name.replace("(anonymous namespace)::", "").split("(")[0][:80],
             "ms": (e.time_range.end - e.time_range.start) / 1e3} for e in ev]


# the one-thread-a-lane contraction and K12f's separate gate pass, which no
# kernel launches any more (their sources are gone): a trace that holds one
# ran an old tree
RETIRED = ("contract_kernel", "gate_fwd_kernel")


def retired_launches(name: str, ev: list) -> list:
    """The names in the launch list ``ev`` of one ``name`` call (K4b's
    ``ofc_bwd``, K12f's ``stblock_fwd`` or K12b's ``stblock_bwd``) that are
    ``RETIRED`` kernels', over the whole call. Raises where ``ev`` is empty,
    so an empty or cut trace cannot pass."""
    if not ev:
        raise AssertionError(f"{name}: the trace holds no launch")
    return [e["name"] for e in ev if e["name"].split("<")[0].split("::")[-1] in RETIRED]


def compare(keeps: list) -> dict:
    """Each later tree's kept outputs against the first tree's."""
    import torch

    (ref_tree, ref_dir), result = keeps[0], {}
    for tree, d in keeps[1:]:
        for path in sorted(glob.glob(os.path.join(ref_dir, "*.pt"))):
            name = os.path.basename(path)
            other = os.path.join(d, name)
            if not os.path.exists(other):
                continue
            refs, gots = torch.load(path), torch.load(other)
            diffs, maxes, ok = [], [], len(refs) == len(gots)
            for r, g in zip(refs, gots):
                r, g = r.double(), g.double()
                d_ = (g - r).abs()
                ref_max = float(r.abs().max()) if r.numel() else 0.0
                bound = TOL * ref_max + TOL * r.abs()
                ok = ok and bool((d_ <= bound).all())
                diffs.append(float(d_.max()) if d_.numel() else 0.0)
                maxes.append(ref_max)
            result[f"{tree}:{name[:-3].replace('__', '/')}"] = {
                "max_abs_diff": diffs, "ref_max": maxes, "within_kernel_tol": ok}
    return {"compare_to": ref_tree, "tolerance": TOL, "outputs": result,
            "all_within_kernel_tol": all(v["within_kernel_tol"] for v in result.values())}


def main(script: str, description: str, run_one, *, reps: int, prepare=None) -> int:
    """The command line of the tool at ``script``: ``--tree`` (repeated)
    and ``--reps``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--reps", type=int, default=reps)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    ap.add_argument("--keep", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        global KEEP
        KEEP = args.keep
        sys.path[0] = os.path.abspath(args.tree[0])   # the tool's directory out, the checkout in
        print(json.dumps(run_one(args.tree[0], args.reps, args.data)), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        data = prepare(tmp) if prepare is not None else None
        keeps: dict[str, str] = {}
        for tree in args.tree:
            cmd = [sys.executable, os.path.abspath(script), "--one", "--tree", tree,
                   "--reps", str(args.reps)] + ([] if data is None else ["--data", data])
            key = os.path.realpath(tree)
            if key not in keeps:
                keeps[key] = os.path.join(tmp, f"keep{len(keeps)}")
                os.makedirs(keeps[key])
                cmd += ["--keep", keeps[key]]
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0:
                sys.stderr.write(out.stderr)
                return out.returncode
            print(out.stdout.strip().splitlines()[-1], flush=True)
        if len(keeps) > 1:
            print(json.dumps(compare(list(keeps.items()))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0
