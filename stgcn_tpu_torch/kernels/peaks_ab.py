"""Hold the peak device memory that ``chip_smoke.py`` reads in each of its
phases, for one or more checkouts, on one CUDA card, and say which blocks
were live at a peak.

    python3 stgcn_tpu_torch/kernels/peaks_ab.py --tree PARENT --tree . > peaks.jsonl
    python3 stgcn_tpu_torch/kernels/peaks_ab.py --diff peaks.jsonl

Each ``--tree`` is the root of a checkout of this repository. Its
``chip_smoke.py`` runs whole, in a process of its own (the harness,
``_ab.py``), with ``torch.cuda.reset_peak_memory_stats`` and
``torch.cuda.max_memory_allocated`` wrapped. At each reset and each read the
wrapper notes the calling function and the caching allocator's counters:
``allocated_bytes`` (the blocks handed to tensors, which is what
``max_memory_allocated`` reads) and ``requested_bytes`` (what the tensors
asked for). The two differ where the allocator hands out more than was
asked: it rounds every request up to 512 bytes, and hands out a cached
block whole where splitting it would leave no more than 1 MiB.

Between a reset and the next read made within the functions named in
``HISTORY`` (``phase_fused_dense`` and ``phase_banded_100k``, and what they
call), the allocator's history is recorded. The read replays it from the reset: the
running sum of the bytes of each allocation less each completed free (the
trace gives requested sizes), on top of the requested bytes live at the
reset, gives the moment of the peak, and the allocations made since the
reset and live at that moment are listed by size and by the function of
the port or of ``chip_smoke.py`` that made them; beside them, per such
function, the bytes that live blocks hold beyond their requests at the
read.

Per tree it prints one JSON line: ``rc`` (``chip_smoke.py``'s exit code)
and ``reads``, in order, each with its reset and the phase it lies in.
Then the ``nvidia-smi`` name and power limit of the card. ``--diff`` reads
such output on any host and prints, per read, each later tree's allocated
and requested peaks less the first tree's, and, where both recorded a
history, whether the allocations live at the peak are the same.
"""

from __future__ import annotations

import collections
import os
import runpy
import sys

if __package__:
    from stgcn_tpu_torch.kernels import _ab
else:   # run as a script: its directory is sys.path[0]
    import _ab

HISTORY = ("phase_fused_dense", "phase_banded_100k")
MAX_ENTRIES = 1_000_000


def _where(frames: list) -> str:
    """The first frame that lies in the port or in ``chip_smoke.py``, as
    ``path:function`` relative to its checkout."""
    for f in frames:
        name = f.get("filename", "")
        for mark in ("/stgcn_tpu_torch/", "/chip_smoke.py"):
            i = name.rfind(mark)
            if i >= 0:
                return f"{name[i + 1:]}:{f.get('name', '?')}"
    return "elsewhere"


def _replay(torch, base: int) -> dict:
    """The recorded history since the reset, replayed to its peak."""
    snap = torch.cuda.memory._snapshot()
    trace = snap["device_traces"][torch.cuda.current_device()]
    now, peak, at = base, base, -1
    for i, e in enumerate(trace):
        if e["action"] in ("alloc", "free_completed"):
            now += e["size"] if e["action"] == "alloc" else -e["size"]
            if now > peak:
                peak, at = now, i
    held: dict = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            held[e["addr"]] = e
        elif e["action"] == "free_completed":
            held.pop(e["addr"], None)
    blocks = collections.Counter((_where(e.get("frames", [])), e["size"]) for e in held.values())
    over = collections.Counter()
    for seg in snap["segments"]:
        for b in seg["blocks"]:
            if b["state"] == "active_allocated" and b["size"] > b["requested_size"]:
                over[_where(b.get("frames", []))] += b["size"] - b["requested_size"]
    return {"entries": len(trace), "peak": peak, "peak_entry": at,
            "live_since_reset": sorted(([w, s, n] for (w, s), n in blocks.items()),
                                       key=lambda r: (-r[1] * r[2], r[0])),
            "handed_over_request_now": sorted(([w, n] for w, n in over.items()),
                                              key=lambda r: (-r[1], r[0]))}


def run_one(tree: str, reps: int, data) -> dict:
    """Run the checkout's ``chip_smoke.py`` with the allocator's counters
    noted at every reset and read of its peak."""
    import torch

    reads: list = []
    state: dict = {}
    reset, read = torch.cuda.reset_peak_memory_stats, torch.cuda.max_memory_allocated

    def counters() -> dict:
        st = torch.cuda.memory_stats()
        return {f"{k}.{w}": st.get(f"{k}.all.{w}") for k in ("allocated_bytes", "requested_bytes")
                for w in ("current", "peak")} | {"reserved": st.get("reserved_bytes.all.current")}

    def callers() -> list:   # the functions calling the hook, innermost first
        f, names = sys._getframe(2), []
        while f is not None:
            names.append(f.f_code.co_name)
            f = f.f_back
        return names

    def hooked_reset(device=None):
        reset(device)
        names = callers()
        phase = next((n for n in names if n.startswith("phase_")), names[0])
        state.update(caller=names[0], phase=phase, at_reset=counters(),
                     history=any(n in HISTORY for n in names))
        if state["history"]:
            torch.cuda.memory._record_memory_history(stacks="python", max_entries=MAX_ENTRIES)

    def hooked_read(device=None):
        value = read(device)
        entry = {"caller": callers()[0], "max_memory_allocated": value,
                 "counters": counters(), "reset": dict(state)}
        if state.get("history"):
            torch.cuda.synchronize()
            entry["history"] = _replay(torch, state["at_reset"]["requested_bytes.current"])
            torch.cuda.memory._record_memory_history(enabled=None)
            state["history"] = False
        reads.append(entry)
        return value

    torch.cuda.reset_peak_memory_stats = hooked_reset
    torch.cuda.max_memory_allocated = hooked_read
    saved_argv = sys.argv
    sys.argv = [os.path.join(tree, "chip_smoke.py")]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        sys.argv = saved_argv
    sys.stdout.flush()
    return {"tree": tree, "rc": rc, "reads": reads}


def diff(path: str) -> int:
    """Each later tree's peaks against the first tree's, read by read."""
    import json

    with open(path) as f:
        trees = [json.loads(ln) for ln in f if ln.startswith('{"tree"')]
    first = trees[0]
    for other in trees[1:]:
        for i, (a, b) in enumerate(zip(first["reads"], other["reads"])):
            row = {"read": i, "phase": a["reset"].get("phase"), "caller": a["caller"],
                   "tree": other["tree"], "allocated_peak": b["max_memory_allocated"],
                   "allocated_over_first": b["max_memory_allocated"] - a["max_memory_allocated"],
                   "requested_peak": b["counters"]["requested_bytes.peak"],
                   "requested_over_first": (b["counters"]["requested_bytes.peak"]
                                            - a["counters"]["requested_bytes.peak"])}
            if "history" in a and "history" in b:
                row["same_live_at_peak"] = (a["history"]["live_since_reset"]
                                            == b["history"]["live_since_reset"])
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--diff"]:
        sys.exit(diff(sys.argv[2]))
    sys.exit(_ab.main(__file__, __doc__.splitlines()[0], run_one, reps=1))
