#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's forecast slice on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and nvcc.
Five phases, each printing one JSON line with its own seconds:

1. device  — the card (``torch.cuda.get_device_name``, ``nvidia-smi`` name
   and power limit); TF32 is switched off for matmuls and cuDNN.
2. build   — the nvcc build of ``stgcn_tpu_torch/kernels/csrc/*.cu``, cold
   or cached, with ptxas' register / spill report.
3. kernels — K1-K4 at every shape the main path gives them, each held
   against its plain PyTorch version on the card (|Δ| <= 1e-4 + 1e-4·|ref|:
   the sums run in another order), a repeat launch bit-identical, the
   launch counter moved; then CUDA-event times (median of 30 launches
   after 5 of warm-up) of kernel and plain version.
4. slice   — PeMSD7(M) (V=228, read from data/pemsd7-m) at the full width of
   the ``main.py`` defaults, weights drawn from ``torch.Generator().
   manual_seed(42)``: the whole test split forecast at batch 32 through
   ``evaluate_metrics`` over ``fused_sparse_forward`` (the kernels) and over
   the unfused ``STGCN`` forward; every prediction must agree within
   2e-4 + 2e-4·|ref|, and the launch counts of the fused run must be K1 ×2,
   K2 ×2, K3 ×1, K4 ×1 per batch. Then both are timed again in turns (four
   runs each, median reported).
5. the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

A failed check raises: the script then exits non-zero and prints no
``"ok"`` line. Without a CUDA device it exits 2 before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
KERNEL_TOL = 1e-4           # f32 kernel vs plain version, abs and rel
SLICE_TOL = 2e-4            # fused vs unfused forward (tests/test_vertex_fused.py:49)
BATCH = 32


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def cuda_ms(fn, *, warmup: int = 5, reps: int = 30) -> float:
    """Median CUDA-event time of one call of ``fn`` in milliseconds."""
    import torch

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
    return statistics.median(times)


def flat(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def max_err(got, ref) -> float:
    """max |Δ| over all outputs; raises if any element is outside
    KERNEL_TOL·(1 + |ref|)."""
    import torch

    worst = 0.0
    for g, r in zip(flat(got), flat(ref)):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"kernel output shape {tuple(g.shape)} vs {tuple(r.shape)} "
                                 "or non-finite values")
        d = (g - r).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= KERNEL_TOL + KERNEL_TOL * r.abs()).all()):
            raise AssertionError(f"kernel disagrees with its plain version: max |Δ| "
                                 f"{float(d.max()):.3e}")
    return worst


def kernel_cases(gen):
    """(kernel name, shape label, wrapper, plain version, args, flops) at the
    main path's shapes: B=32, V=228 in Vp=256, the main.py widths."""
    import torch

    from stgcn_tpu_torch.kernels import output_head as oh
    from stgcn_tpu_torch.kernels import vertex_fused as vf

    dev = "cuda"
    b, v_true, vp = BATCH, 228, 256

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def affine(c):  # LN affine [c, Vp], zero on padded lanes as the path pads it
        g, bb = 1.0 + rnd(c, vp, scale=0.1), rnd(c, vp, scale=0.1)
        g[:, v_true:] = 0.0
        bb[:, v_true:] = 0.0
        return g, bb

    def stats(t):
        return rnd(b, t, 1, 1, scale=0.1), 0.5 + torch.rand((b, t, 1, 1), generator=gen,
                                                            device=dev)

    cases = []
    for blk, (t_in, c_in) in enumerate([(12, 1), (8, 64)]):
        cfg = vf.VertexBlockCfg(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                                v_true=v_true, v_pad=vp, t_in=t_in, c_in=c_in, c0=64, c1=16,
                                c2=64, apply_ln=blk > 0)
        x = rnd(b, t_in, c_in, vp)
        mu, rstd = stats(t_in) if cfg.apply_ln else (None, None)
        lng, lnb = affine(c_in) if cfg.apply_ln else (None, None)
        w1 = (rnd(3, c_in, 128, scale=(3 * c_in) ** -0.5), rnd(128, scale=0.1),
              rnd(64, 16, scale=64 ** -0.5), rnd(16, scale=0.1))
        head_args = (cfg, x, mu, rstd, lng, lnb, *w1)
        flops = 2 * b * cfg.t1 * vp * (cfg.kt * c_in * cfg.g1 + cfg.c0 * cfg.c1)
        cases.append(("head_fwd", f"block{blk}", vf.head_fwd,
                      lambda cfg=cfg, x=x, ln=(mu, rstd, lng, lnb), w=w1:
                      vf.head_reference(cfg, x, ln if cfg.apply_ln else None, w),
                      head_args, flops))
        xg, t1_, t2_ = (rnd(b, cfg.t1, 16, vp) for _ in range(3))
        w2 = (rnd(3, 16, 16, scale=16 ** -1), rnd(16, scale=0.1),
              rnd(3, 16, 128, scale=48 ** -0.5), rnd(128, scale=0.1))
        flops = 2 * b * vp * (cfg.t1 * 3 * 16 * 16 + cfg.t2 * cfg.kt * 16 * cfg.g2)
        cases.append(("tail_fwd", f"block{blk}", vf.tail_fwd,
                      lambda cfg=cfg, a=(xg, [t1_, t2_]), w=w2: vf.tail_reference(cfg, *a, w),
                      (cfg, xg, t1_, t2_, *w2), flops))
    ocfg = oh.OutHeadCfg(ko=4, c_in=64, c0=128, c1=128, c_end=1, act_func="glu",
                         v_true=v_true, v_pad=vp)
    x = rnd(b, 4, 64, vp)
    mu, rstd = stats(4)
    lng, lnb = affine(64)
    ck, cb = rnd(4, 64, 256, scale=256 ** -0.5), rnd(256, scale=0.1)
    args = (ocfg, x, mu, rstd, lng, lnb, ck, cb)
    cases.append(("ohead_fwd", "head", oh.ohead_fwd, lambda a=args: oh.ohead_reference(*a),
                  args, 2 * b * vp * 4 * 64 * 256))
    a = rnd(b, 1, 128, vp)
    mu2, rstd2 = rnd(b, 1, 1, 1, scale=0.1), 0.5 + torch.rand((b, 1, 1, 1), generator=gen,
                                                              device=dev)
    lnw, lnb2 = affine(128)
    w = (rnd(128, 128, scale=128 ** -0.5), rnd(128, scale=0.1), rnd(128, 1, scale=128 ** -0.5),
         rnd(1, scale=0.1))
    args = (ocfg, a, mu2, rstd2, lnw, lnb2, *w)
    cases.append(("ofc_fwd", "head", oh.ofc_fwd, lambda a=args: oh.ofc_reference(*a),
                  args, 2 * b * vp * (128 * 128 + 128 * 1)))
    return cases


def io_bytes(args, out) -> int:
    import torch

    ts = [t for t in [*args, *flat(out)] if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in ts)


KERNEL_META = {
    "head_fwd": ("K1f", "stgcn_tpu_torch/kernels/csrc/gate_gemm.cu",
                 "stgcn_tpu/kernels/vertex_fused.py:610", "_head_pallas"),
    "tail_fwd": ("K2f", "stgcn_tpu_torch/kernels/csrc/vertex_fused.cu",
                 "stgcn_tpu/kernels/vertex_fused.py:839", "_tail_pallas"),
    "ohead_fwd": ("K3f", "stgcn_tpu_torch/kernels/csrc/output_head.cu",
                  "stgcn_tpu/kernels/output_head.py:214", "_ohead_pallas"),
    "ofc_fwd": ("K4f", "stgcn_tpu_torch/kernels/csrc/gate_gemm.cu",
                "stgcn_tpu/kernels/output_head.py:407", "_ofc_pallas"),
}


def phase_kernels(torch) -> dict:
    """Phase 3: per kernel name, the per-shape measurements."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels

    results: dict[str, list] = {name: [] for name in KERNEL_META}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, label, wrapper, plain, args, flops in kernel_cases(gen):
        before = wrapper.launches
        out1 = wrapper(*args)
        out2 = wrapper(*args)
        torch.cuda.synchronize()
        if wrapper.launches != before + 2:
            raise AssertionError(f"{name}: launch counter moved {wrapper.launches - before}, "
                                 "expected 2")
        if not all(torch.equal(p, q) for p, q in zip(flat(out1), flat(out2))):
            raise AssertionError(f"{name} [{label}]: a repeat launch is not bit-identical")
        ref = plain()
        err = max_err(out1, ref)
        ms = cuda_ms(lambda: wrapper(*args))
        plain_ms = cuda_ms(plain)
        nbytes = io_bytes(args, out1)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        results[name].append({
            "shape": label, "input": list(args[1].shape), "output": list(flat(out1)[0].shape),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    kernels.reset_launch_counts()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, "tolerance": KERNEL_TOL,
          "results": results})
    return results


def phase_slice(torch) -> dict:
    """Phase 4: the whole PeMSD7(M) test split through the fused and the
    unfused forward."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import (ForecastDataset, ZScoreScaler, chrono_split,
                                      gather_windows, load_adj, load_vel)
    from stgcn_tpu_torch.graph import build_gso
    from stgcn_tpu_torch.nn import STGCN
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.ops import make_graph_op
    from stgcn_tpu_torch.train import evaluate_metrics

    n_his, n_pred = 12, 3
    data_root = str(ROOT / "data")
    adj, n_vertex = load_adj("pemsd7-m", data_root)
    vel = load_vel("pemsd7-m", data_root)
    train, _, test = chrono_split(vel)
    scaler = ZScoreScaler().fit(train)
    test_ds = ForecastDataset.from_numpy(scaler.transform(test), n_his, n_pred, device="cuda")
    gop = make_graph_op(build_gso(adj, "sym_norm_lap", cheb=True), "auto", device="cuda")
    model = STGCN(n_his, n_vertex, kt=3, ks=3, act_func="glu",
                  graph_conv_type="cheb_graph_conv", device="cuda",
                  generator=torch.Generator().manual_seed(42)).eval()
    params = model.state_dict()
    setup_s = time.perf_counter() - t0

    preds: dict[str, list] = {"fused": [], "unfused": []}

    def predictor(kind):
        def predict(starts):
            x, y = gather_windows(test_ds.series, starts, n_his, n_pred)
            if kind == "fused":
                out = fused_sparse_forward(params, x, gop, model)
            else:
                out = model(x, gop)
            pred = out.reshape(len(starts), -1)
            preds[kind].append(pred)
            return pred, y
        return predict

    with torch.inference_mode():
        starts0, _ = next(test_ds.batches(BATCH))   # warm-up: library load, allocator
        predictor("fused")(starts0), predictor("unfused")(starts0)
        preds["fused"].clear(), preds["unfused"].clear()
        torch.cuda.synchronize()
        n_batches = -(-test_ds.num_windows // BATCH)
        kernels.reset_launch_counts()
        m_fused = evaluate_metrics(predictor("fused"), test_ds, scaler, BATCH)
        launches = kernels.launch_counts()
        m_unfused = evaluate_metrics(predictor("unfused"), test_ds, scaler, BATCH)
        pf, pu = torch.cat(preds["fused"]), torch.cat(preds["unfused"])

        # wall time of the whole split, fused and unfused in turns (host
        # clock; evaluate_metrics ends in a device read-back)
        walls: dict[str, list] = {"fused": [], "unfused": []}
        for kind in ("fused", "unfused", "unfused", "fused") * 2:
            t1 = time.perf_counter()
            evaluate_metrics(predictor(kind), test_ds, scaler, BATCH)
            walls[kind].append(time.perf_counter() - t1)

    per_batch = {"head_fwd": 2, "tail_fwd": 2, "ohead_fwd": 1, "ofc_fwd": 1}
    want = {k: n * n_batches for k, n in per_batch.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if pf.shape != (n_batches * BATCH, n_vertex) or not torch.isfinite(pf).all():
        raise AssertionError(f"fused forecast has shape {tuple(pf.shape)} or non-finite values")
    d = (pf - pu).abs()
    if not bool((d <= SLICE_TOL + SLICE_TOL * pu.abs()).all()):
        raise AssertionError(f"fused and unfused forecasts differ: max |Δ| {float(d.max()):.3e}")
    for m in (m_fused, m_unfused):
        if not all(v == v and abs(v) < float("inf") for v in m.values()):
            raise AssertionError(f"non-finite metrics {m}")
    result = {"phase": "slice", "seconds": time.perf_counter() - t0, "dataset": "pemsd7-m",
              "n_vertex": n_vertex, "windows": test_ds.num_windows, "batches": n_batches,
              "batch_size": BATCH, "setup_seconds": setup_s,
              "forecast_seconds_fused": statistics.median(walls["fused"]),
              "forecast_seconds_unfused": statistics.median(walls["unfused"]),
              "forecast_seconds_all": walls,
              "max_abs_diff_fused_unfused": float(d.max()), "tolerance": SLICE_TOL,
              "launches": launches, "metrics_fused": m_fused, "metrics_unfused": m_unfused}
    emit(result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    # the port's package sits beside this script; a lone copy has none and fails here
    from stgcn_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "seconds": time.perf_counter() - t0, "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]})

    info = _build.build()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": info.seconds, "cached": info.cached,
          "library": str(info.path.relative_to(ROOT)), "ptxas": ptxas})

    per_shape = phase_kernels(torch)
    sl = phase_slice(torch)

    rows = []
    for name, shapes in per_shape.items():
        kid, source, replaces, tpu_fn = KERNEL_META[name]
        # per batch of the main path the kernel runs once at each listed shape
        rows.append({
            "name": name, "id": kid, "route": "cuda", "source": source, "replaces": replaces,
            "tpu_fn": tpu_fn, "launches": sl["launches"][name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": sum(s["ms"] for s in shapes), "kernel_ms": sum(s["ms"] for s in shapes),
            "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(s["bound_ms"] for s in shapes),
            "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
            "library_ms": None, "per_batch_shapes": shapes})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
