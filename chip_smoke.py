#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's forecast and training slices on one CUDA card
and check them: PeMSD7(M) through the dense operator, fused per vertex tile
(K1-K4, float32, and the forward in bf16) and as whole ST blocks (K12, also at
PEMS-BAY batch 512), then a 100k-vertex
road graph through the banded operator, fused through its kernel K5 and
unfused (``main.py``'s default route there) through the vn kernels K7-K9,
f32 and int8, and in bf16 with remat (the vn kernel's bf16 variant), then
the 1M-vertex road graph through the blocked-ELL operator and its kernel K6
and through the BCSR operator (what ``make_graph_op(kind="auto")`` picks
there) and its kernels K10 and K11, float32 and bf16 with remat (K10's bf16
variant) and the fused forward in bf16 around K10's bf16 variant, then the
CLI.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and nvcc.
Twenty-five phases, each printing one JSON line with its own seconds:

1. device  — the card (``torch.cuda.get_device_name``, ``nvidia-smi`` name
   and power limit); TF32 is switched off for matmuls and cuDNN.
2. build   — the nvcc build of ``stgcn_tpu_torch/kernels/csrc/*.cu`` (one
   nvcc per source, all started together, then one link), cold or cached,
   with ptxas' register / spill report.
3. kernels — K1-K4 forward at every shape the forecast path gives them (and
   K3/K4 with the gtu gate), random inputs, each held against its plain
   PyTorch version on the card (|Δ| <= 1e-4·min(1, max |ref|) + 1e-4·|ref|
   per output: the sums run in another order), a repeat launch
   bit-identical, the launch counter moved;
   then CUDA-event times (median of 30 launches after 5 of warm-up) of
   kernel and plain version.
3a. kernels_bf16 (part ``fused_fwd``) — the bf16 variants of K1f-K4f (the
   gate GEMM and ``tail_h_kernel`` on bf16 operands, float32 sums, the TPU's
   bf16 rounding points) at every forecast-path shape: PeMSD7(M) batch 32,
   100k batch 8 and 1M batch 1 (Vp of the banded and ELL operators), random
   bf16 inputs, K1f and K2f at both blocks, K3f with glu (and gtu at
   PeMSD7(M)), K4f; dropout on for K1f block 2, K3f and K4f. Each held to
   its plain version in bf16 (``kernels/bf16_bounds.py``: within 2^-7 of
   |ref| plus the rounding scale of the terms, at most a share 2^-10 of an
   output's elements outside 2 ulps of bf16), a repeat launch
   bit-identical, two launches counted under its ``_bf16`` name and none
   under the float32 kernel's; CUDA-event times of the bf16 kernel, the
   float32 kernel on the same values and the plain version, beside both
   bounds (operations at the bf16 tensor cores' 989 TFLOP/s and at the f32
   FMA rate, 2-byte operands over 3.35 TB/s).
3b. kernels_bf16 (part ``fused_bwd``) — the bf16 variants of K1b-K4b
   (``csrc/bwd_blocks_bf16.cu``: the backward passes on bf16 operands,
   float32 sums and weight gradients, the TPU's bf16 rounding points, each
   tap of the data gradient rounded and the taps added in bf16) at the same
   three shapes, random bf16 inputs and cotangents: K1b and K2b at both
   blocks (K1b block 2 with dropout, and with the relu gate), K3b with glu,
   relu (and gtu at PeMSD7(M)) and dropout, K4b with dropout. Each call's
   bf16 outputs held to its plain version in bf16 as in 3a
   (``bf16_bounds.head_bwd_scale`` .. ``ofc_bwd_scale``), its float32
   outputs (weight gradients, the statistics' gradients) within 2^-8 in
   relative L2; a repeat launch bit-identical; two launches counted under
   its ``_bf16`` name and none under the float32 kernel's; CUDA-event
   times of the bf16 kernel, the float32 kernel on the same values and the
   plain version, beside both bounds (the backward's operations 3× the
   forward's).
4. kernels_bwd — one fused training step on a PeMSD7(M) batch (dropout on)
   records the inputs of every kernel call of the training path: K1f/K2f ×2,
   K3f, K4f and the backward kernels K1b/K2b ×2, K3b, K4b. Each recorded call
   is checked and timed as in phase 3 against its plain version (the
   backward's is autograd through the forward's, same mask); the floor of
   the tolerance shrinks with an output whose entries are all below 1 (the
   step's data gradients are about 1e-5), and each output's max |ref| is
   printed beside max |Δ|. K2b and K4b, whose functions have a ReLU, are
   held to the kernel's ReLU decisions only at units whose input is within
   rounding of 0, and elementwise everywhere (``relu_checked``). The forward
   kernels' dropout masks, read back through identity weights
   (``kernels/probes.py``), must equal the plain mask bit for bit, with a
   keep rate within 4σ of 0.5.
5. slice   — PeMSD7(M) (V=228, read from data/pemsd7-m) at the full width of
   the ``main.py`` defaults, weights drawn from ``torch.Generator().
   manual_seed(42)``: the whole test split forecast at batch 32 through
   ``evaluate_metrics`` over ``fused_sparse_forward`` (the kernels) and over
   the unfused ``STGCN`` forward; every prediction must agree within
   2e-4 + 2e-4·|ref|, and the launch counts of the fused run must be K1 ×2,
   K2 ×2, K3 ×1, K4 ×1 per batch and no backward. Then both are timed again
   in turns (four runs each, median reported).
6. train   — the same model and data, droprate 0.5, AdamW + StepLR: one
   batch's loss and gradients fused against unfused with the same masks
   (relative L2 < 1e-4, each element within 2e-4 + 2e-3·|ref|: the JAX
   package's fused-vs-autodiff bound); the first 20 step losses of a fused
   and an unfused ``Trainer`` from the same weights within 1e-4 + 1e-4·|ref|;
   a fused ``Trainer.fit`` of 3 epochs with a finite, falling train loss and
   launches per step K1f ×2, K2f ×2, K3f, K4f, K1b ×2, K2b ×2, K3b, K4b
   (validation launches none), then ``test()`` from the best checkpoint,
   which prints the reference ``Dataset pemsd7-m | Test loss …`` line; then
   3 unfused epochs, for the seconds per epoch of both routes.
7. kernels_stblock — K12f and K12b (the whole dense ST block) at every call of
   one PeMSD7(M) training step through ``fused_forward`` (two blocks, dropout
   on) and of one PEMS-BAY step at batch 512 (``BASELINE.json`` configs[2]:
   ``data/pems-bay/adj.npz``, inputs from ``numpy.random.default_rng(0)`` as
   ``scripts/bench_fused.py``), recorded, plus a generality set at the
   PeMSD7(M) block-0 shape (gtu, relu, silu; Ks 2 and 4; ``graph_conv``),
   each held against its plain version as in phase 3, repeat bit-identical,
   the counter moved; K12b's plain version takes the kernel's ReLU decisions
   (read back through ``relu_out``), and each one it changes must have |r|
   within 1e-5 of max |r|. Timed beside the bound: max(bytes over 3.35 TB/s,
   the JAX cost estimate's FLOPs at the true V over 67 TFLOP/s, the backward
   3×); no one PyTorch call computes the block, so no library time. Each
   PEMS-BAY K12f and K12b call is traced alone (its launches in order; none
   may be a kernel the redesigns retired, ``contract_kernel`` or
   ``gate_fwd_kernel``), and one ``torch.matmul`` of the graph product
   ``[B·t1·c1, Vp] × [Vp, Vp]`` is timed at each K12f call's shape (K12f's
   "chain only" yardstick, ``chain_only_pems_bay`` in its row of the kernels
   line) and at the first K12b call's (K12b's "adjoint only",
   ``adjoint_only_pems_bay``).
8. fused_dense — the dense whole-block route end to end: the PeMSD7(M) test
   split through ``fused_forward`` against the unfused forward and
   ``fused_sparse_forward`` (2e-4 + 2e-4·|ref|; launches K12f ×2 a batch and
   nothing else); one batch's gradients against the unfused ones with the
   same masks (the bounds of phase 6); 20 AdamW steps (lr 1e-3, weight
   decay 1e-3) dense and unfused from the same weights, losses within
   1e-4 + 1e-4·|ref|, launches K12f ×2 and K12b ×2 a step and none of
   K1-K11; then PEMS-BAY at batch 512: the forward of the three routes
   against each other, one step's gradients dense against unfused, and the
   CUDA-event ms of each route's forward and training step (AdamW) with
   the peak memory above what was allocated before, in turns, and one step
   of each route traced by ``torch.profiler``: its kernels' device time by
   name and in all, that sum's share of the step, and the launches of the
   retired ``contract_kernel`` and ``gate_fwd_kernel`` (the dense step's
   must be 0).
8a. fused_bf16 — ``fused_sparse_forward`` of ``STGCN(dtype=bfloat16)`` (the
   weights of phase 5's model) on the dense operator: the PeMSD7(M) test
   split (launches K1f/K2f bf16 ×2, K3f/K4f bf16 ×1 a batch, no float32
   K1-K4) and a PEMS-BAY batch of 512, each held to the unfused bf16
   model's forecast and to the float32 fused forecast within atol 0.1, rtol
   0.05 (max |Δ| printed); the bf16 and float32 fused forecasts timed in
   turns; the dense bf16 graph product (``torch.matmul``) at the PeMSD7(M)
   block-1 shape with ``allow_bf16_reduced_precision_reduction`` on and
   off, each against the exact products summed in float32.
8b. fused_bf16_train — fused training in bf16 on the dense operator: a
   3-epoch PeMSD7(M) ``Trainer.fit`` with ``fused=True,
   compute_dtype="bfloat16"`` (``STGCN(dtype=bfloat16)``, phase 6's weights,
   batches and dropout seed), its epoch losses within rtol 0.08 of phase 6's
   float32 fused fit, its validation losses no higher than 1.08× the largest
   of phase 6's two float32 fits (whose own validation losses end up to 29 %
   apart: a chaotic read of the trajectory), launches per step K1f/K2f/K1b/K2b
   bf16 ×2 and K3f/K4f/K3b/K4b bf16 ×1 and no float32 kernel, validation
   launching none (the unfused model), ``test()``, step seconds beside the
   float32 fit's and the fit's peak memory; then three PEMS-BAY batch-512
   fused steps (AdamW) in bf16 and in float32 from the same weights, losses
   within rtol 0.08, step seconds, launches and peak memory of each.
9. kernels_banded — the 100k-vertex problem (``random_road_graph(100_000,
   k_neighbors=8, seed=0)``, ``sym_norm_lap`` Chebyshev GSO with Lanczos
   lambda_max, RCM, the banded operator of 256-row slabs that the JAX CLI
   builds under ``--fused``: the vn stream pack and the nv one, f32; one day
   of synthetic series; ``BASELINE.json`` configs[3]) is built, each host
   step timed. The operator leaves each slab pack's nonzero index
   (``kernels/nnz_index.py``) unbuilt; the nv and vn packs' are built from
   the slabs on the card, as the first launch would (timed, counted as one
   build each), and held against the packed CSR matrix. K5 walks that
   index (K6's transposing walk). K5 in modes single, pair and chain at N =
   1280 and 768 (B·T·c1 of the two ST blocks at batch 8) on the real pack,
   random operands, held against its plain version as in phase 3, repeat
   bit-identical; timed beside its bound (bytes over 3.35 TB/s against the
   nonzeros' FLOPs over 67 TFLOP/s; what the kernel moves, the index, a
   32-byte sector a value, the workspace passes and the operands, and the
   band's FLOPs are printed too) and ``torch.sparse.mm`` on the CSR GSO
   (operand transposed outside the timing).
10. kernels_banded_vn — on the same 100k graph, the int8 operator (vn and
   nv packs, per-row scales) and the clamped one of ``stream=False``
   (128-aligned windows, a pack of its own for Aᵀ) built on the card, each
   pack timed, and their indexes built and checked as in phase 9 (vn and
   nv int8, the clamped pack and its transpose); the vn kernel (K10's row
   walk over the index) at N = 1280 and 768 on the real packs, random
   operands: K7 at scale 1 and 2 and K9 pair and chain on the f32 and int8
   stream packs, K8 pair on the clamped pack; and K5 single, pair and chain
   on the int8 nv pack; each held against its plain version as in phase 3,
   repeat bit-identical, timed beside its bound (the nonzeros as CSR, int8
   values at 1 B and the row factors, the operands read or written once;
   2·nnz·N FLOPs an application) and ``torch.sparse.mm`` on the CSR GSO.
11. kernels_bf16 (part ``vn_100k``) — the bf16 variant of the vn kernel:
   a bf16 operand at N = 1280 and 768, random, over the f32 stream pack,
   a bf16 one (``banded_graph_op(dtype=bfloat16)``, as the bench packs it,
   built on the card, timed, its index checked as in phase 9) and the int8
   one: K7 at scale 1 and 2, K9 pair and chain; K8 pair on the clamped f32
   pack. Each held against its plain version in bf16 (the same rounding
   points: single and ``mid`` within 2 ulps of bf16 plus the floor, the
   second pass within 2 ulps of its plain version fed with the kernel's
   ``mid``, the whole within 2^-6·(|ref| + |x|)), repeat bit-identical,
   timed beside its bound (2-byte operands) and ``torch.sparse.mm`` on the
   bf16 CSR GSO where it takes bf16.
12. banded_100k — one forecast batch of 8 fused against the unfused model on
   the same banded operator (K5 against K9; 2e-4 + 2e-4·|ref|, launches
   K1/K2 ×2, K3, K4, K5 pair ×2); every K1-K4 call of one fused training
   step at 100k held against its plain version; then, on a line of its own
   (``banded_100k_trace``), one fused step's backward traced by
   ``torch.profiler`` (device ms by kernel name), each of that step's K1b,
   K2b, K3b and K4b calls traced alone (its launches in order: block 1 and
   block 2, and the head; K4b's with no retired kernel), K1b block
   2's weight gradient dc1k beside one ``torch.matmul`` of the same product
   (K1b's "wgrad only" yardstick, in the K1b row of the kernels line as
   ``wgrad_only_100k``), and K3b's gate pass and K4b's fc pass each beside
   one ``torch.matmul`` of its recompute (K3b's and K4b's "recompute
   only", ``recompute_only_100k`` in their rows); one batch's fused gradients
   against unfused (the bound of phase 6); a fused ``Trainer.fit(1)`` with
   every step's loss (finite) and seconds and launches per step K1-K4 as in
   phase 6 plus K5 pair ×2 and chain ×2 (validation batches: the forward's);
   ``test()``; peak device memory of the fit and test, and apart from it
   that of the checks before it.
13. banded_100k_unfused — the 100k route of ``auto`` without ``--fused``:
   one forecast batch of the unfused model through K9 (launches K9 pair ×2)
   against the fused one through K5; on ``banded_int8`` K9 int8 against K5
   int8 (and the int8 forecast's distance from the f32 one, printed); the
   clamped pack (K8 pair ×2) against the stream one; a ``graph_conv``
   model's forecast through K7 against K5 single, f32 and int8 (each within
   2e-4 + 2e-4·|ref|); every vn call of one unfused training step (K9 pair
   ×2, chain ×2) against its plain version; an unfused ``Trainer.fit(1)``
   with finite losses, every step's seconds, launches per step K9 pair ×2
   and chain ×2 and K5 none, and ``test()``, rebuilding no nonzero index
   (so phase 12's fit); the fit's peak memory apart from the checks'. Then
   the int8 and clamped operators are freed.
14. banded_100k_bf16 — ``bench.py:253-335`` unfused as ``--compute_dtype
   bfloat16 --remat True`` builds it: ``STGCN(dtype=bfloat16, remat=True)``
   over the f32 stream pack (a bf16 operand), batch 8, AdamW: forecast
   batches of the bf16 model against the f32 model's on the same operator
   within the JAX package's bf16 bound (atol 0.1, rtol 0.05): on the stream
   pack (K9 pair bf16 ×2), the int8 one (K9 pair int8 bf16 ×2), the clamped
   one (K8 bf16 ×2) and, in a graph_conv model, the stream and int8 packs
   (K7 bf16 and int8 bf16 ×2); then the int8 and clamped operators are
   freed; every vn call of one
   training step (K9 pair and chain bf16 ×2 each) against its plain version
   as in phase 11; a ``Trainer.fit(1)`` with launches per step K9 pair bf16
   ×2 and chain bf16 ×2 and nothing else (remat replays no graph product),
   losses finite and within rtol 0.08 of phase 13's f32 fit, step seconds,
   peak memory, ``test()``; then the same fit without remat, whose peak must
   be the higher; one more step of each traced by ``torch.profiler`` (its
   kernels by device time, the device's busy share of the step).
15. kernels_ell — the 100k problem freed, the 1M-vertex problem
   (``random_road_graph(1_000_000, k_neighbors=8, seed=0)``, ``sym_norm_lap``
   Chebyshev GSO with Lanczos lambda_max, RCM, the blocked-ELL packs of
   256 × 256 tiles, int8 and f32, scattered on the card, 55 steps of
   synthetic series; ``BASELINE.json`` configs[4], ``bench.py:338-470``) is
   built, each host step timed; nnz, tiles and their fill, pack bytes. The
   operators leave each pack's nonzero index (``kernels/nnz_index.py``)
   unbuilt; it is built from the tile values on the card, as the first
   launch would (timed, counted as one build), and held against the packed
   CSR matrix; its bytes and nonzeros are printed. K6 walks that index: it
   transposes x to [V, N] by hand and gathers, for each output lane, the x
   rows of its nonzeros, each value read from the tiles at its offset. K6 in
   modes single, pair and chain on both packs at N = 160 and 96 (B·T·c1 of
   the two ST blocks at batch 1), random operands, held against its plain
   version as in phase 3, repeat bit-identical; timed beside its bound
   (the nonzeros as CSR and the operands over 3.35 TB/s against the
   nonzeros' FLOPs over 67 TFLOP/s; what the kernel moves, the index, a
   32-byte sector a value, the workspace passes and the operands, is
   printed too) and
   ``torch.sparse.mm`` on the CSR GSO. Then the f32 pack is freed.
16. ell_1m — the 1M route end to end on the int8 ELL operator at batch 1,
   Lion lr 1e-3, weight decay 1e-3, as phase 12 with K6 for K5: one forecast
   batch fused against unfused (launches K1/K2 ×2, K3, K4, K6 pair ×2),
   every K1-K4 call of one training step against its plain version, fused
   against unfused gradients, a fused ``Trainer.fit(1)`` (8 steps; launches
   per step those of phase 6 plus K6 pair ×2 and chain ×2) and ``test()``,
   the fit's peak memory apart from the checks'. Cuts: f32 (the JAX bench ran
   bf16), no remat, Lion's momentum in f32, the series cut to 55 steps split
   23 / 16 / 16 (8 training windows, one validation and one test window).
17. kernels_bcsr — the int8 ELL pack freed, the same 1M graph, GSO and RCM
   order through ``make_graph_op(kind="auto")``: a BCSR operator, one pack
   of 256 × 256 row-major f32 tiles for both directions, scattered on the
   card (timed), and its nonzero index built and checked as in phase 15.
   K10 walks the index, a warp per output row gathering the x rows of its
   nonzeros (the row walk K6 shares, ``csrc/csr_rows.cuh``). K10 at N =
   160 and 96, scale 1 and 2 (its alpha), and K11 at the same widths,
   random operands, held against their plain versions as in phase 3 (K11 a
   chunk of block rows at a time), repeat bit-identical; timed beside their
   bounds (K10: the nonzeros as CSR and the operands, as K6; K11: every
   entry of the live tiles, g and x read
   once, the live tiles written once) and their library calls
   (``torch.sparse.mm`` on the CSR GSO; one ``torch.bmm`` over the live
   tiles' operands, gathered outside the timing).
18. bcsr_1m — the unfused route of ``auto`` end to end at batch 1 with Lion
   (the cuts of phase 16): one forecast batch through K10 (launches K10 ×4)
   against the same weights on the f32 ELL operator (K6) within 2e-4 +
   2e-4·|ref|; every K10 call of one unfused training step (×8) against its
   plain version; one backward with the tile values requiring grad, K11
   launched through autograd and held against its plain version; an
   unfused ``Trainer.fit(1)`` with finite losses and launches per step K10
   ×8 and K11 ×0 (validation: K10 ×4 a batch), then ``test()``, rebuilding
   no nonzero index (so phase 16's fit); the fit's peak memory apart from
   the checks'.
19. bcsr_1m_bf16 — the same route with ``--compute_dtype bfloat16 --remat
   True``: ``STGCN(dtype=bfloat16, remat=True)`` over the f32 tiles (a bf16
   operand): one step's K10 calls recorded (×8, bf16), a ``Trainer.fit(1)``
   with launches per step K10 bf16 ×8 and nothing else, finite losses,
   within rtol 0.08 of phase 18's, step seconds and peak memory beside
   phase 18's, ``test()``, a step traced; the same without remat (its peak
   the higher); then
   ``kernels_bf16`` (part ``k10_1m``): K10's bf16 variant at each recorded
   call over the f32 tiles and over a bf16 pack (``bcsr_graph_op(dtype=
   bfloat16)``, built on the card beside the f32 one, timed, its index
   checked as in phase 17) against its plain version in bf16 (2 ulps plus
   the floor), repeat bit-identical, timed beside its bound and
   ``torch.sparse.mm`` on the bf16 CSR GSO where it takes bf16; last, on
   the same operator, one forecast batch of the bf16 model through
   ``fused_sparse_forward`` (K1f-K4f bf16 around ``bcsr_spmm_bf16`` ×2 a
   block) held to the float32 fused forecast and to the unfused bf16
   model's within atol 0.1, rtol 0.05 (``fused_forecast`` in its line), and
   three fused training steps (Lion, batch 1) in bf16 and in float32 from
   the same weights (``fused_steps`` in its line): losses within rtol 0.08,
   launches per step K1-K4 and K1b-K4b bf16 and ``bcsr_spmm_bf16`` ×8, step
   seconds and peak memory.
20. cli     — ``stgcn_tpu_torch.cli.main`` in-process on PeMSD7(M) with
   ``--graph_op banded --fused True --epochs 1`` (a one-block-row pack),
   then with ``--graph_op ell_int8``, then ``bcsr`` (the fused forward's vn
   branch), then unfused on ``banded`` (K9) and ``banded_int8`` (K9 int8),
   then ``banded_int8 --fused True`` (K5 int8), then unfused ``banded
   --compute_dtype bfloat16 --remat True`` (K9 bf16), ``banded_int8
   --compute_dtype bfloat16`` (K9 int8 bf16) and ``auto --compute_dtype
   bfloat16`` (dense: no kernel may launch), then ``dense --fused True
   --compute_dtype bfloat16`` (K1-K4 and K1b-K4b bf16, none in float32):
   its epoch and test lines, every kernel of the step (K5, K6 or K9 pair
   and chain, or K10, included) launched, and none of K1-K4 unfused.
21. the ``{"kernels": [...]}`` line (every kernel's per-step times on the
   training paths, PeMSD7(M), 100k and 1M, and its launches; the bf16
   K1f-K4f rows per PeMSD7(M) forecast batch, their launches from phase
   8a's test split, the 100k and 1M shapes and the float32 kernel beside), the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

A failed check raises: the script then exits non-zero and prints no
``"ok"`` line. Without a CUDA device it exits 2 before doing anything.
"""

from __future__ import annotations

import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, NamedTuple

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
KERNEL_TOL = 1e-4           # f32 kernel vs plain version, rel and abs (see max_err)
SLICE_TOL = 2e-4            # fused vs unfused forward (tests/test_vertex_fused.py:49)
GRAD_REL_L2, GRAD_ATOL, GRAD_RTOL = 1e-4, 2e-4, 2e-3   # tests/test_vertex_fused.py:52-74
LOSS_TOL = 1e-4             # fused vs unfused step losses, abs and rel
BATCH = 32
DROPRATE = 0.5
N_HIS, N_PRED = 12, 3


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
    """A wrapper's outputs as a list, without the None entries (a head
    without LayerNorm input has no LN gradients)."""
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [o for o in outs if o is not None]


def outside_bound(torch, got, ref) -> tuple[float, list, list]:
    """max |Δ| over all outputs, each output's max |ref|, and per output the
    mask of elements outside KERNEL_TOL·(min(1, max |ref|) + |ref|).

    The floor scales with an output whose entries are all below 1: a real
    training step's data gradients are about 1e-5 (dL/dpred of a mean over
    32×228 outputs is about 2e-4 per element), and under a fixed floor of
    1e-4 a zero or doubled one would pass. The bound is nowhere looser than
    KERNEL_TOL·(1 + |ref|)."""
    worst, ref_max, masks = 0.0, [], []
    got, ref = flat(got), flat(ref)
    if len(got) != len(ref):
        raise AssertionError(f"kernel gives {len(got)} outputs, its plain version {len(ref)}")
    for g, r in zip(got, ref):
        g, r = g.detach(), r.detach()
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"kernel output shape {tuple(g.shape)} vs {tuple(r.shape)} "
                                 "or non-finite values")
        d = (g - r).abs()
        worst = max(worst, float(d.max()))
        ref_max.append(float(r.abs().max()))
        masks.append(d > KERNEL_TOL * min(1.0, ref_max[-1]) + KERNEL_TOL * r.abs())
    return worst, ref_max, masks


def max_err(got, ref) -> tuple[float, list]:
    """max |Δ| and each output's max |ref|; raises if any element of any
    output lies outside the bound of ``outside_bound``."""
    import torch

    worst, ref_max, masks = outside_bound(torch, got, ref)
    for i, m in enumerate(masks):
        if m.any():
            raise AssertionError(f"kernel disagrees with its plain version in output {i}: "
                                 f"{int(m.sum())} of {m.numel()} elements outside the bound "
                                 f"(max |Δ| {worst:.3e}, max |ref| {ref_max[i]:.3e})")
    return worst, ref_max


RELU_BWD = ("tail_bwd", "ofc_bwd")   # backward kernels whose function has a ReLU
MAX_UNITS_PER_LANE = 3


def relu_input(torch, name: str, args, wide: bool = False):
    """For K2b / K4b: the input z of the function's ReLU as the plain version
    computes it, or with ``wide`` in float64 beside the sum of its terms'
    magnitudes (z's rounding scale) and the count of terms an f32 evaluation
    of z sums."""
    from stgcn_tpu_torch.kernels import output_head as oh
    from stgcn_tpu_torch.kernels import vertex_fused as vf

    def d(t):
        return t.detach().double() if wide else t.detach()

    if name == "tail_bwd":
        cfg = args[0]
        terms, w = list(args[2:4])[: cfg.n_terms], args[4:8]
        z = vf.tail_preact(cfg, d(args[1]), [d(t) for t in terms], [d(t) for t in w])
        if not wide:
            return z
        mag = vf.tail_preact(cfg, d(args[1]).abs(), [d(t).abs() for t in terms],
                             [d(t).abs() for t in w])
        n_cterms = len(terms) + (cfg.graph_conv_type == "cheb_graph_conv")
        return z, mag, n_cterms * cfg.c1 + 2
    cfg, a, mu, rstd, lnw, lnb, w1, b1 = args[:8]
    z = oh.ofc_preact(*(d(t) for t in (a, mu, rstd, lnw, lnb, w1, b1)))
    if not wide:
        return z
    mag = oh.ofc_preact((d(a) - d(mu)).abs(), torch.zeros_like(d(mu)), d(rstd), d(lnw).abs(),
                        d(lnb).abs(), d(w1).abs(), d(b1).abs())
    return z, mag, cfg.c0 + 1


def relu_checked(torch, name: str, args, kwargs, got) -> tuple[float, list, dict]:
    """``max_err`` for K2b / K4b, whose functions have a ReLU, holding the
    plain version to the kernel's ReLU decisions where rounding leaves them
    open, and nowhere else.

    The kernel recomputes the ReLU input z = Σ terms in another order than
    the plain version; where |z| is within rounding of 0 the two may take
    different branches, and every element fed by that unit then differs by
    its term (1e8 such inputs at the 100k shapes). Any f32 order of a sum
    of n terms lies within γ = (n + 8)·2⁻²³ · Σ|terms| of the exact value (the
    +8 covers the LayerNorm rounding of K4b's input; the factor 2 over the
    textbook n·2⁻²⁴ is margin), so a unit is open only if |z| <= γ in
    float64. Where the kernel's data gradients fall outside the bound, each
    such lane (b, t, v) must hold an open unit (at most MAX_UNITS_PER_LANE);
    the plain version is run again with those units' branches flipped, one
    subset a lane by trial, and must then agree with the kernel elementwise
    in every output, the weight gradients included. Returns max |Δ|, each
    output's max |ref| and what was flipped."""
    def plain(mask=None):
        return flat(plain_of(name, args, kwargs, relu_mask=mask)())

    worst, ref_max, masks = outside_bound(torch, got, plain())
    if not any(bool(m.any()) for m in masks):
        return worst, ref_max, {"flipped_units": 0}
    z, mag, n_terms = relu_input(torch, name, args, wide=True)
    open_units = z.abs() <= (n_terms + 8) * 2.0 ** -23 * mag
    lane_shape = (z.shape[0], z.shape[1], z.shape[3])
    data = [i for i, g in enumerate(flat(got))
            if g.dim() == 4 and (g.shape[0], g.shape[1], g.shape[3]) == lane_shape]

    def bad_lanes(ms):   # lanes (b, t, v) where a data gradient is outside the bound
        return torch.stack([ms[i].any(2) for i in data]).any(0)

    lanes = bad_lanes(masks)
    if not bool(lanes.any()):
        raise AssertionError("elements outside the bound only in the weight gradients")
    if bool((lanes & ~open_units.any(2)).any()):
        raise AssertionError(f"{int((lanes & ~open_units.any(2)).sum())} lanes outside the "
                             "bound hold no ReLU input within rounding of 0")
    units = (open_units & lanes[:, :, None, :]).nonzero().tolist()   # (b, t, g, v), by lane
    by_lane: dict = {}
    for b, t, g, v in units:
        by_lane.setdefault((b, t, v), []).append(g)
    most = max(len(gs) for gs in by_lane.values())
    if most > MAX_UNITS_PER_LANE:
        raise AssertionError(f"a lane outside the bound holds {most} open ReLU inputs, more "
                             f"than {MAX_UNITS_PER_LANE}")
    base = (relu_input(torch, name, args) > 0).to(torch.float32)   # the plain version's own
    chosen: dict = {}
    for r in range(1, 2 ** most):
        mask = base.clone()
        for (b, t, v), gs in by_lane.items():
            for j, g in enumerate(gs):
                if r >> j & 1:
                    mask[b, t, g, v] = 1.0 - mask[b, t, g, v]
        still = bad_lanes(outside_bound(torch, got, plain(mask))[2])
        for lane in by_lane:
            if lane not in chosen and not bool(still[lane]):
                chosen[lane] = r
        if len(chosen) == len(by_lane):
            break
    if len(chosen) != len(by_lane):
        raise AssertionError(f"{len(by_lane) - len(chosen)} lanes outside the bound agree "
                             "under no choice of their open ReLU branches")
    mask, flipped = base.clone(), []
    for (b, t, v), gs in by_lane.items():
        for j, g in enumerate(gs):
            if chosen[(b, t, v)] >> j & 1:
                mask[b, t, g, v] = 1.0 - mask[b, t, g, v]
                flipped.append(float(z[b, t, g, v].abs() / mag[b, t, g, v]))
    worst, ref_max = max_err(got, plain(mask))
    return worst, ref_max, {"flipped_units": len(flipped), "lanes": len(by_lane),
                            "open_units_in_those_lanes": len(units),
                            "open_units": int(open_units.sum()),
                            "flipped_max_z_over_mag": max(flipped),
                            "open_bound_over_mag": (n_terms + 8) * 2.0 ** -23}


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
        cases.append(("head_fwd", f"block{blk}", vf.head_fwd,
                      lambda cfg=cfg, x=x, ln=(mu, rstd, lng, lnb), w=w1:
                      vf.head_reference(cfg, x, ln if cfg.apply_ln else None, w),
                      head_args, flops_of("head_fwd", cfg, b)))
        xg, t1_, t2_ = (rnd(b, cfg.t1, 16, vp) for _ in range(3))
        w2 = (rnd(3, 16, 16, scale=16 ** -1), rnd(16, scale=0.1),
              rnd(3, 16, 128, scale=48 ** -0.5), rnd(128, scale=0.1))
        cases.append(("tail_fwd", f"block{blk}", vf.tail_fwd,
                      lambda cfg=cfg, a=(xg, [t1_, t2_]), w=w2: vf.tail_reference(cfg, *a, w),
                      (cfg, xg, t1_, t2_, *w2), flops_of("tail_fwd", cfg, b)))
    for act in ("glu", "gtu"):   # the forecast path's gate, and gtu's code path
        label = "head" if act == "glu" else "head-gtu"
        ocfg = oh.OutHeadCfg(ko=4, c_in=64, c0=128, c1=128, c_end=1, act_func=act,
                             v_true=v_true, v_pad=vp)
        x = rnd(b, 4, 64, vp)
        mu, rstd = stats(4)
        lng, lnb = affine(64)
        ck, cb = rnd(4, 64, 256, scale=256 ** -0.5), rnd(256, scale=0.1)
        args = (ocfg, x, mu, rstd, lng, lnb, ck, cb)
        cases.append(("ohead_fwd", label, oh.ohead_fwd, lambda a=args: oh.ohead_reference(*a),
                      args, flops_of("ohead_fwd", ocfg, b)))
        a = rnd(b, 1, 128, vp)
        mu2, rstd2 = rnd(b, 1, 1, 1, scale=0.1), 0.5 + torch.rand((b, 1, 1, 1), generator=gen,
                                                                  device=dev)
        lnw, lnb2 = affine(128)
        w = (rnd(128, 128, scale=128 ** -0.5), rnd(128, scale=0.1),
             rnd(128, 1, scale=128 ** -0.5), rnd(1, scale=0.1))
        args = (ocfg, a, mu2, rstd2, lnw, lnb2, *w)
        cases.append(("ofc_fwd", label, oh.ofc_fwd, lambda a=args: oh.ofc_reference(*a),
                      args, flops_of("ofc_fwd", ocfg, b)))
    return cases


def flops_of(name: str, cfg, b: int) -> int:
    """Contraction FLOPs of one call at batch ``b``; a backward counts 3× its
    forward, as the JAX cost estimates do (vertex_fused.py:713, :913)."""
    fwd = name.replace("_bwd", "_fwd")
    if fwd == "head_fwd":
        n = 2 * b * cfg.t1 * cfg.v_pad * (cfg.kt * cfg.c_in * cfg.g1 + cfg.c0 * cfg.c1)
    elif fwd == "tail_fwd":
        n_c = cfg.n_terms + (cfg.graph_conv_type == "cheb_graph_conv")
        n = 2 * b * cfg.v_pad * (cfg.t1 * n_c * cfg.c1 * cfg.c1 + cfg.t2 * cfg.kt * cfg.c1 * cfg.g2)
    elif fwd == "ohead_fwd":
        n = 2 * b * cfg.v_pad * cfg.ko * cfg.c_in * cfg.g
    else:
        n = 2 * b * cfg.v_pad * (cfg.c0 * cfg.c1 + cfg.c1 * cfg.c_end)
    return n * (3 if name.endswith("_bwd") else 1)


def io_bytes(args, out) -> int:
    import torch

    ts = [t for t in [*args, *flat(out)] if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in ts)


KERNEL_META = {
    "head_fwd": ("K1f", "stgcn_tpu_torch/kernels/csrc/gate_gemm.cu",
                 "stgcn_tpu/kernels/vertex_fused.py:610", "_head_pallas"),
    "tail_fwd": ("K2f", "stgcn_tpu_torch/kernels/csrc/vertex_fused.cu",
                 "stgcn_tpu/kernels/vertex_fused.py:839", "_tail_pallas"),
    "ohead_fwd": ("K3f", "stgcn_tpu_torch/kernels/csrc/gate_gemm.cu",
                  "stgcn_tpu/kernels/output_head.py:214", "_ohead_pallas"),
    "ofc_fwd": ("K4f", "stgcn_tpu_torch/kernels/csrc/gate_gemm.cu",
                "stgcn_tpu/kernels/output_head.py:407", "_ofc_pallas"),
    "head_bwd": ("K1b", "stgcn_tpu_torch/kernels/csrc/vertex_fused_bwd.cu",
                 "stgcn_tpu/kernels/vertex_fused.py:654", "_head_pallas_bwd"),
    "tail_bwd": ("K2b", "stgcn_tpu_torch/kernels/csrc/vertex_fused_bwd.cu",
                 "stgcn_tpu/kernels/vertex_fused.py:883", "_tail_pallas_bwd"),
    "ohead_bwd": ("K3b", "stgcn_tpu_torch/kernels/csrc/output_head_bwd.cu",
                  "stgcn_tpu/kernels/output_head.py:253", "_ohead_pallas_bwd"),
    "ofc_bwd": ("K4b", "stgcn_tpu_torch/kernels/csrc/output_head_bwd.cu",
                "stgcn_tpu/kernels/output_head.py:440", "_ofc_pallas_bwd"),
}
FWD_NAMES = ("head_fwd", "tail_fwd", "ohead_fwd", "ofc_fwd")
PER_BATCH_FWD = {"head_fwd": 2, "tail_fwd": 2, "ohead_fwd": 1, "ofc_fwd": 1}
PER_STEP = {**PER_BATCH_FWD, "head_bwd": 2, "tail_bwd": 2, "ohead_bwd": 1, "ofc_bwd": 1}
NV_MODES = ("nv_single", "nv_pair", "nv_chain")


def expected(per: dict, n: int, *more: tuple[dict, int]) -> dict:
    """Launch counts over every kernel name: ``per`` times ``n`` (plus each
    further (per, n) pair), zero for a kernel not in them."""
    from stgcn_tpu_torch.kernels import WRAPPERS

    pairs = [(per, n), *more]
    return {k: sum(p.get(k, 0) * m for p, m in pairs) for k in WRAPPERS}


def timed_fit(torch, tr, phase: str) -> tuple[list, list, list, dict]:
    """``tr.fit(1)`` with every step's loss (finite, or it raises) and
    seconds, its history and the launches of the fit (counted from 0)."""
    from stgcn_tpu_torch import kernels

    step_losses, step_seconds = [], []
    real_step = tr.train_step

    def timed_step(*a):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = real_step(*a)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t1)
        step_losses.append(loss)
        return loss

    tr.train_step = timed_step
    kernels.reset_launch_counts()
    hist = tr.fit(1)["history"]
    launches = kernels.launch_counts()
    losses = [float(v_) for v_ in step_losses]
    if not all(v_ == v_ and abs(v_) < float("inf") for v_ in losses):
        raise AssertionError(f"{phase}: non-finite step losses {losses}")
    return losses, step_seconds, hist, launches


def check_and_time(torch, name, label, wrapper, plain, args, kwargs, flops, *,
                   reps: int = 30) -> dict:
    """Hold one kernel call against its plain version (tolerance, repeat
    bit-identical, launch counter; K2b / K4b through ``relu_checked``) and
    time both (medians of ``reps``)."""
    from stgcn_tpu_torch.kernels import launch_counts

    before = launch_counts()[name]
    out1 = wrapper(*args, **kwargs)
    out2 = wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    moved = launch_counts()[name] - before
    if moved != 2:
        raise AssertionError(f"{name}: launch counter moved {moved}, expected 2")
    if not all(torch.equal(p, q) for p, q in zip(flat(out1), flat(out2))):
        raise AssertionError(f"{name} [{label}]: a repeat launch is not bit-identical")
    relu = None
    try:
        if name in RELU_BWD:
            err, ref_max, relu = relu_checked(torch, name, args, kwargs, out1)
        else:
            err, ref_max = max_err(out1, plain())
    except AssertionError as e:
        raise AssertionError(f"{name} [{label}]: {e}") from None
    warmup = min(5, reps)
    ms = cuda_ms(lambda: wrapper(*args, **kwargs), warmup=warmup, reps=reps)
    plain_ms = cuda_ms(plain, warmup=warmup, reps=reps)
    nbytes = io_bytes(args, out1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"shape": label, "input": list(args[1].shape), "output": list(flat(out1)[0].shape),
            "dropout": kwargs.get("drop") is not None, "max_abs_err": err, "ref_max": ref_max,
            **({"relu": relu} if relu else {}),
            "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernels(torch) -> dict:
    """Phase 3: per kernel name, the per-shape measurements."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels

    results: dict[str, list] = {name: [] for name in FWD_NAMES}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, label, wrapper, plain, args, flops in kernel_cases(gen):
        results[name].append(check_and_time(torch, name, label, wrapper, plain, args, {}, flops))
    kernels.reset_launch_counts()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, "tolerance": KERNEL_TOL,
          "results": results})
    return results


def load_pemsd7(torch) -> dict:
    """PeMSD7(M) splits on the card, its dense Chebyshev GSO and the scaler."""
    from stgcn_tpu_torch.data import (ForecastDataset, ZScoreScaler, chrono_split, load_adj,
                                      load_vel)
    from stgcn_tpu_torch.graph import build_gso
    from stgcn_tpu_torch.ops import make_graph_op

    data_root = str(ROOT / "data")
    adj, n_vertex = load_adj("pemsd7-m", data_root)
    train, val, test = chrono_split(load_vel("pemsd7-m", data_root))
    scaler = ZScoreScaler().fit(train)

    def ds(a):
        return ForecastDataset.from_numpy(scaler.transform(a), N_HIS, N_PRED, device="cuda")

    return {"n_vertex": n_vertex, "train": ds(train), "val": ds(val), "test": ds(test),
            "scaler": scaler,
            "gop": make_graph_op(build_gso(adj, "sym_norm_lap", cheb=True), "auto",
                                 device="cuda")}


def new_model(torch, n_vertex: int, droprate: float, gct: str = "cheb_graph_conv", **kw):
    """The main.py model at full width, weights from seed 42 (``kw``: the
    model's ``dtype`` and ``remat``)."""
    from stgcn_tpu_torch.nn import STGCN

    return STGCN(N_HIS, n_vertex, kt=3, ks=3, act_func="glu", graph_conv_type=gct,
                 droprate=droprate, device="cuda",
                 generator=torch.Generator().manual_seed(42), **kw)


def record_training_step(torch, data, batch: int = BATCH) -> list:
    """Run one fused training step (forward with dropout, backward) on the
    first training batch of ``data`` and record every kernel call of K1-K4
    it makes: (wrapper name, label, args, kwargs), in call order."""
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels import output_head as oh
    from stgcn_tpu_torch.kernels import vertex_fused as vf
    from stgcn_tpu_torch.kernels.dropout import step_seed
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.train import masked_mse

    calls: list = []
    mods = {"head_fwd": vf, "tail_fwd": vf, "head_bwd": vf, "tail_bwd": vf,
            "ohead_fwd": oh, "ofc_fwd": oh, "ohead_bwd": oh, "ofc_bwd": oh}
    real = {name: getattr(mod, name) for name, mod in mods.items()}

    def recorder(name):
        def call(*args, **kwargs):
            n = sum(c[0] == name for c in calls)
            calls.append((name, f"call{n}", args, kwargs))
            return real[name](*args, **kwargs)
        return call

    model = new_model(torch, data["n_vertex"], DROPRATE)
    params = dict(model.named_parameters())
    starts, n_valid = next(data["train"].batches(batch))
    x, y = gather_windows(data["train"].series, starts, N_HIS, N_PRED)
    try:
        for name, mod in mods.items():
            setattr(mod, name, recorder(name))
        pred = fused_sparse_forward(params, x, data["gop"], model, deterministic=False,
                                    seed=step_seed(42, 0))
        loss = masked_mse(pred.reshape(batch, -1), y, n_valid)
        torch.autograd.grad(loss, list(params.values()))
    finally:
        for name, mod in mods.items():
            setattr(mod, name, real[name])
    torch.cuda.synchronize()
    return calls


def plain_of(name: str, args, kwargs, relu_mask=None):
    """The plain version of one recorded kernel call (K2b / K4b with the
    ReLU decisions ``relu_mask`` when given)."""
    from stgcn_tpu_torch.kernels import output_head as oh
    from stgcn_tpu_torch.kernels import vertex_fused as vf

    drop = kwargs.get("drop")
    cfg = args[0]
    if name == "head_fwd":
        ln = args[2:6] if cfg.apply_ln else None
        return lambda: vf.head_reference(cfg, args[1], ln, args[6:10], drop)
    if name == "head_bwd":
        ln = args[2:6] if cfg.apply_ln else None
        return lambda: vf.head_bwd_reference(cfg, args[1], ln, args[6:10], args[10], drop)
    if name == "tail_fwd":
        terms = list(args[2:4])[: cfg.n_terms]
        return lambda: vf.tail_reference(cfg, args[1], terms, args[4:8])
    if name == "tail_bwd":
        terms = list(args[2:4])[: cfg.n_terms]

        def tail_plain():
            dxg, dterms, *dw = vf.tail_bwd_reference(cfg, args[1], terms, args[4:8], *args[8:11],
                                                     relu_mask)
            pad = [args[1].new_zeros(args[1].shape)] * (2 - len(dterms))
            return (dxg, *dterms, *pad, *dw)
        return tail_plain
    if name == "ohead_fwd":
        return lambda: oh.ohead_reference(*args, drop=drop)
    if name == "ohead_bwd":
        return lambda: oh.ohead_bwd_reference(*args, drop=drop)
    if name == "ofc_fwd":
        return lambda: oh.ofc_reference(*args, drop=drop)
    return lambda: oh.ofc_bwd_reference(*args, drop=drop, relu_mask=relu_mask)


def check_recorded(torch, calls, reps: int = 30) -> dict:
    """Each recorded kernel call of one training step held against its plain
    version and timed; the calls must be those of PER_STEP."""
    from stgcn_tpu_torch import kernels

    counts = {name: sum(c[0] == name for c in calls) for name in PER_STEP}
    if counts != PER_STEP:
        raise AssertionError(f"one training step made kernel calls {counts}, expected {PER_STEP}")
    results: dict[str, list] = {name: [] for name in PER_STEP}
    failed = []   # every call is checked before the phase fails, so one run shows them all
    for name, label, args, kwargs in calls:
        flops = flops_of(name, args[0], args[1].shape[0])
        try:
            results[name].append(check_and_time(
                torch, name, label, kernels.WRAPPERS[name], plain_of(name, args, kwargs), args,
                kwargs, flops, reps=reps))
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError("; ".join(failed))
    return results


def phase_kernels_bwd(torch, data) -> dict:
    """Phase 4: every kernel call of one training step, recorded on real data,
    held against its plain version and timed; the masks read back."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels.dropout import Drop, step_seed
    from stgcn_tpu_torch.kernels.probes import mask_probes

    results = check_recorded(torch, record_training_step(torch, data))

    # the forward kernels' masks, read back through identity weights
    masks = {}
    v_true, v_pad = data["n_vertex"], data["gop"].v_pad
    for site in range(3):
        drop = Drop(DROPRATE, step_seed(42, 7), site)
        for name, (got, plain) in mask_probes(drop, BATCH, 8, v_true, v_pad, "cuda").items():
            if not torch.equal(got, plain):
                raise AssertionError(f"{name}: the kernel's dropout mask differs from the plain "
                                     f"mask in {int((got != plain).sum())} elements")
            live = got[..., :v_true]
            n = live.numel()
            keep = float((live > 0).float().mean())
            sigma = (DROPRATE * (1 - DROPRATE) / n) ** 0.5
            if abs(keep - (1 - DROPRATE)) > 4 * sigma:
                raise AssertionError(f"{name}: keep rate {keep} is more than 4σ from "
                                     f"{1 - DROPRATE} over {n} elements")
            masks.setdefault(name, []).append({"site": site, "elements": n, "keep_rate": keep,
                                               "four_sigma": 4 * sigma, "bit_identical": True})
    kernels.reset_launch_counts()
    emit({"phase": "kernels_bwd", "seconds": time.perf_counter() - t0, "tolerance": KERNEL_TOL,
          "results": results, "masks": masks})
    return results


def phase_slice(torch, data) -> dict:
    """Phase 5: the whole PeMSD7(M) test split through the fused and the
    unfused forward."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.train import evaluate_metrics

    test_ds, scaler, gop, n_vertex = data["test"], data["scaler"], data["gop"], data["n_vertex"]
    model = new_model(torch, n_vertex, DROPRATE).eval()
    params = model.state_dict()
    setup_s = time.perf_counter() - t0

    preds: dict[str, list] = {"fused": [], "unfused": []}

    def predictor(kind):
        def predict(starts):
            x, y = gather_windows(test_ds.series, starts, N_HIS, N_PRED)
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

    want = expected(PER_BATCH_FWD, n_batches)
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


def phase_train(torch, data) -> dict:
    """Phase 6: fused training against unfused, then a fused fit and test."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels.dropout import step_seed
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.train import TrainConfig, Trainer, masked_mse

    n_vertex, gop = data["n_vertex"], data["gop"]
    ckpt_root = ROOT / "checkpoints" / "chip_smoke"   # git-ignored, removed at the end
    shutil.rmtree(ckpt_root, ignore_errors=True)

    # 1. one batch: loss and gradients, fused against unfused, same masks
    model = new_model(torch, n_vertex, DROPRATE)
    params = dict(model.named_parameters())
    names = list(params)
    starts, n_valid = next(data["train"].batches(BATCH))
    x, y = gather_windows(data["train"].series, starts, N_HIS, N_PRED)
    seed = step_seed(42, 0)

    def loss_grads(fused):
        pred = (fused_sparse_forward(params, x, gop, model, deterministic=False, seed=seed)
                if fused else model(x, gop, deterministic=False, seed=seed))
        loss = masked_mse(pred.reshape(BATCH, -1), y, n_valid)
        return loss, torch.autograd.grad(loss, [params[k] for k in names])

    lf, gf = loss_grads(True)
    lu, gu = loss_grads(False)
    ff, fu = torch.cat([g.flatten() for g in gf]), torch.cat([g.flatten() for g in gu])
    rel = float((ff - fu).norm() / (fu.norm() + 1e-12))
    worst = max(float(((a - b).abs() - GRAD_RTOL * b.abs()).max()) for a, b in zip(gf, gu))
    if not rel < GRAD_REL_L2 or worst > GRAD_ATOL:
        raise AssertionError(f"fused gradients off the unfused ones: relative L2 {rel:.3e}, "
                             f"worst excess over the rtol {worst:.3e}")
    one_batch = {"loss_fused": float(lf), "loss_unfused": float(lu), "grad_rel_l2": rel,
                 "grad_max_abs_diff": float((ff - fu).abs().max())}

    def trainer(fused, tag, state=None):
        m = new_model(torch, n_vertex, DROPRATE)
        if state is not None:
            m.load_state_dict(state)
        cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=DROPRATE, batch_size=BATCH,
                          fused=fused, ckpt_dir=str(ckpt_root / tag), dataset_name="pemsd7-m")
        return Trainer(cfg, m, gop, data["train"], data["val"], data["test"], data["scaler"],
                       device="cuda")

    # 2. the first 20 step losses, fused and unfused, from the same weights
    state = {k: v.clone() for k, v in new_model(torch, n_vertex, DROPRATE).state_dict().items()}
    steps = {}
    for fused in (True, False):
        tr = trainer(fused, f"steps_{fused}", state)
        batches = list(tr.train_ds.batches(BATCH))[:20]
        steps[fused] = torch.stack([tr.train_step(s, n, i)
                                    for i, (s, n) in enumerate(batches)]).cpu()
    dl = (steps[True] - steps[False]).abs()
    if not bool((dl <= LOSS_TOL + LOSS_TOL * steps[False].abs()).all()):
        raise AssertionError(f"fused and unfused step losses differ: {steps[True].tolist()} vs "
                             f"{steps[False].tolist()}")

    # 3. a fused fit of 3 epochs; the launches of every step counted
    tr = trainer(True, "fused", state)
    kernels.reset_launch_counts()
    hist_f = tr.fit(3)["history"]
    launches = kernels.launch_counts()
    want = expected(PER_STEP, 3 * tr.steps_per_epoch)
    if launches != want:
        raise AssertionError(f"fit launched {launches}, expected {want}")
    kernels.reset_launch_counts()
    tr.validate()
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"validation launched kernels: {kernels.launch_counts()}")
    losses = [h["train_loss"] for h in hist_f]
    if not all(v == v and abs(v) < float("inf") for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"fused train loss not finite and falling: {losses}")
    test_f = tr.test()
    if not all(v == v and abs(v) < float("inf") for v in test_f.values()):
        raise AssertionError(f"non-finite test metrics {test_f}")

    # 4. the unfused route's epochs, after the fused ones
    hist_u = trainer(False, "unfused", state).fit(3)["history"]
    shutil.rmtree(ckpt_root, ignore_errors=True)
    result = {"phase": "train", "seconds": time.perf_counter() - t0, "dataset": "pemsd7-m",
              "batch_size": BATCH, "droprate": DROPRATE, "steps_per_epoch": tr.steps_per_epoch,
              "one_batch": one_batch, "grad_tolerance": [GRAD_REL_L2, GRAD_ATOL, GRAD_RTOL],
              "first_20_losses_fused": steps[True].tolist(),
              "first_20_losses_unfused": steps[False].tolist(),
              "first_20_max_abs_diff": float(dl.max()), "loss_tolerance": LOSS_TOL,
              "train_loss_fused": losses, "val_loss_fused": [h["val_loss"] for h in hist_f],
              "epoch_seconds_fused": [h["epoch_time_s"] for h in hist_f],
              "train_loss_unfused": [h["train_loss"] for h in hist_u],
              "val_loss_unfused": [h["val_loss"] for h in hist_u],
              "epoch_seconds_unfused": [h["epoch_time_s"] for h in hist_u],
              "launches": launches, "test_fused": test_f}
    emit(result)
    return result


# --------------------------------------------------------------------------
# the dense whole-block route: fused_forward over K12f / K12b
# --------------------------------------------------------------------------

K12_META = {"stblock_fwd": ("K12f", "stgcn_tpu_torch/kernels/csrc/fused_stblock.cu",
                            "stgcn_tpu/kernels/fused_stblock.py:590", "_fwd_pallas"),
            "stblock_bwd": ("K12b", "stgcn_tpu_torch/kernels/csrc/fused_stblock_bwd.cu",
                            "stgcn_tpu/kernels/fused_stblock.py:626", "_bwd_pallas")}
PER_BATCH_DENSE = {"stblock_fwd": 2}
PER_STEP_DENSE = {"stblock_fwd": 2, "stblock_bwd": 2}
BATCH_PEMS_BAY = 512            # BASELINE.json configs[2], scripts/bench_fused.py's batch
K12_REPS_PEMS_BAY = 10
RELU_OPEN = 1e-5   # a ReLU decision the kernel takes otherwise: |r| <= this · max |r|
# the generality set: (act, graph conv, Ks) beside the main.py plan's (glu, cheb, 3)
K12_GENERAL = [("gtu", "cheb_graph_conv", 3), ("relu", "cheb_graph_conv", 3),
               ("silu", "cheb_graph_conv", 3), ("glu", "cheb_graph_conv", 2),
               ("glu", "cheb_graph_conv", 4), ("glu", "graph_conv", 1)]


def stblock_flops(cfg, b: int, bwd: bool) -> int:
    """Matmul FLOPs of one K12 call: the JAX cost estimate (`_flops_estimate`,
    stgcn_tpu/kernels/fused_stblock.py:577-587) at the true vertex count over
    the whole batch; the backward counts 3× its forward (:672)."""
    v = cfg.v_true
    n_g = 1 if cfg.graph_conv_type == "graph_conv" else max(cfg.ks - 1, 0)
    f = 2 * b * cfg.t1 * v * (cfg.kt * cfg.c_in * cfg.g1 + cfg.c0 * cfg.c1 + n_g * v * cfg.c1
                              + cfg.n_w * cfg.c1 * cfg.c1)
    f += 2 * b * cfg.t2 * v * cfg.kt * cfg.c1 * cfg.g2
    return f * (3 if bwd else 1)


def load_pems_bay(torch) -> dict:
    """PEMS-BAY (``BASELINE.json`` configs[2]) as ``scripts/bench_fused.py``
    sets it up: the dense Chebyshev GSO of ``data/pems-bay/adj.npz``
    (``sym_norm_lap``) and inputs ``[512, 12, 325, 1]`` from
    ``numpy.random.default_rng(0)``; the target is zero, so the loss is the
    bench's mean square of the forecast."""
    import numpy as np

    from stgcn_tpu_torch.data import load_adj
    from stgcn_tpu_torch.graph import build_gso
    from stgcn_tpu_torch.ops import make_graph_op

    adj, n_vertex = load_adj("pems-bay", str(ROOT / "data"))
    x = np.random.default_rng(0).standard_normal((BATCH_PEMS_BAY, N_HIS, n_vertex, 1))
    return {"n_vertex": n_vertex,
            "gop": make_graph_op(build_gso(adj, "sym_norm_lap", cheb=True), "auto",
                                 device="cuda"),
            "x": torch.from_numpy(x.astype(np.float32)).cuda(),
            "y": torch.zeros((BATCH_PEMS_BAY, n_vertex), device="cuda")}


def record_dense_step(torch, model, x, y, gop, seed: int) -> list:
    """One training step through ``fused_forward`` (dropout on): every K12f /
    K12b call it makes, (wrapper name, label, args, kwargs) in call order."""
    from stgcn_tpu_torch.kernels import fused_stblock as fs
    from stgcn_tpu_torch.nn.fused import fused_forward
    from stgcn_tpu_torch.train import masked_mse

    calls: list = []
    real = {name: getattr(fs, name) for name in K12_META}

    def recorder(name):
        def call(*args, **kwargs):
            n = sum(c[0] == name for c in calls)
            calls.append((name, f"call{n}", args, kwargs))
            return real[name](*args, **kwargs)
        return call

    params = dict(model.named_parameters())
    try:
        for name in real:
            setattr(fs, name, recorder(name))
        pred = fused_forward(params, x, gop, model, deterministic=False, seed=seed)
        loss = masked_mse(pred.reshape(x.shape[0], -1), y, x.shape[0])
        torch.autograd.grad(loss, list(params.values()))
    finally:
        for name in real:
            setattr(fs, name, real[name])
    torch.cuda.synchronize()
    counts = {name: sum(c[0] == name for c in calls) for name in K12_META}
    if counts != PER_STEP_DENSE:
        raise AssertionError(f"one dense training step made K12 calls {counts}, expected "
                             f"{PER_STEP_DENSE}")
    return calls


def check_stblock(torch, name, label, args, kwargs, reps: int) -> dict:
    """One K12f / K12b call held against its plain version and timed
    (``check_and_time``). K12b's plain version takes the kernel's ReLU
    decisions, read back through ``relu_out``: where a ReLU input lies within
    rounding of 0 the kernel's sums and the plain version's may take opposite
    branches, and the backward is not continuous there; every decision that
    differs must have |r| <= RELU_OPEN · max |r| in the plain version."""
    from stgcn_tpu_torch.kernels import fused_stblock as fs

    cfg, x, gso, *rest = args
    w, drop, bwd = rest[:10], kwargs.get("drop"), name == "stblock_bwd"
    relu = None
    if bwd:
        h = torch.empty((x.shape[0], cfg.t1, cfg.v_true, cfg.c1), device=x.device)
        fs.stblock_fwd(cfg, x, gso, *w, drop=drop, relu_out=h)
        r = fs.relu_input(cfg, x.detach(), gso, [t.detach() for t in w])
        flipped = (r > 0) != (h > 0)
        ratio = float(r[flipped].abs().max() / r.abs().max()) if bool(flipped.any()) else 0.0
        if ratio > RELU_OPEN:
            raise AssertionError(f"{name} [{label}]: the kernel takes a ReLU decision of the "
                                 f"plain version's otherwise at |r| = {ratio:.2e} · max |r|")
        mask = (h > 0).float()
        relu = {"flipped_units": int(flipped.sum()), "units": flipped.numel(),
                "flipped_max_r_over_max_r": ratio}
        del h, r, flipped

        def plain():
            return fs.st_block_bwd_reference(cfg, x, gso, w, rest[10], drop, relu_mask=mask)
    else:
        def plain():
            with torch.no_grad():
                return fs.st_block_reference(cfg, x, gso, w, drop)
    out = check_and_time(torch, name, label, getattr(fs, name), plain, args, kwargs,
                         stblock_flops(cfg, x.shape[0], bwd), reps=reps)
    out["v"], out["batch"] = cfg.v_true, x.shape[0]
    if relu:
        out["relu"] = relu
    return out


def check_dense_calls(torch, calls, reps: int) -> dict:
    results: dict[str, list] = {name: [] for name in K12_META}
    failed = []   # every call is checked before the phase fails
    for name, label, args, kwargs in calls:
        try:
            results[name].append(check_stblock(torch, name, label, args, kwargs, reps))
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError("; ".join(failed))
    return results


def stblock_case(torch, gen, gso, act: str, gct: str, ks: int):
    """K12f and K12b calls at the PeMSD7(M) block-0 shape (batch 32, t_in 12,
    c_in 1, the main.py widths) with random weights and dropout on."""
    from stgcn_tpu_torch.kernels import fused_stblock as fs
    from stgcn_tpu_torch.kernels.dropout import Drop, step_seed

    v = gso.shape[0]
    cfg = fs.FusedBlockConfig(kt=3, ks=ks, act_func=act, graph_conv_type=gct,
                              droprate=DROPRATE, v_true=v, t_in=N_HIS, c_in=1, c0=64, c1=16,
                              c2=64, training=True)
    scales = (0.5, 0.1, 64 ** -0.5, 0.1, 16 ** -0.5, 0.1, 48 ** -0.5, 0.1, 0.1, 0.1)
    w = [torch.randn(s, generator=gen, device="cuda") * sc
         for s, sc in zip(cfg.weight_shapes(), scales)]
    w[8] = w[8] + 1.0
    x = torch.randn((BATCH, N_HIS, v, 1), generator=gen, device="cuda")
    drop = Drop(DROPRATE, step_seed(42, 11), 0)
    gy = torch.randn((BATCH, cfg.t2, v, cfg.c2), generator=gen, device="cuda") * 1e-3
    label = f"{act}-{gct}-ks{ks}"
    return [("stblock_fwd", label, (cfg, x, gso, *w), {"drop": drop}),
            ("stblock_bwd", label, (cfg, x, gso, *w, gy), {"drop": drop})]


def trace_stblock(torch, calls) -> tuple[dict, dict]:
    """Each recorded K12f and K12b call traced alone (its launches in order;
    none of a kernel the redesigns retired, ``retired_launches``), and the
    graph products' ``torch.matmul`` yardsticks on random operands,
    ``[B·t1·c1, Vp] × [Vp, Vp]``: at each K12f call's shape (its chain runs
    Ks - 1 of them) and at the first K12b call's (its adjoint chain; K12b's
    "adjoint only"). The matmul runs on the padded Vp; its bound counts the
    true V over which ``graph_mm`` contracts, 2·B·t1·c1·V²."""
    from stgcn_tpu_torch.kernels import fused_stblock as fs
    from stgcn_tpu_torch.kernels._ab import launches, retired_launches

    traced: dict = {name: {} for name in K12_META}
    yard: dict = {"stblock_fwd": [], "stblock_bwd": []}
    for name, label, args, kwargs in calls:
        cfg = args[0]
        ev = launches(torch, lambda: getattr(fs, name)(*args, **kwargs))
        key = f"{label}: t_in {cfg.t_in}, c_in {cfg.c_in}"
        retired = retired_launches(name, ev)
        if retired:
            raise AssertionError(f"{K12_META[name][0]} [{key}] launched a retired kernel: "
                                 f"{retired}")
        traced[name][key] = {"device_ms": sum(e["ms"] for e in ev), "launches": ev}
        if name == "stblock_bwd" and yard[name]:
            continue
        m, vp = args[1].shape[0] * cfg.t1 * cfg.c1, -(-cfg.v_true // 128) * 128
        gen = torch.Generator(device="cuda").manual_seed(4)
        a = torch.randn((m, vp), generator=gen, device="cuda")
        g = torch.randn((vp, vp), generator=gen, device="cuda")
        mm = "true>" if name == "stblock_bwd" else "false>"   # the orientation of its chain
        yard[name].append({"call": key, "shape": [m, vp, vp], "per_call": max(cfg.ks - 1, 1),
                           "matmul_ms": cuda_ms(lambda: torch.matmul(a, g), warmup=2, reps=10),
                           "graph_mm_ms": [e["ms"] for e in ev if "graph_mm_kernel" in e["name"]
                                           and e["name"].endswith(mm)],
                           "bound_ms": 2 * m * cfg.v_true ** 2 / F32_FLOP_PER_S * 1e3})
        del a, g
    return traced, {"chain_only": yard["stblock_fwd"], "adjoint_only": yard["stblock_bwd"][0]}


def phase_kernels_stblock(torch, data, pb) -> dict:
    """Phase 7: every K12f / K12b call of one PeMSD7(M) training step and of one
    PEMS-BAY batch-512 step through ``fused_forward`` (dropout on), and a
    generality set, held against their plain versions and timed."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels.dropout import step_seed

    model = new_model(torch, data["n_vertex"], DROPRATE)
    starts, _ = next(data["train"].batches(BATCH))
    x, y = gather_windows(data["train"].series, starts, N_HIS, N_PRED)
    calls = record_dense_step(torch, model, x, y, data["gop"], step_seed(42, 0))
    results = {"pemsd7": check_dense_calls(torch, calls, reps=30)}
    del calls
    model = new_model(torch, pb["n_vertex"], DROPRATE)
    calls = record_dense_step(torch, model, pb["x"], pb["y"], pb["gop"], step_seed(42, 0))
    results["pems_bay"] = check_dense_calls(torch, calls, reps=K12_REPS_PEMS_BAY)
    results["pems_bay_trace"], yard = trace_stblock(torch, calls)
    results.update(yard)
    del calls, model
    gen = torch.Generator(device="cuda").manual_seed(12)
    general = [c for case in K12_GENERAL
               for c in stblock_case(torch, gen, data["gop"].matrix, *case)]
    results["generality"] = check_dense_calls(torch, general, reps=10)
    kernels.reset_launch_counts()
    torch.cuda.empty_cache()
    emit({"phase": "kernels_stblock", "seconds": time.perf_counter() - t0,
          "tolerance": KERNEL_TOL, "relu_open": RELU_OPEN, "results": results})
    return results


def profile_once(torch, fn, count: tuple = ()) -> dict:
    """``torch.profiler`` over one call of ``fn`` after a warm-up call: the
    device time of every kernel launched, in all and by kernel name (the
    twelve largest), and the launches of each kernel named in ``count``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the kernels themselves: a CPU op's entry repeats its kernels' device time
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    base = [(e.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
             .split("::")[-1], e.count) for e in ev]
    return {"device_ms": sum(e.self_device_time_total for e in ev) / 1e3,
            "top": [{"name": e.key[:100], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                    for e in top],
            "launches_of": {k: sum(n for b, n in base if b == k) for k in count}}


def trace_backward(torch, data, calls, batch: int, phase: str) -> dict:
    """One fused training step's backward traced by ``torch.profiler`` (its
    kernels' device time by name); each K1b, K2b, K3b and K4b call of that
    step's recorded calls traced alone (its launches in order,
    ``kernels/_ab.py``'s ``launches``; K4b's must hold no
    retired kernel, ``retired_launches``); and three yardsticks, each one
    ``torch.matmul`` on random operands laid out for it outside the timing:
    K1b block 2's weight gradient dc1k against the product ``[kt·c_in,
    B·t1·Vp] × [B·t1·Vp, g1]`` (K1b's "wgrad only"), K3b's gate pass against
    its recompute ``[B·Vp, ko·c_in] × [ko·c_in, g]`` (K3b's "recompute
    only"), and K4b's fc pass against its fc1 recompute ``[B·Vp, c0] × [c0,
    c1]`` (K4b's "recompute only")."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels._ab import launches, retired_launches
    from stgcn_tpu_torch.kernels.dropout import step_seed
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.train import masked_mse

    model = new_model(torch, data["n_vertex"], DROPRATE)
    params = dict(model.named_parameters())
    starts, n_valid = next(data["train"].batches(batch))
    x, y = gather_windows(data["train"].series, starts, N_HIS, N_PRED)
    pred = fused_sparse_forward(params, x, data["gop"], model, deterministic=False,
                                seed=step_seed(42, 0))
    loss = masked_mse(pred.reshape(batch, -1), y, n_valid)
    step = profile_once(torch, lambda: torch.autograd.grad(loss, list(params.values()),
                                                           retain_graph=True))
    del model, params, pred, loss

    def matmul_ms(m, k, n):
        gen = torch.Generator(device="cuda").manual_seed(3)
        a = torch.randn((m, k), generator=gen, device="cuda")
        d = torch.randn((k, n), generator=gen, device="cuda")
        return cuda_ms(lambda: torch.matmul(a, d), warmup=2, reps=10)

    def pair(ev, key):   # the largest launch whose name holds key, with the one after it
        i = max((j for j, e in enumerate(ev) if key in e["name"]), key=lambda j: ev[j]["ms"])
        return ev[i]["ms"] + (ev[i + 1]["ms"] if i + 1 < len(ev) else 0.0)

    traced: dict = {"head_bwd": {}, "tail_bwd": {}, "ohead_bwd": {}, "ofc_bwd": {}}
    wgrad = recompute = fc_recompute = None
    for name, label, args, kwargs in calls:
        if name not in traced:
            continue
        cfg = args[0]
        ev = launches(torch, lambda: kernels.WRAPPERS[name](*args, **kwargs))
        key = (f"{label}: t_in {cfg.t_in}, c_in {cfg.c_in}" if name in ("head_bwd", "tail_bwd")
               else f"{label}: ko {cfg.ko}, c_in {cfg.c_in}" if name == "ohead_bwd"
               else f"{label}: c0 {cfg.c0}, c1 {cfg.c1}, c_end {cfg.c_end}")
        traced[name][key] = {"device_ms": sum(e["ms"] for e in ev), "launches": ev}
        b = args[1].shape[0]
        if name == "head_bwd" and cfg.apply_ln:   # block 2: its dc1k is the largest wgrad
            n = b * cfg.t1 * cfg.v_pad
            wgrad = {"shape": [cfg.kt * cfg.c_in, n, cfg.g1], "wgrad_ms": pair(ev, "wgrad"),
                     "matmul_ms": matmul_ms(cfg.kt * cfg.c_in, n, cfg.g1),
                     "bound_ms": 2 * cfg.kt * cfg.c_in * n * cfg.g1 / F32_FLOP_PER_S * 1e3}
        if name == "ohead_bwd":
            n, k = b * cfg.v_pad, cfg.ko * cfg.c_in
            gate = [e["ms"] for e in ev if "gate_pass" in e["name"]]
            recompute = {"shape": [n, k, cfg.g], "gate_pass_ms": sum(gate),
                         "matmul_ms": matmul_ms(n, k, cfg.g),
                         "bound_ms": 2 * n * k * cfg.g / F32_FLOP_PER_S * 1e3}
        if name == "ofc_bwd":
            retired = retired_launches(name, ev)
            if retired:
                raise AssertionError(f"K4b [{key}] launched a retired kernel: {retired}")
            n = b * cfg.v_pad
            fc = [e["ms"] for e in ev if "gate_pass" in e["name"]]
            fc_recompute = {"shape": [n, cfg.c0, cfg.c1], "fc_pass_ms": sum(fc),
                            "matmul_ms": matmul_ms(n, cfg.c0, cfg.c1),
                            "bound_ms": 2 * n * cfg.c0 * cfg.c1 / F32_FLOP_PER_S * 1e3}
    kernels.reset_launch_counts()
    torch.cuda.empty_cache()
    result = {"phase": f"{phase}_trace", "seconds": time.perf_counter() - t0,
              "step_backward": step, **traced, "wgrad_only": wgrad,
              "recompute_only": recompute, "fc_recompute_only": fc_recompute}
    emit(result)
    return result


def phase_fused_dense(torch, data, pb) -> dict:
    """Phase 8: the dense whole-block route, ``fused_forward`` over K12f / K12b,
    against the unfused model and ``fused_sparse_forward`` on the same weights:
    the PeMSD7(M) test split, one batch's gradients, 20 AdamW steps, and the
    PEMS-BAY batch-512 forward and step times with their peak memory."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels._ab import RETIRED
    from stgcn_tpu_torch.kernels.dropout import step_seed
    from stgcn_tpu_torch.nn.fused import fused_forward
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.train import evaluate_metrics, masked_mse
    from stgcn_tpu_torch.train.optim import adamw, apply_updates

    test_ds, scaler, gop, n_vertex = data["test"], data["scaler"], data["gop"], data["n_vertex"]
    routes = {"dense": fused_forward, "sparse": fused_sparse_forward,
              "unfused": lambda p, x, g, m, **kw: m(x, g, **kw)}

    # 1. the test split through the three routes
    model = new_model(torch, n_vertex, DROPRATE).eval()
    params = model.state_dict()
    preds: dict[str, list] = {k: [] for k in routes}

    def predictor(kind):
        def predict(starts):
            x, y = gather_windows(test_ds.series, starts, N_HIS, N_PRED)
            pred = routes[kind](params, x, gop, model).reshape(len(starts), -1)
            preds[kind].append(pred)
            return pred, y
        return predict

    with torch.inference_mode():
        starts0, _ = next(test_ds.batches(BATCH))   # warm-up
        for kind in routes:
            predictor(kind)(starts0)
            preds[kind].clear()
        torch.cuda.synchronize()
        n_batches = -(-test_ds.num_windows // BATCH)
        kernels.reset_launch_counts()
        metrics = {"dense": evaluate_metrics(predictor("dense"), test_ds, scaler, BATCH)}
        launches_forecast = kernels.launch_counts()
        for kind in ("unfused", "sparse"):
            metrics[kind] = evaluate_metrics(predictor(kind), test_ds, scaler, BATCH)
        pred = {k: torch.cat(v) for k, v in preds.items()}
        walls: dict[str, list] = {k: [] for k in routes}
        for kind in ("dense", "unfused", "sparse", "sparse", "unfused", "dense"):
            t1 = time.perf_counter()
            evaluate_metrics(predictor(kind), test_ds, scaler, BATCH)
            walls[kind].append(time.perf_counter() - t1)
    want = expected(PER_BATCH_DENSE, n_batches)
    if launches_forecast != want:
        raise AssertionError(f"dense forecast launched {launches_forecast}, expected {want}")
    pd = pred["dense"]
    if pd.shape != (n_batches * BATCH, n_vertex) or not torch.isfinite(pd).all():
        raise AssertionError(f"dense forecast has shape {tuple(pd.shape)} or non-finite values")
    forecast_diff = {}
    for kind in ("unfused", "sparse"):
        d = (pd - pred[kind]).abs()
        forecast_diff[kind] = float(d.max())
        if not bool((d <= SLICE_TOL + SLICE_TOL * pred[kind].abs()).all()):
            raise AssertionError(f"dense and {kind} forecasts differ: max |Δ| "
                                 f"{float(d.max()):.3e}")

    # 2. one batch's gradients, dense against unfused, same masks
    model = new_model(torch, n_vertex, DROPRATE)
    params = dict(model.named_parameters())
    names = list(params)
    starts, n_valid = next(data["train"].batches(BATCH))
    x, y = gather_windows(data["train"].series, starts, N_HIS, N_PRED)
    seed = step_seed(42, 0)

    def loss_grads(kind, m, p, xx, yy, nv, g):
        out = routes[kind](p, xx, g, m, deterministic=False, seed=seed)
        loss = masked_mse(out.reshape(xx.shape[0], -1), yy, nv)
        return loss, torch.autograd.grad(loss, [p[k] for k in names])

    def compare_grads(gf, gu) -> dict:
        ff, fu = torch.cat([g.flatten() for g in gf]), torch.cat([g.flatten() for g in gu])
        rel = float((ff - fu).norm() / (fu.norm() + 1e-12))
        worst = max(float(((a - b).abs() - GRAD_RTOL * b.abs()).max()) for a, b in zip(gf, gu))
        if not rel < GRAD_REL_L2 or worst > GRAD_ATOL:
            raise AssertionError(f"dense gradients off the unfused ones: relative L2 "
                                 f"{rel:.3e}, worst excess over the rtol {worst:.3e}")
        return {"grad_rel_l2": rel, "grad_max_abs_diff": float((ff - fu).abs().max())}

    lf, gf = loss_grads("dense", model, params, x, y, n_valid, gop)
    lu, gu = loss_grads("unfused", model, params, x, y, n_valid, gop)
    one_batch = {"loss_dense": float(lf.detach()), "loss_unfused": float(lu.detach()),
                 **compare_grads(gf, gu)}

    # 3. 20 AdamW steps (lr 1e-3, weight decay 1e-3) from the same weights
    state = {k: v.clone() for k, v in new_model(torch, n_vertex, DROPRATE).state_dict().items()}
    batches = list(data["train"].batches(BATCH))[:20]

    def run_steps(kind):
        m = new_model(torch, n_vertex, DROPRATE)
        m.load_state_dict(state)
        p = dict(m.named_parameters())
        tx = adamw(1e-3, weight_decay=1e-3)
        opt, losses = tx.init(p), []
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i, (s, nv) in enumerate(batches):
            xx, yy = gather_windows(data["train"].series, s, N_HIS, N_PRED)
            out = routes[kind](p, xx, gop, m, deterministic=False, seed=step_seed(42, i))
            loss = masked_mse(out.reshape(BATCH, -1), yy, nv)
            grads = torch.autograd.grad(loss, list(p.values()))
            updates, opt = tx.update(dict(zip(p, grads)), opt, p)
            apply_updates(p, updates)
            losses.append(loss.detach())
        torch.cuda.synchronize()
        return torch.stack(losses).cpu(), kernels.launch_counts(), time.perf_counter() - t1

    ld, launches_steps, sec_d = run_steps("dense")
    lu20, launches_unf, sec_u = run_steps("unfused")
    if launches_steps != expected(PER_STEP_DENSE, len(batches)):
        raise AssertionError(f"20 dense steps launched {launches_steps}")
    if any(launches_unf.values()):
        raise AssertionError(f"the unfused steps launched kernels: {launches_unf}")
    dl = (ld - lu20).abs()
    if not bool(torch.isfinite(ld).all()) or not bool((dl <= LOSS_TOL + LOSS_TOL * lu20.abs())
                                                       .all()):
        raise AssertionError(f"dense and unfused step losses differ: {ld.tolist()} vs "
                             f"{lu20.tolist()}")

    # 4. PEMS-BAY, batch 512: forward and one step of each route, times, peak memory
    pbm = new_model(torch, pb["n_vertex"], DROPRATE)
    pp = dict(pbm.named_parameters())
    with torch.no_grad():
        outs = {k: routes[k](pp, pb["x"], pb["gop"], pbm) for k in routes}
    pb_diff = {}
    for kind in ("unfused", "sparse"):
        d = (outs["dense"] - outs[kind]).abs()
        pb_diff[kind] = float(d.max())
        if not bool((d <= SLICE_TOL + SLICE_TOL * outs[kind].abs()).all()):
            raise AssertionError(f"PEMS-BAY dense and {kind} forward differ: max |Δ| "
                                 f"{float(d.max()):.3e}")
    del outs
    pb_args = (pbm, pp, pb["x"], pb["y"], BATCH_PEMS_BAY, pb["gop"])
    pb_grads = compare_grads(loss_grads("dense", *pb_args)[1],
                             loss_grads("unfused", *pb_args)[1])
    timing, profiles = {}, {}
    tx = adamw(1e-3, weight_decay=1e-3)
    for kind in ("dense", "sparse", "unfused", "unfused", "sparse", "dense"):
        opt = tx.init(pp)

        def forward():
            with torch.no_grad():
                routes[kind](pp, pb["x"], pb["gop"], pbm)

        def step():
            nonlocal opt
            out = routes[kind](pp, pb["x"], pb["gop"], pbm, deterministic=False, seed=seed)
            loss = masked_mse(out.reshape(BATCH_PEMS_BAY, -1), pb["y"], BATCH_PEMS_BAY)
            grads = torch.autograd.grad(loss, list(pp.values()))
            updates, opt = tx.update(dict(zip(pp, grads)), opt, pp)
            apply_updates(pp, updates)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_ms = cuda_ms(forward, warmup=2, reps=K12_REPS_PEMS_BAY)
        step_ms = cuda_ms(step, warmup=2, reps=K12_REPS_PEMS_BAY)
        t = timing.setdefault(kind, {"forward_ms": [], "step_ms": [], "peak_gb": []})
        t["forward_ms"].append(fwd_ms)
        t["step_ms"].append(step_ms)
        t["peak_gb"].append((torch.cuda.max_memory_allocated() - base) / 1e9)
        if kind not in profiles:   # one traced step a route: its kernels' device time
            profiles[kind] = profile_once(torch, step, count=RETIRED)
            profiles[kind]["busy_share_of_step"] = profiles[kind]["device_ms"] / step_ms
            if kind == "dense" and any(profiles[kind]["launches_of"].values()):
                raise AssertionError(f"a dense step launched retired kernels: "
                                     f"{profiles[kind]['launches_of']}")
    del pbm, pp
    torch.cuda.empty_cache()
    result = {"phase": "fused_dense", "seconds": time.perf_counter() - t0,
              "pemsd7": {"n_vertex": n_vertex, "windows": test_ds.num_windows,
                         "batches": n_batches, "batch_size": BATCH,
                         "forecast_max_abs_diff": forecast_diff, "tolerance": SLICE_TOL,
                         "forecast_seconds": {k: statistics.median(v) for k, v in walls.items()},
                         "launches_forecast": launches_forecast, "metrics": metrics,
                         "one_batch": one_batch,
                         "grad_tolerance": [GRAD_REL_L2, GRAD_ATOL, GRAD_RTOL],
                         "first_20_losses_dense": ld.tolist(),
                         "first_20_losses_unfused": lu20.tolist(),
                         "first_20_max_abs_diff": float(dl.max()), "loss_tolerance": LOSS_TOL,
                         "seconds_20_steps": {"dense": sec_d, "unfused": sec_u}},
              "pems_bay": {"n_vertex": pb["n_vertex"], "batch_size": BATCH_PEMS_BAY,
                           "forward_max_abs_diff": pb_diff, **pb_grads,
                           "ms": {k: {m: statistics.median(v[m]) for m in v}
                                  for k, v in timing.items()},
                           "ms_all": timing, "step_profile": profiles},
              "launches": launches_steps, "launches_forecast": launches_forecast}
    emit(result)
    return result


# --------------------------------------------------------------------------
# the 100k-vertex banded route (BASELINE.json configs[3]: bench.py:253-335)
# --------------------------------------------------------------------------

V_100K, BATCH_100K, STEPS_100K = 100_000, 8, 288   # one day of 5-minute steps
K5_REPS = 5
PER_STEP_100K = {**PER_STEP, "nv_pair": 2, "nv_chain": 2}
PER_BATCH_100K = {**PER_BATCH_FWD, "nv_pair": 2}
K5_META = ("K5", "stgcn_tpu_torch/kernels/csrc/banded_nv.cu",
           "stgcn_tpu/kernels/banded_nv.py:208", "_stream_nv_call")


class SlabPack(NamedTuple):
    """One slab tensor of a banded operator with what its kernel walks."""

    data: Any            # slabs: vn [nbr, bs, w], nv [nbr, w, bs]
    lo: Any              # [nbr] int32 window starts
    v_pad: int           # the operand's rows (vn) or lanes (nv)
    scales: Any          # [nbr, bs] row factors of an int8 pack, or None
    index: Any           # its NnzIndex
    transposed: bool     # the nv layout

    @property
    def bs(self) -> int:
        return self.data.shape[2 if self.transposed else 1]

    @property
    def w(self) -> int:
        return self.data.shape[1 if self.transposed else 2]


def slab_pack(op, field: str) -> SlabPack:
    """The operator's slab tensor ``field`` (``slabs``, ``slabs_t``,
    ``slabs_nv``, ``slabs_nv_t``) with its window starts, row factors and
    nonzero index."""
    t = field.endswith("_t")
    return SlabPack(getattr(op, field), op.lo_t if t else op.lo, op.v_pad,
                    op.scales_t if t else op.scales, getattr(op, "index" + field[len("slabs"):]),
                    "_nv" in field)


def build_100k(torch) -> dict:
    """The synthetic 100k-vertex road graph, its Chebyshev GSO (Lanczos
    lambda_max), RCM order, the banded operator the JAX CLI builds under
    ``--fused`` on the card (``auto`` with ``nv=True``: the vn stream pack
    and the nv one, f32) and one day of synthetic series with the sensor
    columns in RCM order; each host step timed."""
    from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler, chrono_split
    from stgcn_tpu_torch.data.synthetic import generate_synthetic_vel, random_road_graph
    from stgcn_tpu_torch.graph import build_gso, permute_matrix, rcm_ordering
    from stgcn_tpu_torch.graph.gso import GraphShiftOperator
    from stgcn_tpu_torch.ops import BandedGraphOp, make_graph_op

    prep: dict = {}
    t = time.perf_counter()

    def lap(key):
        nonlocal t
        now = time.perf_counter()
        prep[key] = now - t
        t = now

    adj = random_road_graph(V_100K, k_neighbors=8, seed=0)
    lap("graph_s")
    art = build_gso(adj, "sym_norm_lap", cheb=True)
    lap("gso_s")
    perm = rcm_ordering(art.matrix)
    art = GraphShiftOperator(matrix=permute_matrix(art.matrix, perm), gso_type=art.gso_type,
                             cheb_rescaled=True, lam_max=art.lam_max)
    lap("rcm_s")
    gop = make_graph_op(art, "auto", nv=True, device="cuda")
    torch.cuda.synchronize()
    lap("pack_s")
    if not isinstance(gop, BandedGraphOp):
        raise AssertionError(f"make_graph_op(auto) gave {type(gop).__name__} at 100k vertices")
    vel = generate_synthetic_vel(adj, STEPS_100K, seed=0)[:, perm]
    lap("series_s")
    train, val, test = chrono_split(vel)
    scaler = ZScoreScaler().fit(train)

    def ds(a):
        return ForecastDataset.from_numpy(scaler.transform(a), N_HIS, N_PRED, device="cuda")

    data = {"n_vertex": V_100K, "gop": gop, "art": art, "matrix": art.matrix, "scaler": scaler,
            "train": ds(train), "val": ds(val), "test": ds(test)}
    torch.cuda.synchronize()
    lap("split_s")
    nbr, w, bs = gop.slabs_nv.shape
    nnz = int(art.matrix.nnz)
    data["prep"] = {**prep, "nnz": nnz, "nbr": nbr, "w": w, "bs": bs, "v_pad": gop.v_pad,
                    "band_occupancy": nnz / (nbr * w * bs),
                    "slab_bytes": gop.slabs_nv.numel() * 4, "vn_slab_bytes": gop.slabs.numel() * 4,
                    "pair_stream": gop.pair_stream, "pair_safe": gop.pair_safe,
                    "shared_transpose_pack": gop.slabs_nv_t is gop.slabs_nv
                    and gop.slabs_t is gop.slabs,
                    "lambda_max": art.lam_max, "series_steps": STEPS_100K}
    return data


def csr_on_card(torch, m):
    """The scipy CSR GSO as a torch CSR tensor on the card (the library
    call's operator)."""
    return torch.sparse_csr_tensor(torch.from_numpy(m.indptr.astype("int64")),
                                   torch.from_numpy(m.indices.astype("int64")),
                                   torch.from_numpy(m.data.astype("float32")),
                                   size=m.shape, check_invariants=False).to("cuda")


def check_spmm(torch, name, n, mode, kernel, plain, library, *, v, nnz, vp, value_bytes: int,
               row_scales: bool, pack_bytes: int, pack_flops_one: int, library_agrees: bool,
               reps: int, vn: bool = False, scale: float = 1.0, operand_bytes: int = 4,
               compare=None) -> dict:
    """Hold one mode of a sparse kernel (K5, K6 on the nv operand ``[N, V]``;
    K10 on the vn one ``[V, N]`` when ``vn``) against its plain version
    (tolerance, repeat bit-identical, launch counter) at width N = ``n``,
    and time it beside its plain version, its bound and ``library``
    (``torch.sparse.mm`` on the CSR GSO, one call an application). In
    ``single`` ``scale`` times the library's product must agree with the
    kernel where ``library_agrees`` (the pack encodes the GSO to f32
    rounding); its max |Δ| is reported either way.

    The bound counts what the function needs, not what the pack stores: the
    operator as CSR (``nnz`` values of ``value_bytes`` each with an int32
    column index, V + 1 int32 row offsets, and V f32 row factors where
    ``row_scales``), each of the V-lane operands read once and each output
    written once; and the nonzeros' FLOPs. ``pack_bytes`` (what the kernel
    moves beyond the operands, ``index_traffic``: the nonzero index, a
    32-byte sector a value, int8 row factors and K5's and K6's workspace
    passes), plus the operands read and written once, and
    ``pack_flops_one`` (the FLOPs of one application per operand column as
    the kernel does them: the index's nonzeros) are reported beside it.

    bf16 variants: ``operand_bytes`` 2, ``compare(kernel outputs, plain
    outputs)`` their bound (``bf16_err``) in place of ``max_err``, and
    ``library`` None where ``torch.sparse.mm`` takes no bf16 operand."""
    from stgcn_tpu_torch import kernels

    compare = compare or max_err
    before = kernels.launch_counts()[name]
    out1, out2 = kernel(), kernel()
    torch.cuda.synchronize()
    if kernels.launch_counts()[name] - before != 2:
        raise AssertionError(f"{name}: launch counter did not move by 2")
    if not all(torch.equal(p, q) for p, q in zip(flat(out1), flat(out2))):
        raise AssertionError(f"{name} [N={n}]: a repeat launch is not bit-identical")
    try:
        err, ref_max = compare(out1, plain())
        lib_err = None
        if mode == "single" and library is not None:
            got, lib = (out1[:v], scale * library()) if vn else (out1[:, :v], library().T)
            lib_err = float((got.float() - lib.float()).abs().max())
            if library_agrees:
                compare(got, lib)
            del got, lib
    except AssertionError as e:
        raise AssertionError(f"{name} [N={n}]: {e}") from None
    del out1, out2
    apps = 1 if mode == "single" else 2
    ms = cuda_ms(kernel, warmup=2, reps=reps)
    plain_ms = cuda_ms(plain, warmup=1, reps=3)
    library_ms = None if library is None else cuda_ms(library, warmup=2, reps=reps)
    # each input read once (the operator, x, and g for chain), each output written once
    n_operands = 1 + (mode == "chain") + (1 if mode == "single" else 2)
    op_bytes = nnz * (value_bytes + 4) + (v + 1) * 4 + (v * 4 if row_scales else 0)
    nbytes = op_bytes + n_operands * n * v * operand_bytes
    nnz_flops, pack_flops = 2 * apps * n * nnz, apps * n * pack_flops_one
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nnz_flops / F32_FLOP_PER_S * 1e3
    return {"shape": f"N={n}", "input": [vp, n] if vn else [n, vp], "scale": scale,
            "max_abs_err": err, "ref_max": ref_max,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": None if library is None else (
                f"torch.sparse.mm CSR x{apps}"
                + ("" if vn else ", operand transposed outside the timing")
                + ("" if apps == 1 else ", 2·y − x not included")
                + ("" if scale == 1.0 else ", the scale not included")),
            "library_max_abs_diff": lib_err, "bytes": nbytes, "nnz_flops": nnz_flops,
            "bytes_ms": t_bytes, "nnz_flops_ms": t_ops,
            "pack_bytes": pack_bytes + n_operands * n * vp * operand_bytes,
            "pack_bytes_ms": (pack_bytes + n_operands * n * vp * operand_bytes)
            / HBM_BYTES_PER_S * 1e3,
            "pack_flops": pack_flops, "pack_flops_ms": pack_flops / F32_FLOP_PER_S * 1e3,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def spmm_operands(torch, gen, n, v, vp):
    """Random x and g [n, vp] and x's first v lanes transposed once, for the
    library call."""
    x = torch.randn((n, vp), generator=gen, device="cuda")
    g = torch.randn((n, vp), generator=gen, device="cuda")
    return x, g, x[:, :v].T.contiguous()


def sparse_mm(torch, a_csr, x_vn, apps: int):
    y = torch.sparse.mm(a_csr, x_vn)
    return torch.sparse.mm(a_csr, y) if apps == 2 else y


def phase_kernels_banded(torch, data) -> dict:
    """The nonzero indexes of the 100k operator's nv and vn packs built from
    the slabs on the card as the first launch would (timed, held against the
    CSR matrix); then K5 in each mode at the 100k shapes (N = B·T·c1 of
    blocks 1 and 2, the real pack), held against its plain version, repeat
    bit-identical, timed beside its bound and torch.sparse.mm."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels import banded_nv as nv

    gop, v, nnz = data["gop"], data["n_vertex"], data["prep"]["nnz"]
    nbr, w, bs = gop.slabs_nv.shape
    pack = slab_pack(gop, "slabs_nv")   # the GSO is symmetric: the transpose pack is this one
    index = {"nv_f32": index_info(torch, pack, data["matrix"]),
             "vn_f32_stream": index_info(torch, slab_pack(gop, "slabs"), data["matrix"])}
    a_csr = csr_on_card(torch, data["matrix"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    results: dict[str, list] = {name: [] for name in NV_MODES}
    for n in (BATCH_100K * (N_HIS - 2) * 16, BATCH_100K * (N_HIS - 6) * 16):
        x, g, x_vn = spmm_operands(torch, gen, n, v, gop.v_pad)
        for mode in ("single", "pair", "chain"):
            args = (gop.slabs_nv, gop.lo, x, g if mode == "chain" else None, mode)
            apps = 1 + (mode != "single")
            results[f"nv_{mode}"].append({"slabs": [nbr, w, bs],
                                          "band_flops": apps * n * 2 * nbr * w * bs, **check_spmm(
                torch, f"nv_{mode}", n, mode,
                lambda a=args: nv.stream_nv(*a, index=gop.index_nv),
                lambda a=args: nv.stream_nv_reference(*a),
                lambda apps=apps: sparse_mm(torch, a_csr, x_vn, apps),
                v=v, nnz=nnz, vp=gop.v_pad, value_bytes=4, row_scales=False,
                pack_bytes=index_traffic(pack, n, mode)[0],
                pack_flops_one=index_traffic(pack, n, mode)[1], library_agrees=True,
                reps=K5_REPS)})
        del x, g, x_vn
    kernels.reset_launch_counts()
    emit({"phase": "kernels_banded", "seconds": time.perf_counter() - t0,
          "tolerance": KERNEL_TOL, "pack": data["prep"], "index": index, "results": results})
    return results


def rel_l2(torch, got, ref) -> float:
    return float((got.double() - ref.double()).norm() / (ref.double().norm() + 1e-30))


def head_grads_f64(torch, model, x, y, n_valid: int, gop, seed: int) -> tuple[dict, dict, int]:
    """The output head's parameter gradients of one batch in float64: the ST
    blocks run in f32 as the unfused forward runs them (no grad), then a
    float64 copy of the head and the loss, with the same dropout mask, so
    each route's f32 sums over the lanes can be held against exact ones.
    Returns the gradients with the head's own ReLU, those with fc1's ReLU
    taken where the unfused f32 head takes it, and how many of those ReLU
    decisions differ between f32 and float64."""
    import copy

    from stgcn_tpu_torch.kernels import dropout
    from stgcn_tpu_torch.kernels.dropout import Drop
    from stgcn_tpu_torch.train import masked_mse

    n_st, out32 = model.n_st_blocks, model.output
    with torch.no_grad():
        h = x
        for l in range(n_st):
            h = getattr(model, f"st_block_{l}")(h, gop, Drop(DROPRATE, seed, l))
        on32 = out32.fc1(out32.ln(out32.tmp_conv1(h))) > 0
    head = copy.deepcopy(out32).double()
    h = h.double()

    def grads(relu_on):
        z = head.fc1(head.ln(head.tmp_conv1(h)))
        a = torch.relu(z) if relu_on is None else z * relu_on
        pred = head.fc2(dropout.apply_channels_last(a, Drop(DROPRATE, seed, n_st)))
        loss = masked_mse(pred.reshape(pred.shape[0], -1), y.double(), n_valid)
        g = torch.autograd.grad(loss, list(head.parameters()))
        return {f"output.{k}": gi for (k, _), gi in zip(head.named_parameters(), g)}, z

    exact, z = grads(None)
    flips = int(((z > 0) != on32).sum())
    return exact, grads(on32)[0], flips


def phase_banded_100k(torch, data) -> dict:
    """The 100k-vertex route end to end on the banded operator (``run_route``)."""
    return run_route(torch, data, phase="banded_100k", batch=BATCH_100K,
                     per_step=PER_STEP_100K, per_batch=PER_BATCH_100K, opt="adamw",
                     dataset_name="road-100k", cuts=["one epoch", "a one-day series"])


def run_route(torch, data, *, phase: str, batch: int, per_step: dict, per_batch: dict,
              opt: str, dataset_name: str, cuts: list) -> dict:
    """A large graph's route end to end: one forecast batch fused against
    unfused on its sparse operator, every K1-K4 call of one fused training
    step held against its plain version, fused gradients against unfused ones,
    then a fused Trainer.fit(1) with its launches counted, and test()."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels import nnz_index
    from stgcn_tpu_torch.kernels.dropout import step_seed
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.train import TrainConfig, Trainer, masked_mse

    gop, v = data["gop"], data["n_vertex"]
    ckpt_root = ROOT / "checkpoints" / f"chip_smoke_{phase}"   # git-ignored, removed at the end
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    # 1. one forecast batch: fused (K1-K4, the operator's pair) against the unfused model
    model = new_model(torch, v, DROPRATE).eval()
    params = model.state_dict()
    starts, _ = next(data["test"].batches(batch))
    x, _ = gather_windows(data["test"].series, starts, N_HIS, N_PRED)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        pf = fused_sparse_forward(params, x, gop, model)
        torch.cuda.synchronize()
        fwd_launches = kernels.launch_counts()
        pu = model(x, gop)
        walls: dict[str, list] = {"fused": [], "unfused": []}
        for kind in ("fused", "unfused", "unfused", "fused"):
            t1 = time.perf_counter()
            (fused_sparse_forward(params, x, gop, model) if kind == "fused" else model(x, gop))
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t1)
    if fwd_launches != expected(per_batch, 1):
        raise AssertionError(f"fused forecast launched {fwd_launches}, expected "
                             f"{expected(per_batch, 1)}")
    if pf.shape != (batch, 1, v, 1) or not torch.isfinite(pf).all():
        raise AssertionError(f"fused forecast has shape {tuple(pf.shape)} or non-finite values")
    d = (pf - pu).abs()
    if not bool((d <= SLICE_TOL + SLICE_TOL * pu.abs()).all()):
        raise AssertionError(f"{phase}: fused and unfused forecasts differ: max |Δ| "
                             f"{float(d.max()):.3e}")
    forecast = {"max_abs_diff_fused_unfused": float(d.max()), "tolerance": SLICE_TOL,
                "launches": fwd_launches, "seconds_fused": statistics.median(walls["fused"]),
                "seconds_unfused": statistics.median(walls["unfused"])}
    del model, params, pf, pu

    # 2. every K1-K4 call of one fused training step, against its plain version
    calls = record_training_step(torch, data, batch)
    per_call = check_recorded(torch, calls, reps=3)
    trace = trace_backward(torch, data, calls, batch, phase) if phase == "banded_100k" else None
    del calls

    # 3. one batch's gradients, fused against unfused, same masks
    model = new_model(torch, v, DROPRATE)
    params = dict(model.named_parameters())
    starts, n_valid = next(data["train"].batches(batch))
    x, y = gather_windows(data["train"].series, starts, N_HIS, N_PRED)

    def grads(fused):
        pred = (fused_sparse_forward(params, x, gop, model, deterministic=False,
                                     seed=step_seed(42, 0))
                if fused else model(x, gop, deterministic=False, seed=step_seed(42, 0)))
        loss = masked_mse(pred.reshape(batch, -1), y, n_valid)
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    per_f, per_u = grads(True), grads(False)
    gf = torch.cat([g.flatten() for g in per_f.values()])
    gu = torch.cat([g.flatten() for g in per_u.values()])
    rel = float((gf - gu).norm() / (gu.norm() + 1e-12))
    worst = float(((gf - gu).abs() - GRAD_RTOL * gu.abs()).max())
    if not rel < GRAD_REL_L2 or worst > GRAD_ATOL:
        by_param = sorted(((rel_l2(torch, per_f[k], per_u[k]), k) for k in params), reverse=True)
        raise AssertionError(f"{phase}: fused gradients off the unfused ones: relative L2 "
                             f"{rel:.3e}, worst excess over the rtol {worst:.3e}; largest "
                             f"per parameter: {by_param[:3]}")
    # the output head's gradients against float64: which route's sums are off
    # (unfused_same_relu: float64 with fc1's ReLU where the unfused f32 head takes it)
    exact, same_relu, flips = head_grads_f64(torch, model, x, y, n_valid, gop,
                                             step_seed(42, 0))
    routes = (("fused", per_f, exact), ("unfused", per_u, exact),
              ("unfused_same_relu", per_u, same_relu))
    head = {k: {r: rel_l2(torch, got[k], ref[k]) for r, got, ref in routes} for k in exact}
    head["all"] = {r: rel_l2(torch, torch.cat([got[k].flatten() for k in exact]),
                             torch.cat([ref[k].flatten() for k in exact]))
                   for r, got, ref in routes}
    if not head["all"]["fused"] < GRAD_REL_L2:
        raise AssertionError(f"{phase}: the fused route's output-head gradients are off "
                             f"float64 by relative L2 {head['all']['fused']:.3e}")
    one_batch = {"grad_rel_l2": rel, "grad_max_abs_diff": float((gf - gu).abs().max()),
                 "head_rel_l2_to_f64": head, "head_relu_decisions_f32_vs_f64": flips}
    del model, params, gf, gu, per_f, per_u, exact, same_relu, routes

    # 4. a fused fit of one epoch, every step's loss and time, then test();
    # the peak memory of the checks above is kept apart from the fit's
    checks_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=DROPRATE, batch_size=batch, opt=opt,
                      fused=True, ckpt_dir=str(ckpt_root), dataset_name=dataset_name)
    tr = Trainer(cfg, new_model(torch, v, DROPRATE), gop, data["train"], data["val"],
                 data["test"], data["scaler"], device="cuda")
    builds = nnz_index.builds()
    losses, step_seconds, hist, launches = timed_fit(torch, tr, phase)
    val_batches = -(-tr.val_ds.num_windows // batch)
    want = expected(per_step, tr.steps_per_epoch, (per_batch, val_batches))
    if launches != want:
        raise AssertionError(f"{phase}: the fit launched {launches}, expected {want}")
    test_m = tr.test()
    if not all(v_ == v_ and abs(v_) < float("inf") for v_ in test_m.values()):
        raise AssertionError(f"{phase}: non-finite test metrics {test_m}")
    rebuilds = nnz_index.builds() - builds
    if rebuilds:   # the operator is fixed: its nonzero index is never rebuilt
        raise AssertionError(f"{phase}: the fit and test rebuilt a nonzero index {rebuilds} times")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    result = {"phase": phase, "seconds": time.perf_counter() - t0, "n_vertex": v,
              "batch_size": batch, "optimizer": opt, "cuts": cuts, "prep": data["prep"],
              "forecast_one_batch": forecast, "one_batch": one_batch,
              "grad_tolerance": [GRAD_REL_L2, GRAD_ATOL, GRAD_RTOL],
              "steps_per_epoch": tr.steps_per_epoch, "val_batches": val_batches,
              "step_losses": losses, "step_seconds": step_seconds,
              "step_seconds_median": statistics.median(step_seconds),
              "epoch": hist[0], "launches": launches, "test": test_m,
              "index_rebuilds": rebuilds,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "peak_memory_bytes_checks": checks_peak, "per_step_calls": per_call}
    emit(result)
    if trace:
        result["trace"] = trace
    return result


# --------------------------------------------------------------------------
# the 100k route of auto without --fused: the vn banded kernels K7-K9, K5 int8
# --------------------------------------------------------------------------

VN_REPS = 5
PER_STEP_100K_UNFUSED = {"vn_pair": 2, "vn_chain": 2}   # K9 pair per block, its chain back
PER_BATCH_100K_UNFUSED = {"vn_pair": 2}
VN_SOURCE = "stgcn_tpu_torch/kernels/csrc/banded_vn.cu"
K7_META = (("K7a", VN_SOURCE, "stgcn_tpu/kernels/banded_spmm.py:255", "_banded_pallas_resident"),
           ("K7b", VN_SOURCE, "stgcn_tpu/kernels/banded_spmm.py:302", "_banded_pallas"))
K8_META = ("K8", VN_SOURCE, "stgcn_tpu/kernels/banded_spmm.py:519", "banded_cheb_pair")
K9_META = ("K9", VN_SOURCE, "stgcn_tpu/kernels/banded_spmm.py:774", "_pair_stream_call")
# the vn kernel's wrappers (kernels/banded_spmm.py) and the mode each launches
VN_WRAPPERS = {"banded_spmm": "single", "banded_cheb_pair": "pair",
               "banded_cheb_pair_stream": "pair", "banded_chain_stream": "chain"}


def vn_launch(wrapper: str, scales) -> str:
    from stgcn_tpu_torch.kernels import banded_spmm as bk

    return bk.launch_name(VN_WRAPPERS[wrapper], scales is not None,
                          resident=wrapper == "banded_cheb_pair")


def check_vn(torch, wrapper, slabs, lo, x, g=None, scales=None, scale=1.0, *, index, v, nnz,
             a_csr, reps, library_agrees) -> dict:
    """``check_spmm`` for one wrapper of the vn kernel (K7, K8, K9) on the vn
    operand ``x`` [v_pad, N] (``g`` for the chain; ``scales`` on an int8
    pack; ``index`` the pack's nonzero index, built), against its plain
    version; the library call is ``torch.sparse.mm`` on the CSR GSO and x's
    first V rows (Aᵀ for the chain: the GSO is symmetric)."""
    from stgcn_tpu_torch.kernels import banded_spmm as bk

    mode = VN_WRAPPERS[wrapper]
    nbr, bs, w = slabs.shape
    kw = {"scale": scale} if mode == "single" else {}
    if scales is not None:
        kw["scales_t" if mode == "chain" else "scales"] = scales
    kw["index_t" if mode == "chain" else "index"] = index
    args = (slabs, lo, x, g) if mode == "chain" else (slabs, lo, x)
    fn = getattr(bk, wrapper)
    q = scales is not None
    pack = SlabPack(slabs, lo, x.shape[0], scales, index, False)
    apps = 1 + (mode != "single")
    return {"slabs": [nbr, bs, w], "dtype": "int8" if q else "f32",
            "band_flops": apps * x.shape[1] * 2 * nbr * bs * w, **check_spmm(
        torch, vn_launch(wrapper, scales), x.shape[1], mode, lambda: fn(*args, **kw),
        lambda: bk.banded_vn_reference(slabs, lo, x, g, mode, scales=scales, scale=scale),
        lambda: sparse_mm(torch, a_csr, x[:v], apps), v=v, nnz=nnz,
        vp=x.shape[0], value_bytes=1 if q else 4, row_scales=q,
        pack_bytes=index_traffic(pack, x.shape[1], mode)[0],
        pack_flops_one=index_traffic(pack, x.shape[1], mode)[1], library_agrees=library_agrees,
        reps=reps, vn=True, scale=scale)}


def phase_kernels_banded_vn(torch, data) -> dict:
    """The vn kernel (K7 single at scale 1 and 2, K9 pair and chain on the
    stream packs, f32 and int8; K8 pair on the clamped pack of
    ``stream=False``) and K5 on the int8 nv pack (single, pair, chain), at
    N = 1280 and 768 on the 100k packs, random operands: held against their
    plain versions, repeat bit-identical, timed beside their bounds and
    ``torch.sparse.mm``. The int8 operator (vn and nv) and the clamped one
    are built on the card here (timed) and kept for ``banded_100k_unfused``,
    which frees them."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels import banded_nv as nv
    from stgcn_tpu_torch.kernels import banded_spmm as bk
    from stgcn_tpu_torch.ops import banded_graph_op

    gop, v, nnz = data["gop"], data["n_vertex"], data["prep"]["nnz"]
    packs: dict = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        packs[key] = time.perf_counter() - t1
        return out

    matrix = data["art"].matrix
    timed("f32_vn_stream_s", lambda: bk.pack_banded_device(matrix, block_size=256, col_align=256,
                                                            contain_diag=True, device="cuda"))
    timed("f32_nv_stream_s", lambda: bk.pack_banded_device(
        matrix, block_size=256, col_align=256, contain_diag=True, transpose_slabs=True,
        device="cuda"))
    timed("int8_nv_stream_s", lambda: bk.pack_banded_device(
        matrix, block_size=256, col_align=256, contain_diag=True, dtype=torch.int8,
        transpose_slabs=True, device="cuda"))
    q = data["int8"] = timed("int8_operator_vn_and_nv_s", lambda: banded_graph_op(
        data["art"], quantize=True, nv=True, device="cuda"))
    c = data["clamped"] = timed("clamped_operator_s", lambda: banded_graph_op(
        data["art"], stream=False, device="cuda"))
    torch.cuda.empty_cache()
    for key, op in (("f32", gop), ("int8", q), ("clamped", c)):
        packs[key] = {"slabs": list(op.slabs.shape), "bytes": op.slabs.numel()
                      * op.slabs.element_size() * (1 if op.slabs_t is op.slabs else 2),
                      "v_pad": op.v_pad, "pair_stream": op.pair_stream, "pair_safe": op.pair_safe}
    if not (gop.pair_stream and q.pair_stream and c.pair_safe and not c.pair_stream):
        raise AssertionError(f"the 100k packs do not take the JAX routes this phase checks: {packs}")
    # the clamped operator packs Aᵀ apart; the int8 one shares its packs (symmetric GSO)
    index = {"vn_int8": index_info(torch, slab_pack(q, "slabs"), matrix),
             "nv_int8": index_info(torch, slab_pack(q, "slabs_nv"), matrix),
             "vn_clamped": index_info(torch, slab_pack(c, "slabs"), matrix),
             "vn_clamped_t": index_info(torch, slab_pack(c, "slabs_t"), matrix.T)}

    a_csr = csr_on_card(torch, data["matrix"])
    gen = torch.Generator(device="cuda").manual_seed(2)
    results: dict[str, list] = {}
    common = dict(v=v, nnz=nnz, a_csr=a_csr, reps=VN_REPS)
    for n in (BATCH_100K * (N_HIS - 2) * 16, BATCH_100K * (N_HIS - 6) * 16):
        x = torch.randn((gop.v_pad, n), generator=gen, device="cuda")
        g = torch.randn((gop.v_pad, n), generator=gen, device="cuda")
        for op, agrees in ((gop, True), (q, False)):
            for scale in (1.0, 2.0):
                r = check_vn(torch, "banded_spmm", op.slabs, op.lo, x, scales=op.scales,
                             scale=scale, index=op.index, library_agrees=agrees, **common)
                results.setdefault(vn_launch("banded_spmm", op.scales), []).append(r)
            r = check_vn(torch, "banded_cheb_pair_stream", op.slabs, op.lo, x, scales=op.scales,
                         index=op.index, library_agrees=agrees, **common)
            results.setdefault(vn_launch("banded_cheb_pair_stream", op.scales), []).append(r)
            r = check_vn(torch, "banded_chain_stream", op.slabs_t, op.lo_t, x, g,
                         scales=op.scales_t, index=op.index_t, library_agrees=agrees, **common)
            results.setdefault(vn_launch("banded_chain_stream", op.scales), []).append(r)
        xc = torch.randn((c.v_pad, n), generator=gen, device="cuda")
        results.setdefault("vn_pair_resident", []).append(check_vn(
            torch, "banded_cheb_pair", c.slabs, c.lo, xc, index=c.index, library_agrees=True,
            **common))
        del x, g, xc
        x, g, x_vn = spmm_operands(torch, gen, n, v, q.v_pad)
        nbr, w, bs = q.slabs_nv.shape
        pack = slab_pack(q, "slabs_nv")
        for mode in ("single", "pair", "chain"):
            args = (q.slabs_nv, q.lo, x, g if mode == "chain" else None, mode)
            apps = 1 + (mode != "single")
            results.setdefault(nv.launch_name(mode, True), []).append(
                {"slabs": [nbr, w, bs], "dtype": "int8",
                 "band_flops": apps * n * 2 * nbr * w * bs, **check_spmm(
                    torch, nv.launch_name(mode, True), n, mode,
                    lambda a=args: nv.stream_nv(*a, scales=q.scales, index=q.index_nv),
                    lambda a=args: nv.stream_nv_reference(*a, scales=q.scales),
                    lambda apps=apps: sparse_mm(torch, a_csr, x_vn, apps),
                    v=v, nnz=nnz, vp=q.v_pad, value_bytes=1, row_scales=True,
                    pack_bytes=index_traffic(pack, n, mode)[0],
                    pack_flops_one=index_traffic(pack, n, mode)[1], library_agrees=False,
                    reps=VN_REPS)})
        del x, g, x_vn
    del a_csr
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    emit({"phase": "kernels_banded_vn", "seconds": time.perf_counter() - t0,
          "tolerance": KERNEL_TOL, "packs": packs, "index": index, "results": results})
    return results


def record_vn_step(torch, data, gop, model=None) -> list:
    """Run one unfused training step (forward with dropout, backward) on the
    first training batch through the banded operator ``gop`` and record
    every call of the vn kernel's wrappers: (wrapper, args, kwargs). The
    model is ``new_model``'s unless one is given."""
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels import banded_spmm as bk
    from stgcn_tpu_torch.kernels.dropout import step_seed
    from stgcn_tpu_torch.train import masked_mse

    calls: list = []
    real = {name: getattr(bk, name) for name in VN_WRAPPERS}

    def recorder(name):
        def call(*args, **kwargs):
            calls.append((name, tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                      for a in args), kwargs))
            return real[name](*args, **kwargs)
        return call

    model = model if model is not None else new_model(torch, data["n_vertex"], DROPRATE)
    params = dict(model.named_parameters())
    starts, n_valid = next(data["train"].batches(BATCH_100K))
    x, y = gather_windows(data["train"].series, starts, N_HIS, N_PRED)
    try:
        for name in VN_WRAPPERS:
            setattr(bk, name, recorder(name))
        pred = model(x, gop, deterministic=False, seed=step_seed(42, 0))
        loss = masked_mse(pred.reshape(BATCH_100K, -1), y, n_valid)
        torch.autograd.grad(loss, list(params.values()))
    finally:
        for name in VN_WRAPPERS:
            setattr(bk, name, real[name])
    torch.cuda.synchronize()
    return calls


def phase_banded_100k_unfused(torch, data) -> dict:
    """The 100k route of ``auto`` without ``--fused``, as ``main.py``'s
    defaults run it: the unfused model on the vn stream pack (K9), batch 8,
    AdamW. One forecast batch through K9 against the fused one through K5;
    the same on ``banded_int8`` (K9 int8 against K5 int8, and against f32);
    on the clamped pack of ``stream=False`` (K8) against the stream one;
    a graph_conv model's forecast (K7 against K5 single, f32 and int8);
    every vn call of one unfused training step against its plain version;
    an unfused ``Trainer.fit(1)`` with its launches counted (K9 pair ×2 and
    chain ×2 a step, K5 never), then ``test()``; the fit's peak memory apart
    from the checks'. Leaves the int8 and clamped operators to
    ``phase_banded_100k_bf16``, which frees them."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels import nnz_index
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.train import TrainConfig, Trainer

    gop, q, c, v = data["gop"], data["int8"], data["clamped"], data["n_vertex"]
    ckpt_root = ROOT / "checkpoints" / "chip_smoke_banded_100k_unfused"   # removed at the end
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    starts, _ = next(data["test"].batches(BATCH_100K))
    x, _ = gather_windows(data["test"].series, starts, N_HIS, N_PRED)

    def forecast(model, op, fused, want: dict):
        """One forecast batch; its launches must be ``want``."""
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            out = (fused_sparse_forward(model.state_dict(), x, op, model) if fused
                   else model(x, op))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launches = kernels.launch_counts()
        if launches != expected(want, 1):
            raise AssertionError(f"a 100k forecast launched {launches}, expected "
                                 f"{expected(want, 1)}")
        if out.shape != (BATCH_100K, 1, v, 1) or not torch.isfinite(out).all():
            raise AssertionError(f"a 100k forecast has shape {tuple(out.shape)} or non-finite "
                                 "values")
        return out, {k: n for k, n in launches.items() if n}, seconds

    def agree(label, got, ref) -> float:
        d = (got - ref).abs()
        if not bool((d <= SLICE_TOL + SLICE_TOL * ref.abs()).all()):
            raise AssertionError(f"banded_100k_unfused: {label} differ: max |Δ| "
                                 f"{float(d.max()):.3e}")
        return float(d.max())

    # 1. forecasts: K9 against K5, f32 and int8; K8 against K9; K7 against K5 single
    model = new_model(torch, v, DROPRATE).eval()
    pu, lu, su = forecast(model, gop, False, PER_BATCH_100K_UNFUSED)
    pf, lf, sf = forecast(model, gop, True, PER_BATCH_100K)
    qu, lqu, squ = forecast(model, q, False, {"vn_pair_int8": 2})
    qf, lqf, sqf = forecast(model, q, True, {**PER_BATCH_FWD, "nv_pair_int8": 2})
    pc, lc, sc = forecast(model, c, False, {"vn_pair_resident": 2})
    forecasts = {
        "unfused_k9_vs_fused_k5": {"max_abs_diff": agree("K9 and K5 forecasts", pu, pf),
                                   "launches": [lu, lf], "seconds": [su, sf]},
        "int8_unfused_k9_vs_fused_k5": {"max_abs_diff": agree("int8 K9 and K5 forecasts", qu, qf),
                                        "launches": [lqu, lqf], "seconds": [squ, sqf]},
        "int8_vs_f32_unfused": {"max_abs_diff": float((qu - pu).abs().max()),
                                "rel_l2": rel_l2(torch, qu, pu), "checked": False},
        "clamped_k8_vs_stream_k9": {"max_abs_diff": agree("K8 and K9 forecasts", pc, pu),
                                    "launches": lc, "seconds": sc},
    }
    del model, pu, pf, qu, qf, pc
    gmodel = new_model(torch, v, DROPRATE, gct="graph_conv").eval()
    for tag, op, sfx in (("f32", gop, ""), ("int8", q, "_int8")):
        gu, lgu, sgu = forecast(gmodel, op, False, {f"vn_single{sfx}": 2})
        gf, lgf, sgf = forecast(gmodel, op, True, {**PER_BATCH_FWD, f"nv_single{sfx}": 2})
        forecasts[f"graph_conv_{tag}_unfused_k7_vs_fused_k5"] = {
            "max_abs_diff": agree(f"graph_conv {tag} K7 and K5 forecasts", gu, gf),
            "launches": [lgu, lgf], "seconds": [sgu, sgf]}
        del gu, gf
    del gmodel
    forecasts["tolerance"] = SLICE_TOL

    # 2. every vn call of one unfused training step, against its plain version
    calls = record_vn_step(torch, data, gop)
    names = [vn_launch(name, kw.get("scales")) for name, _, kw in calls]
    if sorted(names) != sorted(k for k, n in PER_STEP_100K_UNFUSED.items() for _ in range(n)):
        raise AssertionError(f"one unfused 100k step called {names}, expected "
                             f"{PER_STEP_100K_UNFUSED}")
    a_csr = csr_on_card(torch, data["matrix"])
    per_call: dict[str, list] = {k: [] for k in PER_STEP_100K_UNFUSED}
    failed = []
    for i, (name, args, kw) in enumerate(calls):
        try:
            per_call[names[i]].append({"call": f"call{i}", **check_vn(
                torch, name, *args, scales=kw.get("scales", kw.get("scales_t")),
                scale=kw.get("scale", 1.0), index=kw.get("index", kw.get("index_t")), v=v,
                nnz=data["prep"]["nnz"], a_csr=a_csr, reps=3, library_agrees=True)})
        except AssertionError as e:
            failed.append(f"call{i} ({names[i]}): {e}")
    if failed:
        raise AssertionError("; ".join(failed))
    del calls, a_csr
    torch.cuda.empty_cache()

    # 3. an unfused fit of one epoch, every step's loss and time, then test()
    checks_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=DROPRATE, batch_size=BATCH_100K,
                      opt="adamw", fused=False, ckpt_dir=str(ckpt_root), dataset_name="road-100k")
    tr = Trainer(cfg, new_model(torch, v, DROPRATE), gop, data["train"], data["val"],
                 data["test"], data["scaler"], device="cuda")
    builds = nnz_index.builds()
    losses, step_seconds, hist, launches = timed_fit(torch, tr, "banded_100k_unfused")
    val_batches = -(-tr.val_ds.num_windows // BATCH_100K)
    want = expected(PER_STEP_100K_UNFUSED, tr.steps_per_epoch,
                    (PER_BATCH_100K_UNFUSED, val_batches))
    if launches != want:
        raise AssertionError(f"banded_100k_unfused: the fit launched {launches}, expected {want}")
    fit_peak = torch.cuda.max_memory_allocated()
    test_m = tr.test()
    if not all(v_ == v_ and abs(v_) < float("inf") for v_ in test_m.values()):
        raise AssertionError(f"banded_100k_unfused: non-finite test metrics {test_m}")
    rebuilds = nnz_index.builds() - builds
    if rebuilds:   # the operator is fixed: its nonzero index is never rebuilt
        raise AssertionError(f"banded_100k_unfused: the fit and test rebuilt a nonzero index "
                             f"{rebuilds} times")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    steps = tr.steps_per_epoch
    del tr, q, c
    torch.cuda.empty_cache()
    result = {"phase": "banded_100k_unfused", "seconds": time.perf_counter() - t0,
              "n_vertex": v, "batch_size": BATCH_100K, "optimizer": "adamw",
              "route": "unfused, banded vn stream pack (K9)",
              "cuts": ["one epoch", "a one-day series", "f32, not the bench's bf16", "no remat"],
              "forecast_one_batch": forecasts, "steps_per_epoch": steps,
              "val_batches": val_batches, "step_losses": losses, "step_seconds": step_seconds,
              "step_seconds_median": statistics.median(step_seconds), "epoch": hist[0],
              "launches": launches, "test": test_m, "index_rebuilds": rebuilds,
              "peak_memory_bytes_fit": fit_peak,
              "peak_memory_bytes_fit_and_test": torch.cuda.max_memory_allocated(),
              "peak_memory_bytes_checks": checks_peak, "per_step_calls": per_call}
    emit(result)
    return result


# --------------------------------------------------------------------------
# bf16 mixed precision and remat on the unfused model (BASELINE.json
# configs[3] and [4]: bench.py:253-335, :338-450): the bf16 variants of the
# vn kernel (K7-K9) and of K10
# --------------------------------------------------------------------------

BF16_REL = 2.0 ** -7     # two ulps of bf16: kernel and plain version round at the same points
BF16_LOOSE = 2.0 ** -6   # a whole pair or chain against its plain version (vn_bf16_compare)
BF16_LOSS_RTOL = 0.08    # bf16 against float32 losses (tests/test_train.py:235)
# a bf16 model's forecast against the float32 one's: the JAX package's own bf16
# bound (tests/test_vertex_fused.py:232)
BF16_MODEL_ATOL, BF16_MODEL_RTOL = 0.1, 0.05
PER_STEP_100K_BF16 = {"vn_pair_bf16": 2, "vn_chain_bf16": 2}
PER_BATCH_100K_BF16 = {"vn_pair_bf16": 2}
PER_STEP_BCSR_BF16 = {"bcsr_spmm_bf16": 8}
PER_BATCH_BCSR_BF16 = {"bcsr_spmm_bf16": 4}
SLAB_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def bf16_err(got, ref, *, add=None, rel: float = BF16_REL) -> tuple[float, list]:
    """max |Δ| and each output's max |ref| of bf16 outputs; raises where an
    element lies outside ``rel · (|ref| + |add|) + KERNEL_TOL · min(1, max
    |ref|)``: the kernel and its plain version round at the same points, so
    they differ where float32 sums taken in other orders round to
    neighbouring bf16 values."""
    import torch

    worst, ref_max = 0.0, []
    for i, (g, r) in enumerate(zip(flat(got), flat(ref))):
        if g.dtype != r.dtype or g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"output {i}: {g.dtype} {tuple(g.shape)} against {r.dtype} "
                                 f"{tuple(r.shape)}, or non-finite values")
        g32, r32 = g.float(), r.float()
        d = (g32 - r32).abs()
        ref_max.append(float(r32.abs().max()))
        scale = r32.abs() if add is None else r32.abs() + add.float().abs()
        bad = d > rel * scale + KERNEL_TOL * min(1.0, ref_max[-1])
        if bad.any():
            raise AssertionError(f"output {i}: {int(bad.sum())} of {bad.numel()} elements "
                                 f"outside the bf16 bound (max |Δ| {float(d.max()):.3e}, "
                                 f"max |ref| {ref_max[-1]:.3e})")
        worst = max(worst, float(d.max()))
        del g32, r32, d, scale, bad
    return worst, ref_max


def vn_bf16_compare(slabs, lo, x, mode: str, scales):
    """The bound of a bf16 vn call (``check_spmm``'s ``compare``): single
    and ``mid`` within two ulps of their plain version; the second pass
    within two ulps of its plain version fed with the kernel's own ``mid``
    (a ``mid`` an ulp apart moves it further where ``2·A·mid`` and ``x``
    cancel); the whole within ``BF16_LOOSE · (|ref| + |x|)`` of the plain
    version."""
    from stgcn_tpu_torch.kernels import banded_spmm as bk

    def compare(got, ref):
        if mode == "single":
            return bf16_err(got, ref)
        e1, m1 = bf16_err(got[0], ref[0])
        e2, m2 = bf16_err(got[1], bk.vn_pass_reference(
            slabs, lo, got[0], x, alpha=2.0 if mode == "pair" else 1.0, beta=-1.0,
            scales=scales))
        bf16_err(got[1], ref[1], add=x, rel=BF16_LOOSE)
        return max(e1, e2), m1 + m2

    return compare


def csr_bf16_on_card(torch, m) -> tuple[Any, str | None]:
    """The CSR GSO in bf16 on the card and whether ``torch.sparse.mm`` takes
    it with a bf16 operand (None and the error where it does not)."""
    a = torch.sparse_csr_tensor(torch.from_numpy(m.indptr.astype("int64")),
                                torch.from_numpy(m.indices.astype("int64")),
                                torch.from_numpy(m.data.astype("float32")).bfloat16(),
                                size=m.shape, check_invariants=False).to("cuda")
    try:
        torch.sparse.mm(a, torch.zeros((m.shape[1], 8), device="cuda", dtype=torch.bfloat16))
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return a, None


def check_vn_bf16(torch, wrapper, slabs, lo, x, g=None, scales=None, scale=1.0, *, index, v,
                  nnz, a_csr16, reps) -> dict:
    """``check_vn`` for the bf16 variant: a bf16 operand ``x`` (and ``g``)
    over float32, bf16 or int8 slabs, held to ``vn_bf16_compare``; the
    bound counts 2-byte operands; the library call is ``torch.sparse.mm`` on
    the bf16 CSR GSO where it takes bf16 (its values rounded to bf16, so
    its distance is printed, not checked)."""
    from stgcn_tpu_torch.kernels import banded_spmm as bk

    mode = VN_WRAPPERS[wrapper]
    nbr, bs, w = slabs.shape
    kw = {"scale": scale} if mode == "single" else {}
    if scales is not None:
        kw["scales_t" if mode == "chain" else "scales"] = scales
    kw["index_t" if mode == "chain" else "index"] = index
    args = (slabs, lo, x, g) if mode == "chain" else (slabs, lo, x)
    fn = getattr(bk, wrapper)
    slab_kind = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}[slabs.dtype]
    pack = SlabPack(slabs, lo, x.shape[0], scales, index, False)
    apps = 1 + (mode != "single")
    name = bk.launch_name(mode, scales is not None, resident=wrapper == "banded_cheb_pair",
                          bf16=True)
    return {"slabs": [nbr, bs, w], "dtype": "bf16", "slabs_dtype": slab_kind,
            "band_flops": apps * x.shape[1] * 2 * nbr * bs * w, **check_spmm(
        torch, name, x.shape[1], mode, lambda: fn(*args, **kw),
        lambda: bk.banded_vn_reference(slabs, lo, x, g, mode, scales=scales, scale=scale),
        None if a_csr16 is None else lambda: sparse_mm(torch, a_csr16, x[:v], apps), v=v,
        nnz=nnz, vp=x.shape[0], value_bytes=SLAB_BYTES[slab_kind], row_scales=scales is not None,
        pack_bytes=index_traffic(pack, x.shape[1], mode)[0],
        pack_flops_one=index_traffic(pack, x.shape[1], mode)[1], library_agrees=False,
        reps=reps, vn=True, scale=scale, operand_bytes=2,
        compare=vn_bf16_compare(slabs, lo, x, mode, scales))}


def phase_kernels_bf16(torch, data) -> dict:
    """The bf16 variant of the vn kernel at the 100k shapes: a bf16 operand
    at N = 1280 and 768 (B·T·c1 of the two ST blocks at batch 8), random,
    over the float32 stream pack (the operator the CLI builds), the bf16
    one (``banded_graph_op(dtype=bfloat16)``, the bench's, built here on the
    card, timed, and its index checked as in phase 9) and the int8 one: K7
    at scale 1 and 2, K9 pair and chain; K8 pair on the clamped float32
    pack. Each held against its plain version in bf16 (``vn_bf16_compare``),
    repeat bit-identical, timed beside its bound (2-byte operands) and
    ``torch.sparse.mm`` on the bf16 CSR GSO where it takes bf16. The bf16
    pack is freed at the end."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.ops import banded_graph_op

    gop, q, c, v = data["gop"], data["int8"], data["clamped"], data["n_vertex"]
    nnz = data["prep"]["nnz"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    b16 = banded_graph_op(data["art"], dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    pack = {"bf16_operator_s": time.perf_counter() - t1, "slabs": list(b16.slabs.shape),
            "bytes": b16.slabs.numel() * b16.slabs.element_size(),
            "shared_transpose_pack": b16.slabs_t is b16.slabs, "pair_stream": b16.pair_stream}
    if not (b16.pair_stream and b16.slabs.dtype == torch.bfloat16 and b16.v_pad == gop.v_pad):
        raise AssertionError(f"the bf16 100k operator does not take the stream route: {pack}")
    index = index_info(torch, slab_pack(b16, "slabs"), data["matrix"])
    a_csr16, lib_error = csr_bf16_on_card(torch, data["matrix"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    results: dict[str, list] = {}
    common = dict(v=v, nnz=nnz, a_csr16=a_csr16, reps=VN_REPS)
    for n in (BATCH_100K * (N_HIS - 2) * 16, BATCH_100K * (N_HIS - 6) * 16):
        x = torch.randn((gop.v_pad, n), generator=gen, device="cuda").bfloat16()
        g = torch.randn((gop.v_pad, n), generator=gen, device="cuda").bfloat16()
        for op in (gop, b16, q):
            for scale in (1.0, 2.0):
                r = check_vn_bf16(torch, "banded_spmm", op.slabs, op.lo, x, scales=op.scales,
                                  scale=scale, index=op.index, **common)
                results.setdefault(r["slabs_dtype"], {}).setdefault(
                    vn_launch("banded_spmm", op.scales) + "_bf16", []).append(r)
            r = check_vn_bf16(torch, "banded_cheb_pair_stream", op.slabs, op.lo, x,
                              scales=op.scales, index=op.index, **common)
            results[r["slabs_dtype"]].setdefault(
                vn_launch("banded_cheb_pair_stream", op.scales) + "_bf16", []).append(r)
            r = check_vn_bf16(torch, "banded_chain_stream", op.slabs_t, op.lo_t, x, g,
                              scales=op.scales_t, index=op.index_t, **common)
            results[r["slabs_dtype"]].setdefault(
                vn_launch("banded_chain_stream", op.scales) + "_bf16", []).append(r)
        xc = torch.randn((c.v_pad, n), generator=gen, device="cuda").bfloat16()
        results["f32"].setdefault("vn_pair_resident_bf16", []).append(check_vn_bf16(
            torch, "banded_cheb_pair", c.slabs, c.lo, xc, index=c.index, **common))
        del x, g, xc
    del b16, a_csr16
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    emit({"phase": "kernels_bf16", "part": "vn_100k", "seconds": time.perf_counter() - t0,
          "tolerance": {"rel": BF16_REL, "whole_pair_or_chain_rel": BF16_LOOSE,
                        "floor": KERNEL_TOL},
          "library_bf16": "torch.sparse.mm (bf16 CSR)" if lib_error is None else None,
          "library_bf16_error": lib_error, "bf16_pack": pack, "bf16_index": index,
          "results": results})
    return results


# --------------------------------------------------------------------------
# the fused forward in bf16: the bf16 variants of K1f-K4f (the gate GEMM and
# tail_h_kernel on bf16 operands) and fused_sparse_forward of a bf16 model
# --------------------------------------------------------------------------

BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 on the tensor cores (NVIDIA data sheet)
FUSED_BF16_META = {
    "head_fwd_bf16": ("K1f bf16", "stgcn_tpu_torch/kernels/csrc/gate_gemm_bf16.cu",
                      "stgcn_tpu/kernels/vertex_fused.py:610", "_head_pallas"),
    "tail_fwd_bf16": ("K2f bf16", "stgcn_tpu_torch/kernels/csrc/vertex_fused.cu",
                      "stgcn_tpu/kernels/vertex_fused.py:839", "_tail_pallas"),
    "ohead_fwd_bf16": ("K3f bf16", "stgcn_tpu_torch/kernels/csrc/gate_gemm_bf16.cu",
                       "stgcn_tpu/kernels/output_head.py:214", "_ohead_pallas"),
    "ofc_fwd_bf16": ("K4f bf16", "stgcn_tpu_torch/kernels/csrc/gate_gemm_bf16.cu",
                     "stgcn_tpu/kernels/output_head.py:407", "_ofc_pallas"),
}
PER_BATCH_FWD_BF16 = {f"{k}_bf16": n for k, n in PER_BATCH_FWD.items()}
# (B, V, Vp) of the forecast path's kernel calls: PeMSD7(M) at batch 32, the
# 100k graph at batch 8 (the banded operator's Vp), the 1M graph at batch 1
FUSED_BF16_SHAPES = {"pemsd7m": (BATCH, 228, 256), "100k": (8, 100_000, 101_376),
                     "1m": (1, 1_000_000, 1_000_192)}
FUSED_BF16_REPS = {"pemsd7m": 30, "100k": 5, "1m": 3}


def fused_bf16_cases(torch, gen, b: int, v_true: int, vp: int, gtu: bool):
    """(f32 kernel name, label, config, float32 arguments, kwargs) of each
    K1f-K4f call of a forecast (and a training step's dropout) at one shape,
    the main.py widths: K1f and K2f at both blocks (block 2's head drops out
    its input), K3f with the glu gate (and gtu with ``gtu``), K4f; random
    inputs, the LayerNorm affine zero on padded lanes."""
    from stgcn_tpu_torch.kernels import output_head as oh
    from stgcn_tpu_torch.kernels import vertex_fused as vf
    from stgcn_tpu_torch.kernels.dropout import Drop

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def ln(t, c):
        g, bb = 1.0 + rnd(c, vp, scale=0.1), rnd(c, vp, scale=0.1)
        g[:, v_true:] = 0.0
        bb[:, v_true:] = 0.0
        return rnd(b, t, 1, 1, scale=0.1), 0.5 + torch.rand((b, t, 1, 1), generator=gen,
                                                            device="cuda"), g, bb

    out = []
    for blk, (t_in, c_in) in enumerate([(12, 1), (8, 64)]):
        cfg = vf.VertexBlockCfg(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                                v_true=v_true, v_pad=vp, t_in=t_in, c_in=c_in, c0=64, c1=16,
                                c2=64, apply_ln=blk > 0)
        lnv = ln(t_in, c_in) if blk else (None,) * 4
        out.append(("head_fwd", f"block{blk}", cfg,
                    (rnd(b, t_in, c_in, vp), *lnv, rnd(3, c_in, 128, scale=(3 * c_in) ** -0.5),
                     rnd(128, scale=0.1), rnd(64, 16, scale=0.125), rnd(16, scale=0.1)),
                    {"drop": Drop(DROPRATE, 11, blk)} if blk else {}))
        out.append(("tail_fwd", f"block{blk}", cfg,
                    (*(rnd(b, cfg.t1, 16, vp) for _ in range(3)), rnd(3, 16, 16, scale=0.25),
                     rnd(16, scale=0.1), rnd(3, 16, 128, scale=48 ** -0.5),
                     rnd(128, scale=0.1)), {}))
    for act in ("glu", "gtu") if gtu else ("glu",):
        ocfg = oh.OutHeadCfg(ko=4, c_in=64, c0=128, c1=128, c_end=1, act_func=act,
                             v_true=v_true, v_pad=vp)
        label = "head" if act == "glu" else "head-gtu"
        out.append(("ohead_fwd", label, ocfg,
                    (rnd(b, 4, 64, vp), *ln(4, 64), rnd(4, 64, 256, scale=256 ** -0.5),
                     rnd(256, scale=0.1)), {"drop": Drop(DROPRATE, 11, 2)}))
        if act == "glu":   # K4f's gate is fc1's ReLU whatever the model's gate
            out.append(("ofc_fwd", label, ocfg,
                        (rnd(b, 1, 128, vp), *ln(1, 128), rnd(128, 128, scale=128 ** -0.5),
                         rnd(128, scale=0.1), rnd(128, 1, scale=128 ** -0.5),
                         rnd(1, scale=0.1)), {"drop": Drop(DROPRATE, 11, 3)}))
    return out


def check_fused_bf16(torch, name, label, cfg, args32, kwargs, reps: int) -> dict:
    """One bf16 forward kernel call: held to its plain version in bf16
    (``kernels/bf16_bounds.py``: 2 ulps of bf16 beside the rounding scale of
    the terms, neighbours rare), a repeat launch bit-identical, two launches
    counted under its ``_bf16`` name and none under the float32 kernel's;
    timed (CUDA-event medians) beside the float32 kernel on the same values
    and the plain version, with both bounds (operations at the bf16 tensor
    cores' rate, the type of its products, and at the float32 FMA rate,
    which it runs on)."""
    import dataclasses

    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels import bf16_bounds as bb
    from stgcn_tpu_torch.kernels import output_head as oh
    from stgcn_tpu_torch.kernels import vertex_fused as vf
    from stgcn_tpu_torch.kernels.fwd_ab import F32_ARGS

    cfg16 = dataclasses.replace(cfg, precision="bfloat16")
    args = tuple(t if i + 1 in F32_ARGS[name] or t is None else t.to(torch.bfloat16)
                 for i, t in enumerate(args32))
    mod = oh if name in ("ohead_fwd", "ofc_fwd") else vf
    wrapper = getattr(mod, name)
    n16 = f"{name}_bf16"
    if name == "head_fwd":
        ln = args[1:5] if cfg.apply_ln else None
        plain = lambda: vf.head_reference(cfg16, args[0], ln, args[5:], kwargs.get("drop"))
        scale = lambda: bb.head_scale(cfg16, args[0], ln, args[5:], kwargs.get("drop"))
    elif name == "tail_fwd":
        terms = list(args[1:3])[: cfg.n_terms]
        plain = lambda: vf.tail_reference(cfg16, args[0], terms, args[3:])
        scale = lambda: bb.tail_scale(cfg16, args[0], terms, args[3:])
    else:
        ref_fn = getattr(oh, name.replace("_fwd", "_reference"))
        scale_fn = getattr(bb, name.replace("_fwd", "_scale"))
        plain = lambda: ref_fn(cfg16, *args, **kwargs)
        scale = lambda: scale_fn(cfg16, *args, **kwargs)
    before = kernels.launch_counts()
    out1 = wrapper(cfg16, *args, **kwargs)
    out2 = wrapper(cfg16, *args, **kwargs)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    if after[n16] - before[n16] != 2 or after[name] != before[name]:
        raise AssertionError(f"{n16} [{label}]: launches {n16} +{after[n16] - before[n16]}, "
                             f"{name} +{after[name] - before[name]}; expected +2, +0")
    if not all(torch.equal(p, q) for p, q in zip(flat(out1), flat(out2))):
        raise AssertionError(f"{n16} [{label}]: a repeat launch is not bit-identical")
    del out2
    try:
        check = bb.within(out1, plain(), scale())
    except AssertionError as e:
        raise AssertionError(f"{n16} [{label}]: {e}") from None
    warm = min(3, reps)
    ms = cuda_ms(lambda: wrapper(cfg16, *args, **kwargs), warmup=warm, reps=reps)
    f32_ms = cuda_ms(lambda: wrapper(cfg, *args32, **kwargs), warmup=warm, reps=reps)
    plain_ms = cuda_ms(plain, warmup=1, reps=min(reps, 5))
    nbytes = io_bytes(args, out1)
    flops = flops_of(name, cfg, args[0].shape[0])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t16, t32 = flops / BF16_FLOP_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"shape": label, "input": list(args[0].shape), "output": list(flat(out1)[0].shape),
            "dropout": kwargs.get("drop") is not None, **check, "ms": ms, "f32_ms": f32_ms,
            "plain_ms": plain_ms, "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t16), "bound_by": "bytes" if t_bytes >= t16 else "operations",
            "bound_ms_f32_fma": max(t_bytes, t32),
            "bound_by_f32_fma": "bytes" if t_bytes >= t32 else "operations"}


def phase_kernels_bf16_fused(torch) -> dict:
    """``kernels_bf16`` part ``fused_fwd``: K1f-K4f's bf16 variants at every
    forecast-path shape (``FUSED_BF16_SHAPES``), random bf16 inputs, the gtu
    gate beside glu at PeMSD7(M), dropout on for K1f block 2, K3f and K4f
    (``check_fused_bf16``). Returns, per shape, per bf16 kernel name, the
    calls' measurements."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels import bf16_bounds as bb

    gen = torch.Generator(device="cuda").manual_seed(7)
    results: dict[str, dict] = {}
    for shape, (b, v_true, vp) in FUSED_BF16_SHAPES.items():
        per: dict[str, list] = {}
        for name, label, cfg, args32, kwargs in fused_bf16_cases(torch, gen, b, v_true, vp,
                                                                  gtu=shape == "pemsd7m"):
            per.setdefault(f"{name}_bf16", []).append(check_fused_bf16(
                torch, name, label, cfg, args32, kwargs, FUSED_BF16_REPS[shape]))
            del args32
        results[shape] = per
        free(torch)
    kernels.reset_launch_counts()
    emit({"phase": "kernels_bf16", "part": "fused_fwd", "seconds": time.perf_counter() - t0,
          "tolerance": {"rel": bb.REL, "floor": bb.FLOOR, "rare_outside_2ulp": bb.RARE,
                        "scale": "kernels/bf16_bounds.py"},
          "shapes": {k: list(v) for k, v in FUSED_BF16_SHAPES.items()}, "results": results})
    return results


# --------------------------------------------------------------------------
# fused training in bf16: the bf16 variants of K1b-K4b (bwd_blocks_bf16.cu)
# --------------------------------------------------------------------------

FUSED_BF16_BWD_META = {
    "head_bwd_bf16": ("K1b bf16", "stgcn_tpu_torch/kernels/csrc/bwd_blocks_bf16.cu",
                      "stgcn_tpu/kernels/vertex_fused.py:654", "_head_pallas_bwd"),
    "tail_bwd_bf16": ("K2b bf16", "stgcn_tpu_torch/kernels/csrc/bwd_blocks_bf16.cu",
                      "stgcn_tpu/kernels/vertex_fused.py:883", "_tail_pallas_bwd"),
    "ohead_bwd_bf16": ("K3b bf16", "stgcn_tpu_torch/kernels/csrc/bwd_blocks_bf16.cu",
                       "stgcn_tpu/kernels/output_head.py:253", "_ohead_pallas_bwd"),
    "ofc_bwd_bf16": ("K4b bf16", "stgcn_tpu_torch/kernels/csrc/bwd_blocks_bf16.cu",
                     "stgcn_tpu/kernels/output_head.py:440", "_ofc_pallas_bwd"),
}
PER_STEP_BF16 = {f"{k}_bf16": n for k, n in PER_STEP.items()}
# the arguments (1-based, as fwd_ab.F32_ARGS) of each backward call that stay
# float32 in bf16: the statistics, the biases, the LayerNorm-partial
# cotangents and K4b's output cotangent
F32_ARGS_BWD = {"head_bwd": {2, 3, 7, 9}, "tail_bwd": {5, 7, 9, 10},
                "ohead_bwd": {2, 3, 7, 9, 10}, "ofc_bwd": {2, 3, 7, 9, 10}}


def fused_bf16_bwd_cases(torch, gen, b: int, v_true: int, vp: int, gtu: bool):
    """(float32 kernel name, label, config, float32 arguments, kwargs) of each
    K1b-K4b call of a training step at one shape: the forward calls of
    ``fused_bf16_cases`` with their output cotangents (the LayerNorm-partial
    ones at a step's scale), dropout on where a step has it, the relu gate
    beside glu (and gtu with ``gtu``) for K1b block 2 and K3b."""
    import dataclasses

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    out = []
    for name, label, cfg, args, kwargs in fused_bf16_cases(torch, gen, b, v_true, vp, gtu):
        bwd = name.replace("_fwd", "_bwd")
        if name == "head_fwd":
            out.append((bwd, label, cfg, (*args, rnd(b, cfg.t1, cfg.c1, vp)), kwargs))
            if cfg.apply_ln:   # relu: the gate channels are c0 alone
                rcfg = dataclasses.replace(cfg, act_func="relu")
                rargs = (*args[:5], rnd(3, 64, 64, scale=192 ** -0.5), rnd(64, scale=0.1),
                         *args[7:], rnd(b, cfg.t1, cfg.c1, vp))
                out.append((bwd, f"{label}-relu", rcfg, rargs, kwargs))
        elif name == "tail_fwd":
            stat = (b, cfg.t2, 1, 1)
            out.append((bwd, label, cfg, (*args, rnd(b, cfg.t2, cfg.c2, vp),
                                          rnd(*stat, scale=1e-2), rnd(*stat, scale=1e-2)),
                        kwargs))
        elif name == "ohead_fwd":
            cot = (rnd(b, 1, cfg.c0, vp), rnd(b, 1, 1, 1, scale=1e-2), rnd(b, 1, 1, 1, scale=1e-2))
            out.append((bwd, label, cfg, (*args, *cot), kwargs))
            if label == "head":
                rcfg = dataclasses.replace(cfg, act_func="relu")
                rargs = (*args[:5], rnd(4, 64, 128, scale=256 ** -0.5), rnd(128, scale=0.1))
                out.append((bwd, "head-relu", rcfg, (*rargs, *cot), kwargs))
        else:
            out.append((bwd, label, cfg, (*args, rnd(b, 1, cfg.c_end, vp)), kwargs))
    return out


def bf16_bwd_plain(name: str, cfg, args, kwargs):
    """(plain version, bf16 rounding scales) of one bf16 backward call, its
    outputs laid out as the wrapper returns them."""
    from stgcn_tpu_torch.kernels import bf16_bounds as bb
    from stgcn_tpu_torch.kernels import output_head as oh
    from stgcn_tpu_torch.kernels import vertex_fused as vf

    drop = kwargs.get("drop")
    if name == "head_bwd":
        ln = args[1:5] if cfg.apply_ln else None
        return (lambda: vf.head_bwd_reference(cfg, args[0], ln, args[5:9], args[9], drop),
                lambda: bb.head_bwd_scale(cfg, args[0], ln, args[5:9], args[9], drop))
    if name == "tail_bwd":
        terms = list(args[1:3])[: cfg.n_terms]
        pad = 2 - len(terms)

        def plain():   # the zero gradient of a term the tail does not read, as the wrapper's
            dxg, dterms, *dw = vf.tail_bwd_reference(cfg, args[0], terms, args[3:7], *args[7:])
            return (dxg, *dterms, *[args[0].new_zeros(args[0].shape)] * pad, *dw)

        def scale():
            m_dxg, m_dt = bb.tail_bwd_scale(cfg, args[0], terms, args[3:7], *args[7:])
            return [m_dxg, *m_dt, *[args[0].new_zeros(args[0].shape).float()] * pad]
        return plain, scale
    ref_fn = getattr(oh, f"{name}_reference")
    scale_fn = getattr(bb, f"{name}_scale")
    return lambda: ref_fn(cfg, *args, **kwargs), lambda: scale_fn(cfg, *args, **kwargs)


def check_fused_bf16_bwd(torch, name, label, cfg, args32, kwargs, reps: int) -> dict:
    """One bf16 backward kernel call: its bf16 outputs held to its plain
    version in bf16 (``bf16_bounds.within``: 2 ulps beside the rounding scale,
    neighbours rare), its float32 ones (weight gradients, the statistics'
    gradients) within 2^-8 in relative L2 (``within_grads``); a repeat launch
    bit-identical, two launches counted under its ``_bf16`` name and none
    under the float32 kernel's; timed (CUDA-event medians) beside the float32
    kernel on the same values and the plain version, with both bounds (the
    bf16 tensor cores' rate, the type of its products, and the float32 FMA
    rate it runs on; the backward counts 3× the forward's operations)."""
    import dataclasses

    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels import bf16_bounds as bb

    cfg16 = dataclasses.replace(cfg, precision="bfloat16")
    args = tuple(t if i + 1 in F32_ARGS_BWD[name] or t is None else t.to(torch.bfloat16)
                 for i, t in enumerate(args32))
    wrapper = kernels.WRAPPERS[name]
    n16 = f"{name}_bf16"
    plain, scale = bf16_bwd_plain(name, cfg16, args, kwargs)
    before = kernels.launch_counts()
    out1 = wrapper(cfg16, *args, **kwargs)
    out2 = wrapper(cfg16, *args, **kwargs)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    if after[n16] - before[n16] != 2 or after[name] != before[name]:
        raise AssertionError(f"{n16} [{label}]: launches {n16} +{after[n16] - before[n16]}, "
                             f"{name} +{after[name] - before[name]}; expected +2, +0")
    if not all(p is None or torch.equal(p, q) for p, q in zip(out1, out2)):
        raise AssertionError(f"{n16} [{label}]: a repeat launch is not bit-identical")
    del out2
    try:
        check = bb.within_grads(out1, plain(), scale())
    except AssertionError as e:
        raise AssertionError(f"{n16} [{label}]: {e}") from None
    warm = min(3, reps)
    ms = cuda_ms(lambda: wrapper(cfg16, *args, **kwargs), warmup=warm, reps=reps)
    f32_ms = cuda_ms(lambda: wrapper(cfg, *args32, **kwargs), warmup=warm, reps=reps)
    plain_ms = cuda_ms(plain, warmup=1, reps=min(reps, 5))
    nbytes = io_bytes(args, out1)
    flops = flops_of(name, cfg, args[0].shape[0])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t16, t32 = flops / BF16_FLOP_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"shape": label, "act": cfg.act_func, "input": list(args[0].shape),
            "dropout": kwargs.get("drop") is not None, **check, "ms": ms, "f32_ms": f32_ms,
            "plain_ms": plain_ms, "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t16), "bound_by": "bytes" if t_bytes >= t16 else "operations",
            "bound_ms_f32_fma": max(t_bytes, t32),
            "bound_by_f32_fma": "bytes" if t_bytes >= t32 else "operations"}


def phase_kernels_bf16_fused_bwd(torch) -> dict:
    """``kernels_bf16`` part ``fused_bwd``: K1b-K4b's bf16 variants at every
    shape of ``FUSED_BF16_SHAPES`` (PeMSD7(M) batch 32, 100k batch 8, 1M
    batch 1), random bf16 inputs and cotangents, dropout on where a step has
    it, the glu, relu (and at PeMSD7(M) gtu) gates (``check_fused_bf16_bwd``).
    Returns, per shape, per bf16 kernel name, the calls' measurements."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels import bf16_bounds as bb

    gen = torch.Generator(device="cuda").manual_seed(9)
    results: dict[str, dict] = {}
    failed = []   # every call is checked before the phase fails
    for shape, (b, v_true, vp) in FUSED_BF16_SHAPES.items():
        per: dict[str, list] = {}
        for name, label, cfg, args32, kwargs in fused_bf16_bwd_cases(torch, gen, b, v_true, vp,
                                                                      gtu=shape == "pemsd7m"):
            try:
                per.setdefault(f"{name}_bf16", []).append(check_fused_bf16_bwd(
                    torch, name, label, cfg, args32, kwargs, FUSED_BF16_REPS[shape]))
            except AssertionError as e:
                failed.append(f"{shape}: {e}")
            del args32
            free(torch)
        results[shape] = per
    if failed:
        raise AssertionError("; ".join(failed))
    kernels.reset_launch_counts()
    emit({"phase": "kernels_bf16", "part": "fused_bwd", "seconds": time.perf_counter() - t0,
          "tolerance": {"rel": bb.REL, "floor": bb.FLOOR, "rare_outside_2ulp": bb.RARE,
                        "float32_outputs_rel_l2": bb.GRAD_REL, "scale": "kernels/bf16_bounds.py"},
          "shapes": {k: list(v) for k, v in FUSED_BF16_SHAPES.items()}, "results": results})
    return results


def fused_steps(torch, state: dict, make_model, gop, batches, opt: str) -> dict:
    """The same few fused training steps from the float32 weights ``state``,
    in float32 and in bf16 (``STGCN(dtype=bfloat16)``, its float32 master
    weights loaded from ``state``), each on ``batches`` [(x, y, n_valid)]
    with the step's dropout seed and the optimizer ``opt`` (lr 1e-3, weight
    decay 1e-3): losses, step seconds (host clock, synchronised), the bf16
    run's launches and its peak memory over the steps."""
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels.dropout import step_seed
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.train import masked_mse
    from stgcn_tpu_torch.train.optim import apply_updates, make_optimizer

    out = {}
    for dt in ("f32", "bf16"):
        m = make_model(torch.bfloat16 if dt == "bf16" else None)
        m.load_state_dict(state)
        p = dict(m.named_parameters())
        tx = make_optimizer(opt, lr=1e-3, weight_decay=1e-3)
        st = tx.init(p)
        losses, secs = [], []
        free(torch)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for i, (x, y, nv) in enumerate(batches):
            t1 = time.perf_counter()
            pred = fused_sparse_forward(p, x, gop, m, deterministic=False, seed=step_seed(42, i))
            loss = masked_mse(pred.reshape(x.shape[0], -1), y, nv)
            grads = torch.autograd.grad(loss, list(p.values()))
            updates, st = tx.update(dict(zip(p, grads)), st, p)
            apply_updates(p, updates)
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
        out[dt] = {"losses": losses, "step_seconds": secs,
                   "launches": kernels.launch_counts(),
                   "peak_memory_bytes": torch.cuda.max_memory_allocated() - base}
        del m, p, st, grads
    rel = [abs(a - b) / abs(b) for a, b in zip(out["bf16"]["losses"], out["f32"]["losses"])]
    if not all(r <= BF16_LOSS_RTOL for r in rel):
        raise AssertionError(f"fused bf16 step losses {out['bf16']['losses']} against the float32 "
                             f"ones {out['f32']['losses']}: relative {rel} > {BF16_LOSS_RTOL}")
    out["loss_rel_diff"] = rel
    return out


def phase_fused_bf16_train(torch, data, pb, f32_fit: dict) -> dict:
    """Fused training in bf16 on the dense operator: a 3-epoch PeMSD7(M)
    ``Trainer.fit`` of ``STGCN(dtype=bfloat16)`` with ``fused=True,
    compute_dtype="bfloat16"`` from phase ``train``'s weights, batches and
    dropout masks (its seed), whose epoch and validation losses lie within
    rtol 0.08 of that phase's float32 fused fit; launches per step K1f-K4f
    and K1b-K4b bf16 as the float32 route runs them and no float32 kernel;
    validation on the unfused model (no launch); ``test()``; step seconds and
    peak memory. Its validation losses, which even the two float32 fits do not
    hold to each other within rtol 0.08, must lie below the largest either
    float32 fit reached, widened by 0.08. Then three PEMS-BAY batch-512 fused
    steps (AdamW), bf16 against float32 from the same weights
    (``fused_steps``)."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.train import TrainConfig, Trainer

    n_vertex, gop = data["n_vertex"], data["gop"]
    ckpt_root = ROOT / "checkpoints" / "chip_smoke"   # git-ignored, removed at the end
    shutil.rmtree(ckpt_root, ignore_errors=True)
    state = new_model(torch, n_vertex, DROPRATE).state_dict()
    model = new_model(torch, n_vertex, DROPRATE, dtype=torch.bfloat16)
    model.load_state_dict(state)
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=DROPRATE, batch_size=BATCH,
                      fused=True, compute_dtype="bfloat16", ckpt_dir=str(ckpt_root / "bf16"),
                      dataset_name="pemsd7-m")
    tr = Trainer(cfg, model, gop, data["train"], data["val"], data["test"], data["scaler"],
                 device="cuda")
    free(torch)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hist = tr.fit(3)["history"]
    peak = torch.cuda.max_memory_allocated() - base
    launches = kernels.launch_counts()
    want = expected(PER_STEP_BF16, 3 * tr.steps_per_epoch)
    if launches != want:
        raise AssertionError(f"fused_bf16_train: the fit launched {launches}, expected {want}")
    kernels.reset_launch_counts()
    tr.validate()
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"fused_bf16_train: validation launched {kernels.launch_counts()}")
    losses = {k: [h[k] for h in hist] for k in ("train_loss", "val_loss")}
    ref = {"train_loss": f32_fit["train_loss_fused"], "val_loss": f32_fit["val_loss_fused"]}
    rel = {k: [abs(a - b) / abs(b) for a, b in zip(losses[k], ref[k])] for k in losses}
    if len(losses["train_loss"]) != 3 or max(rel["train_loss"]) > BF16_LOSS_RTOL:
        raise AssertionError(f"fused_bf16_train: epoch losses {losses['train_loss']} against the "
                             f"float32 fit's {ref['train_loss']}")
    # An epoch's validation loss reads one point of a trajectory that 831 AdamW
    # steps make chaotic: the float32 fused and unfused fits, the same function
    # in another order of float32 sums (their first 20 step losses within 1e-5),
    # end their epochs up to 29 % apart in it (PERF.md §6). So it is held
    # to the float32 routes' range: no epoch's above the largest either float32
    # fit reached, widened by the loss rtol.
    f32_val = [*f32_fit["val_loss_fused"], *f32_fit["val_loss_unfused"]]
    val_top = max(f32_val) * (1.0 + BF16_LOSS_RTOL)
    if not all(v == v and v <= val_top for v in losses["val_loss"]):
        raise AssertionError(f"fused_bf16_train: validation losses {losses['val_loss']} above the "
                             f"float32 fits' range {f32_val} (by more than rtol {BF16_LOSS_RTOL})")
    spread = [abs(a - b) / abs(b) for a, b in zip(f32_fit["val_loss_unfused"],
                                                   f32_fit["val_loss_fused"])]
    test = tr.test()
    if not all(v == v and abs(v) < float("inf") for v in test.values()):
        raise AssertionError(f"fused_bf16_train: non-finite test metrics {test}")
    steps = tr.steps_per_epoch
    del tr, model
    shutil.rmtree(ckpt_root, ignore_errors=True)
    free(torch)

    # PEMS-BAY at batch 512, dense operator
    vb = pb["n_vertex"]
    pb_steps = fused_steps(torch, new_model(torch, vb, DROPRATE).state_dict(),
                           lambda dt: new_model(torch, vb, DROPRATE, dtype=dt), pb["gop"],
                           [(pb["x"], pb["y"], BATCH_PEMS_BAY)] * 3, "adamw")
    if pb_steps["bf16"]["launches"] != expected(PER_STEP_BF16, 3):
        raise AssertionError(f"fused_bf16_train (PEMS-BAY): launches "
                             f"{pb_steps['bf16']['launches']}")
    result = {"phase": "fused_bf16_train", "seconds": time.perf_counter() - t0,
              "route": "Trainer(fused=True, compute_dtype='bfloat16'), dense operator",
              "dataset": "pemsd7-m", "batch_size": BATCH, "droprate": DROPRATE,
              "steps_per_epoch": steps, **losses, "train_loss_f32": ref["train_loss"],
              "val_loss_f32": ref["val_loss"], "loss_rel_diff": rel,
              "loss_rtol": BF16_LOSS_RTOL, "val_loss_f32_unfused": f32_fit["val_loss_unfused"],
              "val_rel_diff_f32_fused_vs_unfused": spread, "val_loss_ceiling": val_top,
              "epoch_seconds": [h["epoch_time_s"] for h in hist],
              "step_seconds": [h["epoch_time_s"] / steps for h in hist],
              "step_seconds_f32": [e / steps for e in f32_fit["epoch_seconds_fused"]],
              "peak_memory_bytes_fit": peak, "launches": launches,
              "test": test, "test_f32": f32_fit["test_fused"],
              "pems_bay": {"batch_size": BATCH_PEMS_BAY, "n_vertex": vb, "optimizer": "adamw",
                           **pb_steps}}
    emit(result)
    return result


def bf16_agree(torch, label: str, got, ref) -> float:
    """max |Δ| of a bf16 forecast from ``ref``; raises outside the JAX
    package's bf16 bound, atol 0.1, rtol 0.05."""
    if got.shape != ref.shape or got.dtype != torch.float32 or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} against "
                             f"{tuple(ref.shape)}, or non-finite values")
    d = (got - ref).abs()
    if not bool((d <= BF16_MODEL_ATOL + BF16_MODEL_RTOL * ref.abs()).all()):
        raise AssertionError(f"{label}: max |Δ| {float(d.max()):.3e} outside atol "
                             f"{BF16_MODEL_ATOL}, rtol {BF16_MODEL_RTOL}")
    return float(d.max())


def dense_bf16_product(torch, gop, gen) -> dict:
    """The dense operator's bf16 graph product (``torch.matmul`` of a bf16
    operand and the GSO cast to bf16, as ``DenseGraphOp.apply_cv`` runs it)
    at the PeMSD7(M) block-1 shape, with PyTorch's
    ``allow_bf16_reduced_precision_reduction`` on (its default) and off:
    each one's max |Δ| from the exact products summed in float32 and
    rounded once (what the TPU's f32 accumulation gives up to the order),
    and from each other. The flag is restored."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    x = torch.randn((BATCH, N_HIS - 2, 16, gop.v_pad), generator=gen,
                    device="cuda").bfloat16()
    ref = gop.apply_cv(x.float()).bfloat16().float()
    out = {}
    try:
        for on in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on
            out[on] = gop.apply_cv(x).float()
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    return {"shape": list(x.shape), "flag_default": flag,
            "max_abs_diff_flag_on": float((out[True] - ref).abs().max()),
            "max_abs_diff_flag_off": float((out[False] - ref).abs().max()),
            "max_abs_diff_on_off": float((out[True] - out[False]).abs().max()),
            "ref_max": float(ref.abs().max())}


def phase_fused_bf16(torch, data, pb) -> dict:
    """The fused forward of a bf16 model (``STGCN(dtype=bfloat16)``, the
    weights of phase 5's model) through K1f-K4f's bf16 variants on the
    dense operator: the PeMSD7(M) test split and a PEMS-BAY batch of 512,
    each held to the unfused bf16 model's forecast and to the float32 fused
    forecast (``bf16_agree``), launches per batch K1f-K4f bf16 as K1f-K4f
    run in float32 and no float32 K1f-K4f; forecast seconds of the bf16 and
    float32 fused routes in turns; the dense bf16 product with PyTorch's
    reduced-precision reduction on and off (``dense_bf16_product``)."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
    from stgcn_tpu_torch.train import evaluate_metrics

    test_ds, scaler, gop, v = data["test"], data["scaler"], data["gop"], data["n_vertex"]
    models = {"bf16": new_model(torch, v, DROPRATE, dtype=torch.bfloat16).eval(),
              "f32": new_model(torch, v, DROPRATE).eval()}
    params = {k: m.state_dict() for k, m in models.items()}
    preds: dict[str, list] = {"fused_bf16": [], "unfused_bf16": [], "fused_f32": []}

    def predictor(kind):
        def predict(starts):
            x, y = gather_windows(test_ds.series, starts, N_HIS, N_PRED)
            dt = "f32" if kind == "fused_f32" else "bf16"
            out = (fused_sparse_forward(params[dt], x, gop, models[dt])
                   if kind.startswith("fused") else models[dt](x, gop))
            preds[kind].append(out.reshape(len(starts), -1))
            return preds[kind][-1], y
        return predict

    with torch.inference_mode():
        starts0, _ = next(test_ds.batches(BATCH))   # warm-up
        for kind in preds:
            predictor(kind)(starts0)
            preds[kind].clear()
        torch.cuda.synchronize()
        n_batches = -(-test_ds.num_windows // BATCH)
        kernels.reset_launch_counts()
        m16 = evaluate_metrics(predictor("fused_bf16"), test_ds, scaler, BATCH)
        launches = kernels.launch_counts()
        for kind in ("unfused_bf16", "fused_f32"):
            evaluate_metrics(predictor(kind), test_ds, scaler, BATCH)
        walls: dict[str, list] = {"fused_bf16": [], "fused_f32": []}
        for kind in ("fused_bf16", "fused_f32", "fused_f32", "fused_bf16"):
            t1 = time.perf_counter()
            evaluate_metrics(predictor(kind), test_ds, scaler, BATCH)
            walls[kind].append(time.perf_counter() - t1)
    if launches != expected(PER_BATCH_FWD_BF16, n_batches):
        raise AssertionError(f"fused_bf16: launches {launches} != "
                             f"{expected(PER_BATCH_FWD_BF16, n_batches)}")
    if not all(x_ == x_ and abs(x_) < float("inf") for x_ in m16.values()):
        raise AssertionError(f"fused_bf16: non-finite metrics {m16}")
    n = n_batches   # the first evaluation of each kind
    pf16, pu16, pf32 = (torch.cat(preds[k][:n]) for k in ("fused_bf16", "unfused_bf16",
                                                         "fused_f32"))
    pemsd7 = {"batches": n_batches, "launches": launches, "metrics_fused_bf16": m16,
              "max_abs_diff_vs_unfused_bf16": bf16_agree(torch, "PeMSD7(M) vs unfused bf16",
                                                          pf16, pu16),
              "max_abs_diff_vs_fused_f32": bf16_agree(torch, "PeMSD7(M) vs fused f32",
                                                      pf16, pf32),
              "forecast_seconds": {k: statistics.median(w) for k, w in walls.items()},
              "forecast_seconds_all": walls}
    del preds, pf16, pu16, pf32

    # PEMS-BAY at batch 512 on its dense operator
    vb, gb, xb = pb["n_vertex"], pb["gop"], pb["x"]
    mb = {"bf16": new_model(torch, vb, DROPRATE, dtype=torch.bfloat16).eval(),
          "f32": new_model(torch, vb, DROPRATE).eval()}
    pbp = {k: m.state_dict() for k, m in mb.items()}
    with torch.inference_mode():
        fused_sparse_forward(pbp["bf16"], xb, gb, mb["bf16"])   # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        f16 = fused_sparse_forward(pbp["bf16"], xb, gb, mb["bf16"])
        torch.cuda.synchronize()
        launches_pb = kernels.launch_counts()
        u16 = mb["bf16"](xb, gb)
        f32 = fused_sparse_forward(pbp["f32"], xb, gb, mb["f32"])
        ms = {"fused_bf16": [], "fused_f32": []}
        for kind in ("fused_bf16", "fused_f32", "fused_f32", "fused_bf16"):
            dt = kind[-4:].replace("_", "")
            ms[kind].append(cuda_ms(lambda: fused_sparse_forward(pbp[dt], xb, gb, mb[dt]),
                                    warmup=2, reps=10))
    if launches_pb != expected(PER_BATCH_FWD_BF16, 1):
        raise AssertionError(f"fused_bf16 (PEMS-BAY): launches {launches_pb}")
    pems_bay = {"batch_size": BATCH_PEMS_BAY, "n_vertex": vb, "launches": launches_pb,
                "max_abs_diff_vs_unfused_bf16": bf16_agree(torch, "PEMS-BAY vs unfused bf16",
                                                            f16, u16),
                "max_abs_diff_vs_fused_f32": bf16_agree(torch, "PEMS-BAY vs fused f32", f16,
                                                        f32),
                "forward_ms": {k: statistics.median(v_) for k, v_ in ms.items()},
                "forward_ms_all": ms}
    del f16, u16, f32, mb, pbp
    product = dense_bf16_product(torch, gop, torch.Generator(device="cuda").manual_seed(8))
    kernels.reset_launch_counts()
    result = {"phase": "fused_bf16", "seconds": time.perf_counter() - t0,
              "route": "fused_sparse_forward(STGCN(dtype=bfloat16)), dense operator",
              "tolerance": {"atol": BF16_MODEL_ATOL, "rtol": BF16_MODEL_RTOL},
              "pemsd7m": pemsd7, "pems_bay": pems_bay, "dense_bf16_product": product}
    emit(result)
    return result


def bf16_fit(torch, data, gop, *, phase: str, remat: bool, batch: int, opt: str,
             per_step: dict, per_batch: dict, f32_fit: dict, dataset_name: str) -> dict:
    """A ``Trainer.fit(1)`` of the unfused ``STGCN(dtype=bfloat16, remat=)``
    (weights, batches and dropout masks those of the float32 fit
    ``f32_fit``): launches exactly ``per_step`` a step and ``per_batch`` a
    validation batch (so no graph product replayed under remat), no index
    rebuilt, finite losses and their distance from the float32 fit's, step
    seconds, the fit's peak memory, ``test()``; then one more step traced by
    ``torch.profiler`` (its kernels by name and device time, against the
    step's seconds: the device's busy share)."""
    from stgcn_tpu_torch.kernels import nnz_index
    from stgcn_tpu_torch.train import TrainConfig, Trainer

    ckpt_root = ROOT / "checkpoints" / f"chip_smoke_{phase}"   # removed at the end
    shutil.rmtree(ckpt_root, ignore_errors=True)
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=DROPRATE, batch_size=batch, opt=opt,
                      fused=False, compute_dtype="bfloat16", remat=remat,
                      ckpt_dir=str(ckpt_root), dataset_name=dataset_name)
    tr = Trainer(cfg, new_model(torch, data["n_vertex"], DROPRATE, dtype=torch.bfloat16,
                                remat=remat), gop,
                 data["train"], data["val"], data["test"], data["scaler"], device="cuda")
    base = torch.cuda.memory_allocated()
    builds = nnz_index.builds()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, hist, launches = timed_fit(torch, tr, phase)
    fit_peak = torch.cuda.max_memory_allocated()
    val_batches = -(-tr.val_ds.num_windows // batch)
    want = expected(per_step, tr.steps_per_epoch, (per_batch, val_batches))
    if launches != want:
        raise AssertionError(f"{phase} (remat {remat}): the fit launched {launches}, expected "
                             f"{want}")
    test_m = tr.test()
    if not all(v_ == v_ and abs(v_) < float("inf") for v_ in test_m.values()):
        raise AssertionError(f"{phase}: non-finite test metrics {test_m}")
    if nnz_index.builds() != builds:
        raise AssertionError(f"{phase}: the fit rebuilt a nonzero index")
    starts, n_valid = tr._plan(tr.train_ds)[0]
    trace = profile_once(torch, lambda: Trainer.train_step(tr, starts, n_valid, 0))
    trace["busy_share_of_median_step"] = trace["device_ms"] / 1e3 / statistics.median(seconds)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ref = f32_fit["step_losses"]
    out = {"step_losses": losses, "step_seconds": seconds,
           "step_seconds_median": statistics.median(seconds), "epoch": hist[0],
           "loss_rel_diff_vs_f32": [abs(a - b) / abs(b) for a, b in zip(losses, ref)],
           "launches": {k: n for k, n in launches.items() if n},
           "peak_memory_bytes_fit": fit_peak, "memory_bytes_before_fit": base,
           "steps_per_epoch": tr.steps_per_epoch, "val_batches": val_batches, "test": test_m,
           "trace_one_step": trace}
    del tr
    free(torch)
    return out


def phase_banded_100k_bf16(torch, data, f32_fit: dict) -> dict:
    """``bench.py:253-335`` (configs[3]) unfused, as ``--compute_dtype
    bfloat16 --remat True`` builds it: ``STGCN(dtype=bfloat16, remat=True)``
    over the float32 stream pack (a bf16 operand), batch 8, AdamW. Forecast
    batches of the bf16 model against the float32 model's on the same
    operator, within ``BF16_MODEL_ATOL`` / ``BF16_MODEL_RTOL``: on the
    stream pack (K9 pair bf16 ×2), the int8 pack (K9 pair int8 bf16 ×2),
    the clamped pack (K8 bf16 ×2) and, in a graph_conv model, the stream
    and int8 packs (K7 bf16, K7 int8 bf16 ×2); the int8 and clamped
    operators freed; every vn
    call of one training step (K9 pair and chain bf16, ×2 each) against its
    plain version in bf16; a ``Trainer.fit(1)`` with launches per step K9
    pair bf16 ×2 and chain bf16 ×2 and no float32 vn launch (remat replays
    no graph product), losses finite and within rtol 0.08 of the float32
    fit's (phase 13, same weights, batches and dropout masks), step seconds,
    the fit's peak memory, ``test()``; then the same fit without remat, for
    its step seconds and peak; one step of each traced (``bf16_fit``)."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows

    gop, v = data["gop"], data["n_vertex"]

    # 1. forecast batches: the bf16 model against the float32 one (same weights)
    # on each pack and graph conv; then the int8 and clamped operators go
    starts, _ = next(data["test"].batches(BATCH_100K))
    x, _ = gather_windows(data["test"].series, starts, N_HIS, N_PRED)
    q, c = data.pop("int8"), data.pop("clamped")
    forecast = {"tolerance_vs_f32": {"atol": BF16_MODEL_ATOL, "rtol": BF16_MODEL_RTOL}}
    for tag, gct, op, want in (
            ("stream_k9", "cheb_graph_conv", gop, PER_BATCH_100K_BF16),
            ("int8_k9", "cheb_graph_conv", q, {"vn_pair_int8_bf16": 2}),
            ("clamped_k8", "cheb_graph_conv", c, {"vn_pair_resident_bf16": 2}),
            ("graph_conv_k7", "graph_conv", gop, {"vn_single_bf16": 2}),
            ("graph_conv_int8_k7", "graph_conv", q, {"vn_single_int8_bf16": 2})):
        with torch.inference_mode():
            kernels.reset_launch_counts()
            p16 = new_model(torch, v, DROPRATE, gct, dtype=torch.bfloat16,
                            remat=True).eval()(x, op)
            torch.cuda.synchronize()
            fc_launches = kernels.launch_counts()
            p32 = new_model(torch, v, DROPRATE, gct).eval()(x, op)
        if fc_launches != expected(want, 1):
            raise AssertionError(f"the bf16 100k forecast {tag} launched {fc_launches}, "
                                 f"expected {expected(want, 1)}")
        if p16.dtype != torch.float32 or p16.shape != (BATCH_100K, 1, v, 1) \
                or not torch.isfinite(p16).all():
            raise AssertionError(f"the bf16 100k forecast {tag} is not finite float32 "
                                 "[B, 1, V, 1]")
        d = (p16 - p32).abs()
        if not bool((d <= BF16_MODEL_ATOL + BF16_MODEL_RTOL * p32.abs()).all()):
            raise AssertionError(f"the bf16 100k forecast {tag} differs from the float32 one: "
                                 f"max |Δ| {float(d.max()):.3e}")
        forecast[tag] = {"launches": {k: n for k, n in fc_launches.items() if n},
                         "max_abs_diff_vs_f32": float(d.max()),
                         "rel_l2_vs_f32": rel_l2(torch, p16, p32)}
        del p16, p32, d
    del q, c, op
    free(torch)

    # 2. every vn call of one bf16 remat training step, against its plain version
    calls = record_vn_step(torch, data, gop, new_model(torch, v, DROPRATE, dtype=torch.bfloat16,
                                                       remat=True))
    names = [vn_launch(name, kw.get("scales")) + "_bf16" for name, _, kw in calls]
    if sorted(names) != sorted(k for k, n in PER_STEP_100K_BF16.items() for _ in range(n)):
        raise AssertionError(f"one bf16 remat 100k step called {names}, expected "
                             f"{PER_STEP_100K_BF16}")
    a_csr16, _ = csr_bf16_on_card(torch, data["matrix"])
    per_call: dict[str, list] = {k: [] for k in PER_STEP_100K_BF16}
    failed = []
    for i, (name, args, kw) in enumerate(calls):
        try:
            per_call[names[i]].append({"call": f"call{i}", **check_vn_bf16(
                torch, name, *args, scales=kw.get("scales", kw.get("scales_t")),
                scale=kw.get("scale", 1.0), index=kw.get("index", kw.get("index_t")), v=v,
                nnz=data["prep"]["nnz"], a_csr16=a_csr16, reps=3)})
        except AssertionError as e:
            failed.append(f"call{i} ({names[i]}): {e}")
    if failed:
        raise AssertionError("; ".join(failed))
    del calls, a_csr16
    free(torch)

    # 3. the bf16 fit with remat, then without
    fits = {}
    for remat in (True, False):
        fits["remat" if remat else "no_remat"] = fit = bf16_fit(
            torch, data, gop, phase="banded_100k_bf16", remat=remat, batch=BATCH_100K,
            opt="adamw", per_step=PER_STEP_100K_BF16, per_batch=PER_BATCH_100K_BF16,
            f32_fit=f32_fit, dataset_name="road-100k")
        if len(fit["step_losses"]) != len(f32_fit["step_losses"]) \
                or max(fit["loss_rel_diff_vs_f32"]) > BF16_LOSS_RTOL:
            raise AssertionError(f"banded_100k_bf16 (remat {remat}): step losses "
                                 f"{fit['step_losses']} against the float32 fit's "
                                 f"{f32_fit['step_losses']}")
    if fits["remat"]["peak_memory_bytes_fit"] >= fits["no_remat"]["peak_memory_bytes_fit"]:
        raise AssertionError(f"banded_100k_bf16: remat did not lower the fit's peak: {fits}")
    result = {"phase": "banded_100k_bf16", "seconds": time.perf_counter() - t0, "n_vertex": v,
              "batch_size": BATCH_100K, "optimizer": "adamw",
              "route": "unfused, STGCN(dtype=bfloat16, remat=True), banded vn stream pack "
                       "(float32 slabs, bf16 operand: K9 bf16)",
              "cuts": ["one epoch", "a one-day series", "float32 slabs (the CLI's operator, "
                       "built without a dtype; the bench packs bf16: phase kernels_bf16)"],
              "forecast_one_batch": forecast, "fits": fits,
              "f32_fit": {"step_seconds_median": f32_fit["step_seconds_median"],
                          "peak_memory_bytes_fit": f32_fit["peak_memory_bytes_fit"]},
              "loss_rtol": BF16_LOSS_RTOL, "launches": fits["remat"]["launches"],
              "per_step_calls": per_call}
    emit(result)
    return result


def fused_bf16_forecast_1m(torch, data, gop, v: int) -> dict:
    """One 1M forecast batch of the bf16 model through ``fused_sparse_forward``
    on the BCSR operator (launches K1f-K4f bf16 as a batch runs them and
    ``bcsr_spmm_bf16`` ×2 a block), held to the float32 fused forecast
    (K1f-K4f and K10 in float32) and to the unfused bf16 model's
    (``bf16_agree``); the seconds of the bf16 and float32 fused forecasts in
    turns."""
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward

    models = {"bf16": new_model(torch, v, DROPRATE, dtype=torch.bfloat16).eval(),
              "f32": new_model(torch, v, DROPRATE).eval()}
    params = {k: m.state_dict() for k, m in models.items()}
    starts, _ = next(data["test"].batches(BATCH_1M))
    x, _ = gather_windows(data["test"].series, starts, N_HIS, N_PRED)

    def fused(dt):
        return fused_sparse_forward(params[dt], x, gop, models[dt])

    with torch.inference_mode():
        kernels.reset_launch_counts()
        f16 = fused("bf16")
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        f32 = fused("f32")
        u16 = models["bf16"](x, gop)
        walls: dict[str, list] = {"bf16": [], "f32": []}
        for dt in ("bf16", "f32", "f32", "bf16"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fused(dt)
            torch.cuda.synchronize()
            walls[dt].append(time.perf_counter() - t1)
    want = expected(PER_BATCH_FWD_BF16, 1, ({"bcsr_spmm_bf16": 4}, 1))
    if launches != want:
        raise AssertionError(f"bcsr_1m_bf16: the fused bf16 forecast launched {launches}, "
                             f"expected {want}")
    return {"launches": launches,
            "max_abs_diff_vs_fused_f32": bf16_agree(torch, "1M BCSR vs fused f32", f16, f32),
            "max_abs_diff_vs_unfused_bf16": bf16_agree(torch, "1M BCSR vs unfused bf16", f16,
                                                        u16),
            "seconds": {dt: statistics.median(w) for dt, w in walls.items()},
            "tolerance": {"atol": BF16_MODEL_ATOL, "rtol": BF16_MODEL_RTOL}}


def phase_bcsr_1m_bf16(torch, data, f32_fit: dict) -> dict:
    """The CLI's 1M route (``auto`` → BCSR, float32 tiles) with
    ``--compute_dtype bfloat16 --remat True``: the unfused
    ``STGCN(dtype=bfloat16, remat=True)`` at batch 1 with Lion (the cuts of
    phase 16). Every K10 call of one training step (×8, all bf16) recorded;
    a ``Trainer.fit(1)`` with launches per step K10 bf16 ×8, no float32 K10
    and no K11 (remat replays no graph product), finite losses within rtol
    0.08 of the float32 fit's (phase 18, same weights and batches), step
    seconds and peak memory beside the float32 fit's, ``test()``; the same
    without remat, whose peak must be the higher (``bf16_fit``). Then, as
    phase ``kernels_bf16`` part ``k10_1m``, K10's bf16 variant at each
    recorded call over the float32 tiles and over a bf16 pack
    (``bcsr_graph_op(dtype=bfloat16)``, 6.65 GB, built on the card beside
    the float32 one, timed, its index checked as in phase 17), each held
    against its plain version in bf16, repeat bit-identical, timed beside
    its bound (2-byte operands) and ``torch.sparse.mm`` on the bf16 CSR GSO
    where it takes bf16."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels import spmm
    from stgcn_tpu_torch.ops import bcsr_graph_op

    gop, v, nnz = data["bcsr"], data["n_vertex"], data["prep"]["nnz"]

    # 1. one step's K10 calls, then the fit with remat and without
    calls = record_bcsr_step(torch, data, gop, new_model(torch, v, DROPRATE,
                                                         dtype=torch.bfloat16, remat=True))
    if len(calls) != 8 or any(c[2].dtype != torch.bfloat16 for c in calls):
        raise AssertionError(f"one bf16 1M step made {len(calls)} K10 calls, expected 8 bf16")
    free(torch)
    fits = {("remat" if remat else "no_remat"): bf16_fit(
        torch, data, gop, phase="bcsr_1m_bf16", remat=remat, batch=BATCH_1M, opt="lion",
        per_step=PER_STEP_BCSR_BF16, per_batch=PER_BATCH_BCSR_BF16, f32_fit=f32_fit,
        dataset_name="road-1m") for remat in (True, False)}
    for remat, fit in fits.items():
        if len(fit["step_losses"]) != len(f32_fit["step_losses"]) \
                or max(fit["loss_rel_diff_vs_f32"]) > BF16_LOSS_RTOL:
            raise AssertionError(f"bcsr_1m_bf16 ({remat}): step losses {fit['step_losses']} "
                                 f"against the float32 fit's {f32_fit['step_losses']}")
    if fits["remat"]["peak_memory_bytes_fit"] >= fits["no_remat"]["peak_memory_bytes_fit"]:
        raise AssertionError(f"bcsr_1m_bf16: remat did not lower the fit's peak: {fits}")
    result = {"phase": "bcsr_1m_bf16", "n_vertex": v, "batch_size": BATCH_1M,
              "optimizer": "lion",
              "route": "unfused, STGCN(dtype=bfloat16, remat=True), BCSR (float32 tiles, bf16 "
                       "operand: K10 bf16)",
              "cuts": ["Lion momentum in f32 (TrainConfig has no mu_dtype)",
                       "series cut to 55 steps: 23 train (8 windows), 16 validation, 16 test"],
              "fits": fits, "step_losses_f32": f32_fit["step_losses"],
              "loss_rtol": BF16_LOSS_RTOL,
              "launches": fits["remat"]["launches"],
              "f32_fit": {"step_seconds_median": f32_fit["step_seconds_median"],
                          "peak_memory_bytes_fit": f32_fit["peak_memory_bytes_fit"]}}

    # 2. K10's bf16 variant at the step's calls, over the float32 and a bf16 pack
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    b16 = bcsr_graph_op(data["art"], dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    pack = {"bf16_pack_s": time.perf_counter() - t1, "pack_bytes": pack_bytes(b16.pack),
            "shared_transpose_pack": b16.pack_t is b16.pack,
            **index_info(torch, b16.pack, data["matrix"], transposed=False)}
    a_csr16, lib_error = csr_bf16_on_card(torch, data["matrix"])
    per_call: dict[str, list] = {"f32": [], "bf16": []}
    failed = []
    for label, pk, xv, scale in calls:
        for kind, p in (("f32", pk), ("bf16", b16.pack)):
            try:
                per_call[kind].append({"call": label, "tiles_dtype": kind, **check_spmm(
                    torch, spmm.LAUNCH_NAME_BF16, xv.shape[1], "single",
                    lambda p=p, xv=xv, scale=scale: spmm.bcsr_spmm(p, xv, scale=scale),
                    lambda p=p, xv=xv, scale=scale: spmm.bcsr_spmm_reference(p, xv,
                                                                              scale=scale),
                    None if a_csr16 is None else lambda xv=xv: torch.sparse.mm(a_csr16, xv[:v]),
                    v=v, nnz=nnz, vp=xv.shape[0], value_bytes=SLAB_BYTES[kind],
                    row_scales=False, pack_bytes=index_traffic(p, xv.shape[1], "single")[0],
                    pack_flops_one=index_traffic(p, xv.shape[1], "single")[1],
                    library_agrees=False, reps=3, vn=True, scale=scale, operand_bytes=2,
                    compare=bf16_err)})
            except AssertionError as e:
                failed.append(f"{label} ({kind} tiles): {e}")
    if failed:
        raise AssertionError("; ".join(failed))
    del calls, b16, a_csr16
    free(torch)

    # 3. one fused bf16 forecast batch on the same operator: K1f-K4f's bf16
    # variants around K10's, held to the float32 fused forecast and the
    # unfused bf16 model's
    result["fused_forecast"] = fused_bf16_forecast_1m(torch, data, gop, v)
    free(torch)

    # 4. three fused bf16 training steps (Lion, batch 1) on the same operator:
    # K1-K4 and K1b-K4b bf16 around K10's bf16 variant, losses within rtol
    # 0.08 of the float32 fused steps from the same weights
    from stgcn_tpu_torch.data import gather_windows

    batches = []
    for starts, n_valid in list(data["train"].batches(BATCH_1M))[:3]:
        xs, ys = gather_windows(data["train"].series, starts, N_HIS, N_PRED)
        batches.append((xs, ys, n_valid))
    steps = fused_steps(torch, new_model(torch, v, DROPRATE).state_dict(),
                        lambda dt: new_model(torch, v, DROPRATE, dtype=dt), gop, batches, "lion")
    want = expected(PER_STEP_BF16, 3, ({"bcsr_spmm_bf16": 8}, 3))
    if steps["bf16"]["launches"] != want:
        raise AssertionError(f"bcsr_1m_bf16: the fused bf16 steps launched "
                             f"{steps['bf16']['launches']}, expected {want}")
    result["fused_steps"] = {"optimizer": "lion", **steps}
    del batches
    free(torch)
    kernels.reset_launch_counts()
    emit({"phase": "kernels_bf16", "part": "k10_1m", "seconds": time.perf_counter() - t1,
          "tolerance": {"rel": BF16_REL, "floor": KERNEL_TOL},
          "library_bf16": "torch.sparse.mm (bf16 CSR)" if lib_error is None else None,
          "library_bf16_error": lib_error, "bf16_pack": pack,
          "where": "the 1M step's 8 calls (the bf16 pack fits beside the float32 one)",
          "results": per_call})
    result["seconds"] = time.perf_counter() - t0
    result["per_step_calls"] = per_call["f32"]
    result["per_step_calls_bf16_tiles"] = per_call["bf16"]
    emit(result)
    return result


# --------------------------------------------------------------------------
# the 1M-vertex blocked-ELL route (BASELINE.json configs[4]: bench.py:338-470)
# --------------------------------------------------------------------------

V_1M, BATCH_1M = 1_000_000, 1
# series steps: 8 training windows, one validation and one test window (a split
# of T steps holds T − n_his − n_pred windows, as the reference's loader has it)
SPLIT_1M = (23, 16, 16)
K6_REPS = 5
PER_STEP_1M = {**PER_STEP, "ell_int8_pair": 2, "ell_int8_chain": 2}
PER_BATCH_1M = {**PER_BATCH_FWD, "ell_int8_pair": 2}
K6_META = ("K6", "stgcn_tpu_torch/kernels/csrc/ell_nv.cu",
           "stgcn_tpu/kernels/ell_nv.py:123", "_ell_nv_pallas")


def pack_bytes(pack) -> int:
    """Bytes of the whole pack as stored: the tiles, cols, counts and an int8
    pack's lane factors (the nonzero index apart)."""
    meta = sum(t.numel() * t.element_size()
               for t in (pack.cols, pack.counts, getattr(pack, "scales", None)) if t is not None)
    return pack.data.numel() * pack.data.element_size() + meta


SECTOR_BYTES = 32


def index_traffic(pack, n: int, mode: str) -> tuple[int, int]:
    """(bytes, FLOPs per operand column) of one K5, K6, K7-K9 or K10 call of
    ``mode`` at width ``n`` as the kernel moves and does them, beyond each
    operand read and each output written once (which ``check_spmm`` adds):
    per application the nonzero index (row offsets, src, off), one 32-byte
    sector a value (a row's values lie a tile or slab row or more apart) and
    an int8 pack's row factors; for the nv kernels K5 and K6 also their
    passes over ``[N, V]`` operands, 4 bytes an element: the workspace
    written by the transpose and read by the gather, and in pair and chain
    the first pass's vn copy written and read back and x read again by the
    second pass's epilogue. The gathered x rows count once, as if the L2
    caught every re-read. FLOPs: 2 a nonzero. The index must be built."""
    from stgcn_tpu_torch.kernels.ell_nv import EllPack

    idx = pack.index
    if idx.src is None:
        raise AssertionError("index_traffic: the pack's nonzero index is not built")
    apps = 1 if mode == "single" else 2
    scales = getattr(pack, "scales", None)
    per_app = idx.nbytes() + idx.nnz * SECTOR_BYTES + (
        0 if scales is None else scales.numel() * scales.element_size())
    slabs = isinstance(pack, SlabPack)
    nv_walk = isinstance(pack, EllPack) or (slabs and pack.transposed)
    passes = (2 + (3 if apps == 2 else 0)) if nv_walk else 0
    vp = pack.v_pad if slabs else pack.cols.shape[0] * pack.data.shape[-1]
    return apps * per_app + passes * n * vp * 4, 2 * idx.nnz


def index_info(torch, pack, matrix, *, transposed: bool = False) -> dict:
    """Build a pack's nonzero index from its tile or slab values on the card,
    as the first launch does (timed, counted as one build), and hold it
    against the packed CSR ``matrix``: the same row offsets and source
    vertices, each offset in a live tile (or in its row's slab, at the
    window position ``src - lo``) at the position of (row, source), holding
    the stored value (f32, or an int8 pack's ``rint(value / row factor)``
    in the packer's precision; entries stored as 0 left out).
    ``transposed``: an ELL pack's tiles
    (a :class:`SlabPack` says its own layout). Returns its bytes, nonzeros
    and build seconds."""
    import numpy as np
    import scipy.sparse as sp

    from stgcn_tpu_torch.kernels import nnz_index

    slabs = isinstance(pack, SlabPack)
    builds = nnz_index.builds()
    torch.cuda.synchronize()
    t = time.perf_counter()
    if slabs:
        idx = nnz_index.current(pack.index, pack.data, pack.lo, pack.v_pad,
                                transposed=pack.transposed, name="index_info",
                                build=nnz_index.index_from_slabs)
    else:
        idx = nnz_index.current(pack.index, pack.data, pack.cols, pack.counts,
                                transposed=transposed, name="index_info")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    if nnz_index.builds() != builds + 1:
        raise AssertionError("the pack's nonzero index was built before its first launch")
    csr = sp.csr_matrix(matrix)
    csr.sort_indices()
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    scales = getattr(pack, "scales", None)
    if pack.data.dtype == torch.bfloat16:   # each float32 value rounded to nearest even
        stored16 = torch.from_numpy(csr.data.astype(np.float32)).bfloat16()
        stored = stored16.float().numpy()
    elif scales is None:
        stored = csr.data.astype(np.float32)
    else:   # as each packer quantizes: the banded one in float32, the ELL one in float64
        values = csr.data.astype(np.float32) if slabs else csr.data
        stored = np.rint(values / scales.cpu().numpy().reshape(-1)[rows]).astype(np.int8)
    keep = stored != 0
    nbr = pack.data.shape[0]
    bs = pack.bs if slabs else pack.data.shape[2]
    rows_out = pack.v_pad if slabs else nbr * bs
    row_ptr = np.zeros(rows_out + 1, np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=rows_out), out=row_ptr[1:])
    dev = pack.data.device
    src = torch.from_numpy(csr.indices[keep].astype(np.int64)).to(dev)
    ok = (torch.equal(idx.row_ptr.long(), torch.from_numpy(row_ptr).to(dev))
          and torch.equal(idx.src.long(), src))
    if ok:
        row = torch.repeat_interleave(torch.arange(rows_out, device=dev),
                                      idx.row_ptr.diff().long())
        br, off = row // bs, idx.off.long()
        if slabs:   # the window position k of the source vertex lo + k
            lane, k = (off % bs, off // bs) if pack.transposed else (off // pack.w, off % pack.w)
            ok = (bool((k < pack.w).all()) and torch.equal(lane, row % bs)
                  and torch.equal(pack.lo.long()[br] + k, src))
        else:
            k, pos = off // (bs * bs), off % (bs * bs)
            lane, c = (pos % bs, pos // bs) if transposed else (pos // bs, pos % bs)
            ok = (bool((k < pack.counts.long()[br]).all()) and torch.equal(lane, row % bs)
                  and torch.equal(pack.cols.long()[br, k] * bs + c, src))
        want = (stored16[torch.from_numpy(keep)] if pack.data.dtype == torch.bfloat16
                else torch.from_numpy(stored[keep]))
        ok = ok and torch.equal(pack.data.reshape(nbr, -1)[br, off], want.to(dev))
        del row, br, off, k, lane
    del src
    if not ok:
        raise AssertionError("the nonzero index built from the tiles differs from the packed "
                             "CSR matrix's")
    return {"index_bytes": idx.nbytes(), "index_nnz": idx.nnz, "index_build_s": seconds}


def build_1m(torch) -> dict:
    """The synthetic 1M-vertex road graph, its Chebyshev GSO (Lanczos
    lambda_max), RCM order, the int8 and f32 blocked-ELL packs scattered on
    the card, and 55 steps of synthetic series with the sensor columns in RCM
    order, split 23 / 16 / 16; each host step timed."""
    from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler
    from stgcn_tpu_torch.data.synthetic import generate_synthetic_vel, random_road_graph
    from stgcn_tpu_torch.graph import build_gso, permute_matrix, rcm_ordering
    from stgcn_tpu_torch.graph.gso import GraphShiftOperator
    from stgcn_tpu_torch.kernels.banded_spmm import banded_viable
    from stgcn_tpu_torch.ops import EllGraphOp, make_graph_op

    prep: dict = {}
    t = time.perf_counter()

    def lap(key):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        prep[key] = now - t
        t = now

    adj = random_road_graph(V_1M, k_neighbors=8, seed=0)
    lap("graph_s")
    art = build_gso(adj, "sym_norm_lap", cheb=True)
    lap("gso_s")
    perm = rcm_ordering(art.matrix)
    art = GraphShiftOperator(matrix=permute_matrix(art.matrix, perm), gso_type=art.gso_type,
                             cheb_rescaled=True, lam_max=art.lam_max)
    lap("rcm_s")
    gop = make_graph_op(art, "ell_int8", device="cuda")
    lap("pack_int8_s")
    gop_f32 = make_graph_op(art, "ell", device="cuda")
    lap("pack_f32_s")
    if not (isinstance(gop, EllGraphOp) and gop.pack.quantized and not gop_f32.pack.quantized):
        raise AssertionError("make_graph_op(ell_int8 / ell) did not give the int8 / f32 ELL ops")
    vel = generate_synthetic_vel(adj, sum(SPLIT_1M), seed=0)[:, perm]
    lap("series_s")
    n_train, n_val, _ = SPLIT_1M
    train, val, test = vel[:n_train], vel[n_train:n_train + n_val], vel[n_train + n_val:]
    scaler = ZScoreScaler().fit(train)

    def ds(a):
        return ForecastDataset.from_numpy(scaler.transform(a), N_HIS, N_PRED, device="cuda")

    data = {"n_vertex": V_1M, "gop": gop, "gop_f32": gop_f32, "art": art, "matrix": art.matrix,
            "scaler": scaler, "train": ds(train), "val": ds(val), "test": ds(test)}
    lap("split_s")
    nbr, max_b, bs, _ = gop.pack.data.shape
    nnz, tiles = int(art.matrix.nnz), int(gop.pack.counts.sum())
    data["prep"] = {**prep, "nnz": nnz, "nbr": nbr, "max_b": max_b, "bs": bs,
                    "v_pad": gop.v_pad, "tiles": tiles, "mean_tiles_per_block_row": tiles / nbr,
                    "tile_fill": nnz / (tiles * bs * bs),
                    "pack_bytes_int8": pack_bytes(gop.pack),
                    "pack_bytes_f32": pack_bytes(gop_f32.pack),
                    "shared_transpose_pack": gop.pack_t is gop.pack,
                    "auto_picks": "banded" if banded_viable(art.matrix) else "bcsr",
                    "lambda_max": art.lam_max, "series_steps": sum(SPLIT_1M),
                    "split": list(SPLIT_1M)}
    return data


def phase_kernels_ell(torch, data) -> dict:
    """K6 in each mode on the int8 and f32 packs at the 1M shapes (N = B·T·c1
    of blocks 1 and 2 at batch 1), held against its plain version, repeat
    bit-identical, timed beside its bound and torch.sparse.mm; then the f32
    pack is freed."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels import ell_nv as ek

    v, nnz = data["n_vertex"], data["prep"]["nnz"]
    index = {("int8" if g.pack.quantized else "f32"): index_info(torch, g.pack, data["matrix"],
                                                                 transposed=True)
             for g in (data["gop"], data["gop_f32"])}
    a_csr = csr_on_card(torch, data["matrix"])
    gen = torch.Generator(device="cuda").manual_seed(2)
    results: dict[str, list] = {}
    for n in (BATCH_1M * (N_HIS - 2) * 16, BATCH_1M * (N_HIS - 6) * 16):
        x, g, x_vn = spmm_operands(torch, gen, n, v, data["gop"].v_pad)
        for gop in (data["gop_f32"], data["gop"]):
            pack = gop.pack   # the GSO is symmetric: the chain's transpose pack is this one
            nbr, max_b, bs, _ = pack.data.shape
            for mode in ("single", "pair", "chain"):
                name = ek.launch_name(pack.quantized, mode)
                args = (pack, x, g if mode == "chain" else None, mode)
                results.setdefault(name, []).append({
                    "tiles": [nbr, max_b, bs, bs], "dtype": "int8" if pack.quantized else "f32",
                    **check_spmm(
                        torch, name, n, mode, lambda a=args: ek.ell_nv(*a),
                        lambda a=args: ek.ell_nv_reference(*a),
                        lambda apps=1 + (mode != "single"): sparse_mm(torch, a_csr, x_vn, apps),
                        v=v, nnz=nnz, vp=gop.v_pad, value_bytes=1 if pack.quantized else 4,
                        row_scales=pack.quantized,
                        pack_bytes=index_traffic(pack, n, mode)[0],
                        pack_flops_one=index_traffic(pack, n, mode)[1],
                        library_agrees=not pack.quantized, reps=K6_REPS)})
        del x, g, x_vn
    del data["gop_f32"], a_csr
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    emit({"phase": "kernels_ell", "seconds": time.perf_counter() - t0,
          "tolerance": KERNEL_TOL, "pack": data["prep"], "index": index, "results": results})
    return results


def phase_ell_1m(torch, data) -> dict:
    """The 1M-vertex route end to end on the int8 ELL operator: one forecast
    batch fused against unfused, every K1-K4 call of one training step held
    against its plain version, fused gradients against unfused ones, then a
    fused Trainer.fit(1) with its launches counted, and test()."""
    return run_route(torch, data, phase="ell_1m", batch=BATCH_1M, per_step=PER_STEP_1M,
                     per_batch=PER_BATCH_1M, opt="lion", dataset_name="road-1m",
                     cuts=["f32, not the bench's bf16", "no remat",
                           "Lion momentum in f32 (TrainConfig has no mu_dtype)",
                           "series cut to 55 steps: 23 train (8 windows), 16 validation, "
                           "16 test (one window each)"])


# --------------------------------------------------------------------------
# the 1M-vertex BCSR route: the operator make_graph_op(kind="auto") picks there
# --------------------------------------------------------------------------

K10_REPS = 5
# unfused, per ST block: gop(x) and gop(t1, scale=2.0) forward, their dx backward
PER_STEP_BCSR = {"bcsr_spmm": 8}
PER_BATCH_BCSR = {"bcsr_spmm": 4}
K10_SOURCE = "stgcn_tpu_torch/kernels/csrc/bcsr_spmm.cu"
K10_META = (("K10a", K10_SOURCE, "stgcn_tpu/kernels/spmm.py:123", "_spmm_pallas_resident"),
            ("K10b", K10_SOURCE, "stgcn_tpu/kernels/spmm.py:166", "_spmm_pallas"))
K11_META = ("K11", "stgcn_tpu_torch/kernels/csrc/bcsr_sddmm.cu",
            "stgcn_tpu/kernels/sddmm.py:60", "_sddmm_pallas")


def check_bcsr_spmm(torch, pack, x, scale, *, v, nnz, a_csr, reps) -> dict:
    """``check_spmm`` for K10 on the vn operand ``x`` [nbr·bs, N], with
    ``scale`` as its alpha; the library call is ``torch.sparse.mm`` on the
    CSR GSO and x's first V rows (no transpose)."""
    from stgcn_tpu_torch.kernels import spmm

    return check_spmm(
        torch, spmm.LAUNCH_NAME, x.shape[1], "single",
        lambda: spmm.bcsr_spmm(pack, x, scale=scale),
        lambda: spmm.bcsr_spmm_reference(pack, x, scale=scale),
        lambda: torch.sparse.mm(a_csr, x[:v]), v=v, nnz=nnz, vp=x.shape[0], value_bytes=4,
        row_scales=False, pack_bytes=index_traffic(pack, x.shape[1], "single")[0],
        pack_flops_one=index_traffic(pack, x.shape[1], "single")[1], library_agrees=True,
        reps=reps,
        vn=True, scale=scale)


def sddmm_against_plain(torch, out, pack, g, x, scale: float = 1.0) -> tuple[float, float]:
    """Hold a K11 output [nbr, max_b, bs, bs] against its plain version,
    computed a chunk of block rows at a time (the whole is 13.3 GB at 1M),
    at the per-output bound of ``max_err``; returns (max |Δ|, max |ref|)."""
    from stgcn_tpu_torch.kernels import sddmm

    nbr, max_b, bs, _ = out.shape
    n = g.shape[1]
    rows = max(1, sddmm.REF_CHUNK_ELEMS // (max_b * bs * max(n, bs)))

    def plain(s):
        return sddmm.bcsr_sddmm_reference(pack.cols[s:s + rows], pack.counts[s:s + rows],
                                          g[s * bs:(s + rows) * bs], x, block_size=bs,
                                          scale=scale)

    ref_max = max(float(plain(s).abs().max()) for s in range(0, nbr, rows))
    floor = KERNEL_TOL * min(1.0, ref_max)
    err, bad = 0.0, 0
    for s in range(0, nbr, rows):
        r = plain(s)
        d = (out[s:s + rows] - r).abs()
        if not torch.isfinite(out[s:s + rows]).all():
            raise AssertionError(f"K11: non-finite values in block rows {s}..{s + rows}")
        err = max(err, float(d.max()))
        bad += int((d > floor + KERNEL_TOL * r.abs()).sum())
    if bad:
        raise AssertionError(f"K11 disagrees with its plain version: {bad} of {out.numel()} "
                             f"elements outside the bound (max |Δ| {err:.3e}, max |ref| "
                             f"{ref_max:.3e})")
    return err, ref_max


def check_bcsr_sddmm(torch, pack, g, x, *, v, reps) -> dict:
    """K11 on the live tiles of ``pack`` at width N: held against its plain
    version (chunked), repeat bit-identical, launch counter; timed beside
    its plain version, its bound (every entry of the live tiles: 2·tiles·
    bs²·N FLOPs; g and x read once, the live tiles written once) and one
    ``torch.bmm`` over the live tiles' operands, gathered outside the
    timing."""
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.kernels import sddmm

    nbr, max_b, bs, _ = pack.data.shape
    n = g.shape[1]

    def kernel():
        return sddmm.bcsr_sddmm(pack.cols, pack.counts, g, x, block_size=bs)

    before = kernels.launch_counts()[sddmm.LAUNCH_NAME]
    out1, out2 = kernel(), kernel()
    torch.cuda.synchronize()
    if kernels.launch_counts()[sddmm.LAUNCH_NAME] - before != 2:
        raise AssertionError("bcsr_sddmm: launch counter did not move by 2")
    if not torch.equal(out1, out2):
        raise AssertionError(f"bcsr_sddmm [N={n}]: a repeat launch is not bit-identical")
    del out2
    try:
        err, ref_max = sddmm_against_plain(torch, out1, pack, g, x)
    except AssertionError as e:
        raise AssertionError(f"bcsr_sddmm [N={n}]: {e}") from None
    live = torch.nonzero(torch.arange(max_b, device=g.device)[None, :] < pack.counts[:, None])
    bi, ki = live[:, 0], live[:, 1]
    gl = g.reshape(nbr, bs, n)[bi]                                        # [tiles, bs, N]
    xl = x.reshape(nbr, bs, n)[pack.cols[bi, ki].long()].transpose(1, 2)  # [tiles, N, bs]

    def library():
        return torch.bmm(gl, xl)

    lib, lib_err = library(), 0.0
    for c in range(0, len(bi), 4096):
        lib_err = max(lib_err, float((out1[bi[c:c + 4096], ki[c:c + 4096]]
                                      - lib[c:c + 4096]).abs().max()))
    del lib, out1
    library_ms = cuda_ms(library, warmup=2, reps=reps)
    tiles = len(bi)
    del gl, xl, live, bi, ki
    ms = cuda_ms(kernel, warmup=2, reps=reps)
    plain_ms = cuda_ms(lambda: sddmm.bcsr_sddmm_reference(pack.cols, pack.counts, g, x,
                                                           block_size=bs), warmup=1, reps=3)
    nbytes = 2 * n * v * 4 + tiles * bs * bs * 4 + (tiles + nbr) * 4
    flops = 2 * tiles * bs * bs * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"shape": f"N={n}", "input": [nbr * bs, n], "output": [nbr, max_b, bs, bs],
            "tiles": tiles, "max_abs_err": err, "ref_max": [ref_max], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "torch.bmm over the live tiles' g and x blocks, gathered outside "
                            "the timing",
            "library_max_abs_diff": lib_err, "bytes": nbytes, "flops": flops,
            "bytes_ms": t_bytes, "flops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernels_bcsr(torch, data) -> dict:
    """The operator ``make_graph_op(kind="auto")`` builds for the 1M graph
    (BCSR, packed on the card, timed), then K10 at N = 160 and 96 (B·T·c1
    of the two ST blocks at batch 1), scale 1 and 2, and K11 at the same
    widths, random operands, real pack: held against their plain versions,
    repeat bit-identical, timed beside their bounds and library calls."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.ops import BcsrGraphOp, make_graph_op

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gop = make_graph_op(data["art"], "auto", device="cuda")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t1
    if not isinstance(gop, BcsrGraphOp) or gop.pack_t is not gop.pack:
        raise AssertionError(f"make_graph_op(auto) at 1M gave {type(gop).__name__}, not one "
                             "BCSR pack for both directions")
    data["bcsr"] = gop
    v, nnz = data["n_vertex"], data["prep"]["nnz"]
    nbr, max_b, bs, _ = gop.pack.data.shape
    tiles = int(gop.pack.counts.sum())
    index = index_info(torch, gop.pack, data["matrix"], transposed=False)
    a_csr = csr_on_card(torch, data["matrix"])
    gen = torch.Generator(device="cuda").manual_seed(3)
    results: dict[str, list] = {"bcsr_spmm": [], "bcsr_sddmm": []}
    for n in (BATCH_1M * (N_HIS - 2) * 16, BATCH_1M * (N_HIS - 6) * 16):
        x = torch.randn((gop.n_vertex_pad, n), generator=gen, device="cuda")
        g = torch.randn((gop.n_vertex_pad, n), generator=gen, device="cuda")
        for scale in (1.0, 2.0):
            results["bcsr_spmm"].append(check_bcsr_spmm(torch, gop.pack, x, scale, v=v, nnz=nnz,
                                                         a_csr=a_csr, reps=K10_REPS))
        results["bcsr_sddmm"].append(check_bcsr_sddmm(torch, gop.pack, g, x, v=v,
                                                      reps=K10_REPS))
        del x, g
    del a_csr
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    pack = {"auto_picks": type(gop).__name__, "pack_s": pack_s, "nbr": nbr, "max_b": max_b,
            "bs": bs, "n_vertex_pad": gop.n_vertex_pad, "tiles": tiles,
            "tile_fill": nnz / (tiles * bs * bs), "pack_bytes": pack_bytes(gop.pack),
            "shared_transpose_pack": True, **index}
    emit({"phase": "kernels_bcsr", "seconds": time.perf_counter() - t0,
          "tolerance": KERNEL_TOL, "pack": pack, "results": results})
    return results


def record_bcsr_step(torch, data, gop, model=None) -> list:
    """Run one unfused training step (forward with dropout, backward) on the
    first training batch through the BCSR operator ``gop`` and record every
    K10 call it makes: (label, pack, x, scale), in call order. The model is
    ``new_model``'s unless one is given."""
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels import spmm
    from stgcn_tpu_torch.kernels.dropout import step_seed
    from stgcn_tpu_torch.train import masked_mse

    calls: list = []
    real = spmm.bcsr_spmm

    def recorder(pack, x_vn, *, scale=1.0):
        calls.append((f"call{len(calls)}", pack, x_vn.detach(), scale))
        return real(pack, x_vn, scale=scale)

    model = model if model is not None else new_model(torch, data["n_vertex"], DROPRATE)
    params = dict(model.named_parameters())
    starts, n_valid = next(data["train"].batches(BATCH_1M))
    x, y = gather_windows(data["train"].series, starts, N_HIS, N_PRED)
    try:
        spmm.bcsr_spmm = recorder
        pred = model(x, gop, deterministic=False, seed=step_seed(42, 0))
        loss = masked_mse(pred.reshape(BATCH_1M, -1), y, n_valid)
        torch.autograd.grad(loss, list(params.values()))
    finally:
        spmm.bcsr_spmm = real
    torch.cuda.synchronize()
    return calls


def phase_bcsr_1m(torch, data) -> dict:
    """The 1M-vertex route of ``auto``, end to end: the unfused model on the
    BCSR operator (K10) at batch 1 with Lion. One forecast batch against the
    same weights on the f32 ELL operator (K6); every K10 call of one
    unfused training step against its plain version; the tile-value
    gradient through autograd (K11) against its plain version; an unfused
    Trainer.fit(1) with its launches counted (K10 ×8 a step, K11 ×0), and
    test()."""
    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.data import gather_windows
    from stgcn_tpu_torch.kernels import nnz_index, spmm
    from stgcn_tpu_torch.ops import make_graph_op
    from stgcn_tpu_torch.train import TrainConfig, Trainer

    gop, v = data["bcsr"], data["n_vertex"]
    ckpt_root = ROOT / "checkpoints" / "chip_smoke_bcsr_1m"   # git-ignored, removed at the end
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    # 1. one forecast batch through K10, against the f32 ELL operator (K6)
    model = new_model(torch, v, DROPRATE).eval()
    starts, _ = next(data["test"].batches(BATCH_1M))
    x, _ = gather_windows(data["test"].series, starts, N_HIS, N_PRED)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ell = make_graph_op(data["art"], "ell", device="cuda")
    torch.cuda.synchronize()
    ell_pack_s = time.perf_counter() - t1
    with torch.inference_mode():
        kernels.reset_launch_counts()
        pb = model(x, gop)
        torch.cuda.synchronize()
        fwd_launches = kernels.launch_counts()
        pe = model(x, ell)
        walls: dict[str, list] = {"bcsr": [], "ell": []}
        for kind in ("bcsr", "ell", "ell", "bcsr"):
            t1 = time.perf_counter()
            model(x, gop if kind == "bcsr" else ell)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t1)
    del ell
    torch.cuda.empty_cache()
    if fwd_launches != expected(PER_BATCH_BCSR, 1):
        raise AssertionError(f"the BCSR forecast launched {fwd_launches}, expected "
                             f"{expected(PER_BATCH_BCSR, 1)}")
    if pb.shape != (BATCH_1M, 1, v, 1) or not torch.isfinite(pb).all():
        raise AssertionError(f"BCSR forecast has shape {tuple(pb.shape)} or non-finite values")
    d = (pb - pe).abs()
    if not bool((d <= SLICE_TOL + SLICE_TOL * pe.abs()).all()):
        raise AssertionError(f"bcsr_1m: the BCSR and f32 ELL forecasts differ: max |Δ| "
                             f"{float(d.max()):.3e}")
    forecast = {"max_abs_diff_bcsr_ell_f32": float(d.max()), "tolerance": SLICE_TOL,
                "launches": fwd_launches, "ell_f32_pack_s": ell_pack_s,
                "seconds_bcsr": statistics.median(walls["bcsr"]),
                "seconds_ell_f32": statistics.median(walls["ell"])}
    del model, pb, pe, d

    # 2. every K10 call of one unfused training step, against its plain version
    calls = record_bcsr_step(torch, data, gop)
    if len(calls) != PER_STEP_BCSR["bcsr_spmm"]:
        raise AssertionError(f"one unfused step made {len(calls)} K10 calls, expected "
                             f"{PER_STEP_BCSR['bcsr_spmm']}")
    a_csr = csr_on_card(torch, data["matrix"])
    per_call, failed = [], []
    for label, pack, xv, scale in calls:
        try:
            per_call.append({"call": label, **check_bcsr_spmm(
                torch, pack, xv, scale, v=v, nnz=data["prep"]["nnz"], a_csr=a_csr, reps=3)})
        except AssertionError as e:
            failed.append(f"{label}: {e}")
    if failed:
        raise AssertionError("; ".join(failed))

    # 3. the tile-value gradient through autograd (K11), on the step's first operand
    x_vn = calls[0][2]
    del calls, a_csr
    w = torch.randn(x_vn.shape, generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    tiles = gop.pack.data.detach().requires_grad_(True)   # the same storage, no copy
    pack = gop.pack._replace(data=tiles)
    kernels.reset_launch_counts()
    y = spmm.bcsr_spmm_vjp(pack, pack, x_vn, scale=2.0)
    (dtiles,) = torch.autograd.grad((y * w).sum(), [tiles])
    torch.cuda.synchronize()
    grad_launches = kernels.launch_counts()
    if grad_launches != expected({"bcsr_spmm": 1, "bcsr_sddmm": 1}, 1):
        raise AssertionError(f"the tile-value gradient launched {grad_launches}, expected "
                             "K10 and K11 once each")
    err, ref_max = sddmm_against_plain(torch, dtiles, gop.pack, w, x_vn, scale=2.0)
    tile_grad = {"n": x_vn.shape[1], "scale": 2.0, "launches": grad_launches,
                 "max_abs_err": err, "ref_max": ref_max}
    del y, dtiles, tiles, pack, w, x_vn
    torch.cuda.empty_cache()

    # 4. an unfused fit of one epoch, every step's loss and time, then test();
    # the peak memory of the checks above is kept apart from the fit's
    checks_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=DROPRATE, batch_size=BATCH_1M,
                      opt="lion", fused=False, ckpt_dir=str(ckpt_root), dataset_name="road-1m")
    tr = Trainer(cfg, new_model(torch, v, DROPRATE), gop, data["train"], data["val"],
                 data["test"], data["scaler"], device="cuda")
    builds = nnz_index.builds()
    losses, step_seconds, hist, launches = timed_fit(torch, tr, "bcsr_1m")
    val_batches = -(-tr.val_ds.num_windows // BATCH_1M)
    want = expected(PER_STEP_BCSR, tr.steps_per_epoch, (PER_BATCH_BCSR, val_batches))
    if launches != want:
        raise AssertionError(f"bcsr_1m: the fit launched {launches}, expected {want}")
    fit_peak = torch.cuda.max_memory_allocated()
    test_m = tr.test()
    if not all(v_ == v_ and abs(v_) < float("inf") for v_ in test_m.values()):
        raise AssertionError(f"bcsr_1m: non-finite test metrics {test_m}")
    rebuilds = nnz_index.builds() - builds
    if rebuilds:   # the operator is fixed: its nonzero index is never rebuilt
        raise AssertionError(f"bcsr_1m: the fit and test rebuilt a nonzero index {rebuilds} "
                             "times")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    result = {"phase": "bcsr_1m", "seconds": time.perf_counter() - t0, "n_vertex": v,
              "batch_size": BATCH_1M, "optimizer": "lion", "route": "unfused, BCSR (K10)",
              "cuts": ["f32, not the bench's bf16", "no remat",
                       "Lion momentum in f32 (TrainConfig has no mu_dtype)",
                       "series cut to 55 steps: 23 train (8 windows), 16 validation, "
                       "16 test (one window each)"],
              "forecast_one_batch": forecast, "tile_value_grad": tile_grad,
              "steps_per_epoch": tr.steps_per_epoch, "val_batches": val_batches,
              "step_losses": losses, "step_seconds": step_seconds,
              "step_seconds_median": statistics.median(step_seconds),
              "epoch": hist[0], "launches": launches, "test": test_m,
              "index_rebuilds": rebuilds, "peak_memory_bytes_fit": fit_peak,
              "peak_memory_bytes_fit_and_test": torch.cuda.max_memory_allocated(),
              "peak_memory_bytes_checks": checks_peak, "per_step_calls": per_call}
    emit(result)
    return result


def phase_cli(torch, graph_op: str, graph_kernels: tuple, fused: bool = True,
              extra: tuple = ()) -> dict:
    """``python -m stgcn_tpu_torch.cli`` in-process: PeMSD7(M) through the
    sparse operator ``graph_op`` (one block row of 256), one epoch of the
    fused kernels (or of the unfused model: none of K1-K4 may launch), then
    the reference test line; ``graph_kernels`` are the launch counters of
    the operator's kernel (none: the dense operator, where no kernel may
    launch), ``extra`` more flags (``--compute_dtype``, ``--remat``; fused
    with ``--compute_dtype bfloat16`` the kernels are the ``_bf16`` ones, and
    none of the float32 K1-K4 and K1b-K4b may launch)."""
    import contextlib
    import io

    t0 = time.perf_counter()
    from stgcn_tpu_torch import kernels
    from stgcn_tpu_torch.cli import main as cli_main

    ckpt = ROOT / "checkpoints" / "chip_smoke_cli"   # git-ignored, removed at the end
    shutil.rmtree(ckpt, ignore_errors=True)
    buf = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        mets = cli_main(["--dataset", "pemsd7-m", "--data_root", str(ROOT / "data"),
                         "--graph_op", graph_op, "--fused", str(fused), "--epochs", "1",
                         "--ckpt_dir", str(ckpt), *extra])
    launches = kernels.launch_counts()
    shutil.rmtree(ckpt, ignore_errors=True)
    lines = buf.getvalue().strip().splitlines()
    for line in lines[1:]:   # the epoch and test lines (the first is the config dump)
        print(line, flush=True)
    if not lines[-1].startswith("Dataset pemsd7-m | Test loss "):
        raise AssertionError(f"the CLI's last line is not the test line: {lines[-1]!r}")
    per_step, other = (PER_STEP_BF16, PER_STEP) if "bfloat16" in extra else (PER_STEP, {})
    if not all(launches[k] > 0 for k in (*(per_step if fused else ()), *graph_kernels)) \
            or any(launches[k] for k in other if fused) \
            or not (fused or all(launches[k] == 0 for k in PER_STEP)) \
            or not (fused or graph_kernels or not any(launches.values())):
        raise AssertionError(f"the CLI run on {graph_op} (fused {fused}) routed around a "
                             f"kernel: {launches}")
    if not all(v == v and abs(v) < float("inf") for v in mets.values()):
        raise AssertionError(f"non-finite CLI test metrics {mets}")
    result = {"phase": "cli", "graph_op": graph_op, "fused": fused, "flags": list(extra),
              "seconds": time.perf_counter() - t0,
              "test_line": lines[-1], "launches": launches, "test": mets}
    emit(result)
    return result


def free(torch) -> None:
    """Collect what a finished problem left in reference cycles (a Trainer
    and the timed ``train_step`` wrapper a phase sets on it hold each other,
    and through the Trainer its operator), then return the cached blocks, so
    a later phase's peak memory counts only its own tensors."""
    gc.collect()
    torch.cuda.empty_cache()


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

    phase_kernels(torch)
    kbf_fused = phase_kernels_bf16_fused(torch)
    kbf_bwd = phase_kernels_bf16_fused_bwd(torch)
    data = load_pemsd7(torch)
    per_call = phase_kernels_bwd(torch, data)
    sl = phase_slice(torch, data)
    tr = phase_train(torch, data)
    pb = load_pems_bay(torch)
    kst = phase_kernels_stblock(torch, data, pb)
    fd = phase_fused_dense(torch, data, pb)
    fb = phase_fused_bf16(torch, data, pb)
    fbt = phase_fused_bf16_train(torch, data, pb, tr)
    del data, pb
    free(torch)
    big = build_100k(torch)
    k5 = phase_kernels_banded(torch, big)
    kvn = phase_kernels_banded_vn(torch, big)
    kbf = phase_kernels_bf16(torch, big)
    b100 = phase_banded_100k(torch, big)
    b100u = phase_banded_100k_unfused(torch, big)
    free(torch)
    b100bf = phase_banded_100k_bf16(torch, big, b100u)
    del big
    free(torch)   # the 100k checks peak at 45 GB
    big = build_1m(torch)
    k6 = phase_kernels_ell(torch, big)
    m1 = phase_ell_1m(torch, big)
    del big["gop"]   # the int8 ELL pack; the BCSR phases reuse the graph, GSO and order
    free(torch)
    k10 = phase_kernels_bcsr(torch, big)
    b1 = phase_bcsr_1m(torch, big)
    free(torch)   # the float32 fit's memory, before the bf16 one
    b1bf = phase_bcsr_1m_bf16(torch, big, b1)
    del big
    free(torch)
    cli = phase_cli(torch, "banded", ("nv_pair", "nv_chain"))
    cli_ell = phase_cli(torch, "ell_int8", ("ell_int8_pair", "ell_int8_chain"))
    cli_bcsr = phase_cli(torch, "bcsr", ("bcsr_spmm",))
    cli_vn = phase_cli(torch, "banded", ("vn_pair", "vn_chain"), fused=False)
    cli_vn8 = phase_cli(torch, "banded_int8", ("vn_pair_int8", "vn_chain_int8"), fused=False)
    cli_nv8 = phase_cli(torch, "banded_int8", ("nv_pair_int8", "nv_chain_int8"))
    cli_bf16 = phase_cli(torch, "banded", tuple(PER_STEP_100K_BF16), fused=False,
                         extra=("--compute_dtype", "bfloat16", "--remat", "True"))
    cli_bf16_8 = phase_cli(torch, "banded_int8", ("vn_pair_int8_bf16", "vn_chain_int8_bf16"),
                           fused=False, extra=("--compute_dtype", "bfloat16"))
    phase_cli(torch, "auto", (), fused=False, extra=("--compute_dtype", "bfloat16"))
    phase_cli(torch, "dense", (), extra=("--compute_dtype", "bfloat16"))

    def row(name, meta, calls, **extra):
        """One kernel's line: per training step it runs once at each call."""
        kid, source, replaces, tpu_fn = meta
        return {"name": name, "id": kid, "route": "cuda", "source": source,
                "replaces": replaces, "tpu_fn": tpu_fn, **extra,
                "max_abs_err": max(c["max_abs_err"] for c in calls),
                "ms": sum(c["ms"] for c in calls), "plain_ms": sum(c["plain_ms"] for c in calls),
                "bound_ms": sum(c["bound_ms"] for c in calls),
                "bound_by": max(calls, key=lambda c: c["bound_ms"])["bound_by"],
                "library_ms": (sum(c["library_ms"] for c in calls)
                               if all(c.get("library_ms") is not None for c in calls) else None),
                "per_step_calls": calls}

    def at(route, tag, name):
        """K1-K4's per-step numbers on a large graph's route."""
        calls = route["per_step_calls"][name]
        return {f"launches_{tag}": route["launches"][name],
                f"ms_{tag}": sum(c["ms"] for c in calls),
                f"plain_ms_{tag}": sum(c["plain_ms"] for c in calls),
                f"bound_ms_{tag}": sum(c["bound_ms"] for c in calls),
                f"max_abs_err_{tag}": max(c["max_abs_err"] for c in calls)}

    yard = {"head_bwd": {"wgrad_only_100k": b100["trace"]["wgrad_only"]},
            "ohead_bwd": {"recompute_only_100k": b100["trace"]["recompute_only"]},
            "ofc_bwd": {"recompute_only_100k": b100["trace"]["fc_recompute_only"]}}
    rows = [row(name, KERNEL_META[name], calls, launches=tr["launches"][name],
                launches_forecast=sl["launches"][name], **at(b100, "100k", name),
                **at(m1, "1m", name), **yard.get(name, {}))
            for name, calls in per_call.items()]
    fc = b100u["forecast_one_batch"]
    rows += [row(name, K5_META, calls, mode=name[3:], dtype="f32",
                 launches=b100["launches"][name], launches_cli=cli["launches"][name],
                 launches_graph_conv_forecast=fc["graph_conv_f32_unfused_k7_vs_fused_k5"]
                 ["launches"][1].get(name, 0))
             for name, calls in k5.items()]
    rows += [row(name, K5_META, kvn[name], mode=name.split("_")[1], dtype="int8",
                 launches=cli_nv8["launches"][name],
                 launches_forecast_100k=fc["int8_unfused_k9_vs_fused_k5"]["launches"][1]
                 .get(name, 0)
                 + fc["graph_conv_int8_unfused_k7_vs_fused_k5"]["launches"][1].get(name, 0))
             for name in ("nv_single_int8", "nv_pair_int8", "nv_chain_int8")]
    rows += [row(name, meta, [c for c in kvn[name] if c["scale"] == 1.0], mode="single",
                 dtype=dt, per_call_scale_2=[c for c in kvn[name] if c["scale"] != 1.0],
                 launches=fc[f"graph_conv_{dt}_unfused_k7_vs_fused_k5"]["launches"][0][name])
             for meta in K7_META for name, dt in (("vn_single", "f32"), ("vn_single_int8", "int8"))]
    rows.append(row("vn_pair_resident", K8_META, kvn["vn_pair_resident"], mode="pair",
                    dtype="f32", launches=fc["clamped_k8_vs_stream_k9"]["launches"]
                    ["vn_pair_resident"]))
    rows += [row(name, K9_META, b100u["per_step_calls"][name], mode=name[3:], dtype="f32",
                 launches=b100u["launches"][name], launches_cli=cli_vn["launches"][name],
                 per_call_random=kvn[name])
             for name in ("vn_pair", "vn_chain")]
    rows += [row(name, K9_META, kvn[name], mode=name.split("_")[1], dtype="int8",
                 launches=cli_vn8["launches"][name],
                 launches_forecast_100k=fc["int8_unfused_k9_vs_fused_k5"]["launches"][0]
                 .get(name, 0))
             for name in ("vn_pair_int8", "vn_chain_int8")]
    rows += [row(name, K6_META, calls, mode=name.rsplit("_", 1)[1], dtype=calls[0]["dtype"],
                 launches=m1["launches"][name], launches_cli=cli_ell["launches"][name])
             for name, calls in k6.items()]
    rows += [row("bcsr_spmm", meta, b1["per_step_calls"], launches=b1["launches"]["bcsr_spmm"],
                 launches_cli=cli_bcsr["launches"]["bcsr_spmm"], per_call_random=k10["bcsr_spmm"])
             for meta in K10_META]
    rows.append(row("bcsr_sddmm", K11_META, k10["bcsr_sddmm"],
                    launches=b1["launches"]["bcsr_sddmm"],
                    launches_tile_grad=b1["tile_value_grad"]["launches"]["bcsr_sddmm"]))
    rows += [row(name, K12_META[name], kst["pemsd7"][name], launches=fd["launches"][name],
                 launches_forecast=fd["launches_forecast"][name],
                 ms_pems_bay=sum(c["ms"] for c in kst["pems_bay"][name]),
                 plain_ms_pems_bay=sum(c["plain_ms"] for c in kst["pems_bay"][name]),
                 bound_ms_pems_bay=sum(c["bound_ms"] for c in kst["pems_bay"][name]),
                 max_abs_err_pems_bay=max(c["max_abs_err"] for c in kst["pems_bay"][name]),
                 per_call_pems_bay=kst["pems_bay"][name],
                 per_call_generality=kst["generality"][name],
                 **({"adjoint_only_pems_bay": kst["adjoint_only"]} if name == "stblock_bwd"
                    else {"chain_only_pems_bay": kst["chain_only"]}))
             for name in K12_META]
    # the bf16 variants: the vn kernel's (K7-K9) with a bf16 operand on the 100k bf16
    # route (float32 slabs, the CLI's operator) and its random checks over float32, bf16
    # and int8 slabs; K10's on the 1M bf16 route over the float32 tiles, and a bf16 pack
    def random_calls(name):
        return {slabs: kbf[slabs].get(name, []) for slabs in ("f32", "bf16", "int8")}

    rows += [row(name, K9_META, b100bf["per_step_calls"][name], mode=name.split("_")[1],
                 dtype="bf16", slabs_dtype="f32", launches=b100bf["launches"][name],
                 launches_cli=cli_bf16["launches"][name], per_call_random=random_calls(name))
             for name in PER_STEP_100K_BF16]
    fc16 = b100bf["forecast_one_batch"]
    rows += [row(name, K9_META, kbf["int8"][name], mode=name.split("_")[1], dtype="bf16",
                 slabs_dtype="int8", launches=cli_bf16_8["launches"][name],
                 launches_forecast_100k=fc16["int8_k9"]["launches"].get(name, 0))
             for name in ("vn_pair_int8_bf16", "vn_chain_int8_bf16")]
    rows += [row(name, meta, [c for c in kbf[slabs][name] if c["scale"] == 1.0], mode="single",
                 dtype="bf16", slabs_dtype=slabs, launches=fc16[tag]["launches"][name],
                 per_call_scale_2=[c for c in kbf[slabs][name] if c["scale"] != 1.0],
                 **({"per_call_random_bf16_slabs": kbf["bf16"][name]} if slabs == "f32" else {}))
             for meta in K7_META for name, slabs, tag in (
                 ("vn_single_bf16", "f32", "graph_conv_k7"),
                 ("vn_single_int8_bf16", "int8", "graph_conv_int8_k7"))]
    rows.append(row("vn_pair_resident_bf16", K8_META, kbf["f32"]["vn_pair_resident_bf16"],
                    mode="pair", dtype="bf16", slabs_dtype="f32",
                    launches=fc16["clamped_k8"]["launches"]["vn_pair_resident_bf16"]))
    rows += [row("bcsr_spmm_bf16", meta, b1bf["per_step_calls"], dtype="bf16",
                 tiles_dtype="f32", launches=b1bf["launches"]["bcsr_spmm_bf16"],
                 per_call_bf16_tiles=b1bf["per_step_calls_bf16_tiles"])
             for meta in K10_META]
    # K1f-K4f's bf16 variants: per PeMSD7(M) forecast batch (both blocks of K1f
    # and K2f), launches from the bf16 forecast of the test split; the 100k and
    # 1M shapes beside, and the float32 kernel at each shape
    def at16(shape, name, key):
        return sum(c[key] for c in kbf_fused[shape][name])

    def glu_calls(name):
        return [c for c in kbf_fused["pemsd7m"][name] if c["shape"] != "head-gtu"]

    rows += [row(name, meta, glu_calls(name), dtype="bf16",
                 launches=fb["pemsd7m"]["launches"][name],
                 launches_pems_bay=fb["pems_bay"]["launches"][name],
                 launches_1m_bcsr=b1bf["fused_forecast"]["launches"][name],
                 f32_ms=at16("pemsd7m", name, "f32_ms"),
                 bound_ms_f32_fma=at16("pemsd7m", name, "bound_ms_f32_fma"),
                 **{f"{k}_{shape}": at16(shape, name, k)
                    for shape in ("100k", "1m")
                    for k in ("ms", "f32_ms", "plain_ms", "bound_ms", "bound_ms_f32_fma")},
                 **{f"per_call_{shape}": kbf_fused[shape][name] for shape in ("100k", "1m")},
                 per_call_gtu=[c for c in kbf_fused["pemsd7m"][name] if c["shape"] == "head-gtu"])
             for name, meta in FUSED_BF16_META.items()]
    # K1b-K4b's bf16 variants: per PeMSD7(M) training step (both blocks of K1b
    # and K2b; the glu gate, as the model's), launches from the bf16 fit; the
    # 100k and 1M shapes beside, the float32 kernel at each shape, the relu and
    # gtu calls apart
    def bwd16(shape, name, key=None):
        calls = [c for c in kbf_bwd[shape][name] if c["act"] == "glu"]
        return calls if key is None else sum(c[key] for c in calls)

    rows += [row(name, meta, bwd16("pemsd7m", name), dtype="bf16",
                 launches=fbt["launches"][name],
                 launches_pems_bay=fbt["pems_bay"]["bf16"]["launches"][name],
                 launches_1m_bcsr=b1bf["fused_steps"]["bf16"]["launches"][name],
                 f32_ms=bwd16("pemsd7m", name, "f32_ms"),
                 bound_ms_f32_fma=bwd16("pemsd7m", name, "bound_ms_f32_fma"),
                 **{f"{k}_{shape}": bwd16(shape, name, k)
                    for shape in ("100k", "1m")
                    for k in ("ms", "f32_ms", "plain_ms", "bound_ms", "bound_ms_f32_fma")},
                 **{f"per_call_{shape}": bwd16(shape, name) for shape in ("100k", "1m")},
                 per_call_other_gates=[c for shape in kbf_bwd for c in kbf_bwd[shape][name]
                                       if c["act"] != "glu"])
             for name, meta in FUSED_BF16_BWD_META.items()]
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
