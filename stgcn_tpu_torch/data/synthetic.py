"""Synthetic data generation (a copy of ``stgcn_tpu/data/synthetic.py``;
numpy and scipy only, so the same seed gives the same arrays bit for bit).

Two jobs:

1. ``ensure_vel`` — the upstream snapshot ships adjacency matrices but not
   every ``vel.csv`` speed series, so training and parity runs use a
   deterministic synthetic series with realistic traffic statistics
   (free-flow speed plateaus, rush-hour dips, graph-correlated noise). Both
   packages read the *same* CSV, so cross-package comparisons stay exact.

2. ``random_road_graph`` — synthetic road networks at 100k–1M+ vertices for
   the sparse graph operators (``BASELINE.json`` configs[3-4]):
   k-nearest-neighbour graphs over 2-D points with thresholded-Gaussian
   edge weights, the construction the real datasets use.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

# Real-series lengths, so synthetic runs have realistic epoch sizes.
REAL_SERIES_LENGTH = {"metr-la": 34272, "pems-bay": 52116, "pemsd7-m": 12672}
_DEFAULT_T = 12672
STEPS_PER_DAY = 288  # 5-minute intervals


def generate_synthetic_vel(adj: sp.spmatrix, n_steps: int, seed: int = 0) -> np.ndarray:
    """Speed series ``[T, V]`` with daily structure and graph-diffused noise."""
    rng = np.random.default_rng(seed)
    n_vertex = adj.shape[0]

    # Row-normalized adjacency as a smoothing operator.
    a = sp.csr_matrix(adj, dtype=np.float64)
    deg = np.asarray(a.sum(axis=1)).ravel()
    deg[deg == 0] = 1.0
    smooth = sp.diags(1.0 / deg) @ a

    free_flow = rng.uniform(55.0, 70.0, size=n_vertex)
    # spatially smooth the free-flow speeds so neighbours look alike
    for _ in range(3):
        free_flow = 0.5 * free_flow + 0.5 * (smooth @ free_flow)

    t = np.arange(n_steps)[:, None]
    phase = 2 * np.pi * t / STEPS_PER_DAY
    am = np.exp(-0.5 * ((t % STEPS_PER_DAY - 0.35 * STEPS_PER_DAY) / 18.0) ** 2)
    pm = np.exp(-0.5 * ((t % STEPS_PER_DAY - 0.73 * STEPS_PER_DAY) / 22.0) ** 2)
    severity = rng.uniform(10.0, 30.0, size=n_vertex)[None, :]
    daily = severity * (am + 0.8 * pm) + 3.0 * np.sin(phase)

    # AR(1) noise, graph-diffused each step for spatial correlation
    noise = np.zeros((n_steps, n_vertex))
    state = rng.standard_normal(n_vertex)
    for i in range(n_steps):
        state = 0.9 * state + 0.45 * rng.standard_normal(n_vertex)
        state = 0.7 * state + 0.3 * (smooth @ state)
        noise[i] = state
    vel = free_flow[None, :] - daily + 3.5 * noise
    return np.clip(vel, 0.0, 80.0)


def ensure_vel(dataset: str, data_root: str = "data", *, seed: int | None = None,
               n_steps: int | None = None) -> str:
    """Create ``<root>/<dataset>/vel.csv`` if absent; returns its path."""
    path = os.path.join(data_root, dataset, "vel.csv")
    if os.path.exists(path):
        return path
    adj = sp.load_npz(os.path.join(data_root, dataset, "adj.npz"))
    if seed is None:
        seed = abs(hash(dataset)) % (2 ** 31)
        seed = {"metr-la": 207, "pems-bay": 325, "pemsd7-m": 228}.get(dataset, seed)
    if n_steps is None:
        n_steps = REAL_SERIES_LENGTH.get(dataset, _DEFAULT_T)
    vel = generate_synthetic_vel(adj, n_steps, seed)
    header = ",".join(str(i) for i in range(vel.shape[1]))
    np.savetxt(path, vel, delimiter=",", header=header, comments="", fmt="%.4f")
    # provenance marker: a reader finding this CSV must not mistake it for
    # real sensor data (see data/README.md)
    note = os.path.join(os.path.dirname(path), "VEL_IS_SYNTHETIC.txt")
    with open(note, "w") as f:
        f.write(f"vel.csv here is SYNTHETIC (generate_synthetic_vel seed={seed}, "
                f"n_steps={n_steps}); real series stripped from the snapshot. "
                "See data/README.md.\n")
    return path


def random_road_graph(n_vertex: int, *, k_neighbors: int = 8, seed: int = 0,
                      threshold: float = 0.1) -> sp.csr_matrix:
    """Synthetic road network: kNN over uniform 2-D points, thresholded
    Gaussian kernel weights — matches the real datasets' construction."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    side = float(np.sqrt(n_vertex))
    pts = rng.uniform(0.0, side, size=(n_vertex, 2))
    tree = cKDTree(pts)
    dist, idx = tree.query(pts, k=k_neighbors + 1)
    dist, idx = dist[:, 1:], idx[:, 1:]  # drop self
    sigma = dist.mean()  # characteristic distance
    w = np.exp(-(dist ** 2) / (2 * sigma ** 2))
    keep = w >= threshold
    rows = np.repeat(np.arange(n_vertex), k_neighbors)[keep.ravel()]
    cols = idx.ravel()[keep.ravel()]
    vals = w.ravel()[keep.ravel()]
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n_vertex, n_vertex)).tocsr()
    a = a.maximum(a.T)  # symmetric road graph
    a.setdiag(1.0)
    return a.tocsr()
