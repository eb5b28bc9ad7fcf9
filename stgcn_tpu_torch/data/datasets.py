"""Dataset loading and window supervision (port of
``stgcn_tpu/data/datasets.py``).

Same semantics as the reference (`script/dataloader.py`, `main.py:96-133`):
the normalized series lives on the device once and windows are gathered
from batch start indices inside the forward, instead of materializing every
sliding window up front.

``load_vel`` reads the CSV with numpy: the first line is consumed as a
header and values are float64, as ``pandas.read_csv(path).to_numpy(float64)``
gives them (the machines the port targets do not carry pandas).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import scipy.sparse as sp
import torch

from stgcn_tpu_torch.device import resolve_device

# Reference hard-codes these (`script/dataloader.py:13-18`).
KNOWN_DATASETS = {"metr-la": 207, "pems-bay": 325, "pemsd7-m": 228}


def load_adj(dataset: str, data_root: str = "data") -> tuple[sp.csr_matrix, int]:
    """Load ``<root>/<dataset>/adj.npz``; returns (csr_matrix, n_vertex)."""
    path = os.path.join(data_root, dataset, "adj.npz")
    adj = sp.load_npz(path).tocsr()
    n_vertex = adj.shape[0]
    expect = KNOWN_DATASETS.get(dataset)
    if expect is not None and n_vertex != expect:
        raise ValueError(f"{dataset}: adjacency has {n_vertex} vertices, expected {expect}")
    return adj, n_vertex


def load_vel(dataset: str, data_root: str = "data") -> np.ndarray:
    """Load the speed series ``[T, V]`` (float64) from ``vel.csv``; the first
    line is a header (`dataloader.py:25`)."""
    path = os.path.join(data_root, dataset, "vel.csv")
    return np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2)


def split_lengths(n_total: int, val_rate: float = 0.15, test_rate: float = 0.15
                  ) -> tuple[int, int, int]:
    """70/15/15 chronological split with floor semantics (`main.py:110-114`)."""
    len_val = int(math.floor(n_total * val_rate))
    len_test = int(math.floor(n_total * test_rate))
    return n_total - len_val - len_test, len_val, len_test


def chrono_split(data: np.ndarray, val_rate: float = 0.15, test_rate: float = 0.15):
    n_train, n_val, _ = split_lengths(len(data), val_rate, test_rate)
    return data[:n_train], data[n_train:n_train + n_val], data[n_train + n_val:]


@dataclasses.dataclass
class ZScoreScaler:
    """Per-sensor standardization equal to sklearn ``StandardScaler`` (fit on
    train only, `main.py:117-120`): mean and population std (ddof=0);
    constant columns get scale 1."""

    mean_: np.ndarray | None = None
    scale_: np.ndarray | None = None

    def fit(self, data: np.ndarray) -> "ZScoreScaler":
        self.mean_ = data.mean(axis=0)
        std = data.std(axis=0)
        self.scale_ = np.where(std == 0.0, 1.0, std)
        return self

    def fit_transform(self, data: np.ndarray) -> np.ndarray:
        return self.fit(data).transform(data)

    def transform(self, data):
        return (data - self.mean_) / self.scale_

    def inverse_transform(self, data):
        return data * self.scale_ + self.mean_


def window_starts(n_steps: int, n_his: int, n_pred: int) -> np.ndarray:
    """Valid window start indices.

    ``num = T − n_his − n_pred`` windows (`dataloader.py:37` — the reference
    drops one valid window; mirrored for parity)."""
    num = n_steps - n_his - n_pred
    return np.arange(max(num, 0), dtype=np.int64)


def gather_windows(series: torch.Tensor, starts: torch.Tensor, n_his: int,
                   n_pred: int) -> tuple[torch.Tensor, torch.Tensor]:
    """On-device window gather: ``x [b, n_his, V, 1]``, ``y [b, V]`` with
    ``y[i] = series[starts[i] + n_his + n_pred − 1]``."""
    idx = starts[:, None] + torch.arange(n_his, device=starts.device)[None, :]
    x = series[idx][..., None]
    y = series[starts + (n_his + n_pred - 1)]
    return x, y


@dataclasses.dataclass
class ForecastDataset:
    """A split's normalized series ``[T, V]`` on a device, plus its window
    index set."""

    series: torch.Tensor
    n_his: int
    n_pred: int

    @classmethod
    def from_numpy(cls, series: np.ndarray, n_his: int, n_pred: int, *,
                   device: str | torch.device = "cuda") -> "ForecastDataset":
        """Copy a normalized float64 series to ``device`` as float32."""
        dev = resolve_device(device)
        return cls(torch.as_tensor(np.asarray(series), dtype=torch.float32).to(dev),
                   n_his, n_pred)

    @property
    def num_windows(self) -> int:
        return max(int(self.series.shape[0]) - self.n_his - self.n_pred, 0)

    @property
    def n_vertex(self) -> int:
        return int(self.series.shape[1])

    def batches(self, batch_size: int):
        """Yield ``(starts [batch_size] int64 on the series' device, n_valid)``
        in order. Every batch has the same shape: the tail batch is padded
        by repeating its first index and ``n_valid`` masks the padding."""
        starts = window_starts(int(self.series.shape[0]), self.n_his, self.n_pred)
        for i in range(0, len(starts), batch_size):
            chunk = starts[i:i + batch_size]
            n_valid = len(chunk)
            if n_valid < batch_size:
                chunk = np.concatenate(
                    [chunk, np.full(batch_size - n_valid, chunk[0], np.int64)])
            yield torch.as_tensor(chunk).to(self.series.device), n_valid
