"""Data pipeline: adjacency/velocity loading, chronological splits, z-score
normalization, sliding-window supervision and device-side batching."""

from stgcn_tpu_torch.data.datasets import (  # noqa: F401
    KNOWN_DATASETS,
    ForecastDataset,
    ZScoreScaler,
    chrono_split,
    gather_windows,
    load_adj,
    load_vel,
    split_lengths,
    window_starts,
)
