"""Loss and evaluation metrics (port of ``stgcn_tpu/train/metrics.py``).

Semantics mirror the reference:

- training loss: per-batch mean MSE over ``[batch, V]`` predictions
  (`main.py:166-167`), padded tail-batch rows masked out;
- test metrics (`script/utility.py:103-121`): per-element accumulation over
  the whole split of MAE, RMSE, WMAPE and MAPE (MAPE divides by 1 where
  the target is 0, as the JAX package does).

The per-batch sums are float32 on the device and accumulate into float64
there; the host reads them once, at the end of the split.
"""

from __future__ import annotations

import torch


def _row_mask(b: int, n_valid: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.arange(b, device=like.device) < n_valid)[:, None].to(like.dtype)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Mean squared error over the first ``n_valid`` rows of a padded batch;
    equals ``nn.MSELoss()`` on the unpadded batch."""
    se = (pred - target) ** 2 * _row_mask(pred.shape[0], n_valid, pred)
    return se.sum() / (n_valid * pred.shape[1])


def batch_abs_stats(pred: torch.Tensor, target: torch.Tensor, n_valid: int):
    """Per-batch sums on de-normalized values: (Σ|d|, Σd², Σ(|d|/y), Σy, count)."""
    mask = _row_mask(pred.shape[0], n_valid, pred)
    d = (target - pred).abs() * mask
    safe = torch.where(target == 0, torch.ones_like(target), target)
    return (d.sum(), (d ** 2).sum(), (d / safe * mask).sum(), (target * mask).sum(),
            n_valid * pred.shape[1])


def evaluate_mse(apply_fn, dataset, batch_size: int) -> float:
    """Batch-size-weighted mean MSE over a split (`utility.py:90-101`);
    ``apply_fn(starts, n_valid)`` returns the batch's masked loss."""
    l_sum, n = None, 0
    for starts, n_valid in dataset.batches(batch_size):
        l = apply_fn(starts, n_valid).double() * n_valid
        l_sum = l if l_sum is None else l_sum + l
        n += n_valid
    return float(l_sum) / n


def evaluate_metrics(predict_fn, dataset, scaler, batch_size: int) -> dict:
    """De-normalized MAE / RMSE / WMAPE / MAPE over a split
    (`utility.py:103-121`). ``predict_fn(starts)`` returns
    ``(pred [b, V], target [b, V])`` in normalized units."""
    dev = dataset.series.device
    mean = torch.as_tensor(scaler.mean_, dtype=torch.float32, device=dev)
    scale = torch.as_tensor(scaler.scale_, dtype=torch.float32, device=dev)
    sums = torch.zeros(4, dtype=torch.float64, device=dev)
    count = 0
    for starts, n_valid in dataset.batches(batch_size):
        pred, target = predict_fn(starts)
        a, sq, ape, ysum, cnt = batch_abs_stats(pred * scale + mean, target * scale + mean,
                                                n_valid)
        sums += torch.stack([a, sq, ape, ysum]).double()
        count += cnt
    s_abs, s_sq, s_ape, s_y = sums.tolist()
    return {"MAE": s_abs / count, "RMSE": (s_sq / count) ** 0.5,
            "WMAPE": s_abs / s_y, "MAPE": s_ape / count}
