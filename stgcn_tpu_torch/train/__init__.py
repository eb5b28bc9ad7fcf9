"""Loss and evaluation metrics. Optimizers, the trainer, early stopping and
checkpoints come with the training slice."""

from stgcn_tpu_torch.train.metrics import (  # noqa: F401
    batch_abs_stats,
    evaluate_metrics,
    evaluate_mse,
    masked_mse,
)
