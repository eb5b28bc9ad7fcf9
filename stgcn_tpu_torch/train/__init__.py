"""Training subsystem: loss and metrics, optimizers and the StepLR schedule,
early stopping, checkpoint / resume, and the trainer."""

from stgcn_tpu_torch.train.earlystop import EarlyStopping  # noqa: F401
from stgcn_tpu_torch.train.metrics import (  # noqa: F401
    batch_abs_stats,
    evaluate_metrics,
    evaluate_mse,
    masked_mse,
)
from stgcn_tpu_torch.train.optim import make_optimizer, make_step_lr  # noqa: F401
from stgcn_tpu_torch.train.loop import TrainConfig, Trainer  # noqa: F401
