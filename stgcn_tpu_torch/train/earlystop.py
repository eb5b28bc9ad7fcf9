"""Early stopping with best-checkpoint tracking (a copy of
``stgcn_tpu/train/earlystop.py``, which the port does not import).

Exact reference semantics (`script/earlystopping.py:27-48`):
score = −val_loss; a tie (``score <= best + delta``) counts as
*no improvement* and increments the counter; at ``counter >= patience``
training stops. An improvement resets the counter and triggers a
checkpoint save via the callback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable


@dataclasses.dataclass
class EarlyStopping:
    patience: int = 10
    delta: float = 0.0
    verbose: bool = True
    on_improvement: Callable[[float], None] | None = None

    counter: int = 0
    best_score: float | None = None
    early_stop: bool = False
    val_loss_min: float = math.inf

    def __call__(self, val_loss: float) -> bool:
        """Returns True if this val_loss is an improvement (checkpoint saved)."""
        score = -val_loss
        if self.best_score is None:
            self._improve(score, val_loss)
            return True
        if score <= self.best_score + self.delta:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
            return False
        self._improve(score, val_loss)
        self.counter = 0
        return True

    def _improve(self, score: float, val_loss: float) -> None:
        self.best_score = score
        if self.verbose:
            print(f"Validation loss decreased ({self.val_loss_min:.4f} --> "
                  f"{val_loss:.4f}). Saving model...")
        if self.on_improvement is not None:
            self.on_improvement(val_loss)
        self.val_loss_min = val_loss

    def state_dict(self) -> dict:
        return {"counter": self.counter, "best_score": self.best_score,
                "early_stop": self.early_stop, "val_loss_min": self.val_loss_min}

    def load_state_dict(self, state: dict) -> None:
        self.counter = state["counter"]
        self.best_score = state["best_score"]
        self.early_stop = state["early_stop"]
        self.val_loss_min = state["val_loss_min"]
