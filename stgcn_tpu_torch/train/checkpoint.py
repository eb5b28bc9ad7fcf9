"""Checkpoint and resume (port of ``stgcn_tpu/train/checkpoint.py``, with
``torch.save`` in place of orbax).

The reference persists only ``model.state_dict()`` at val-loss improvements
(`script/earlystopping.py:44-48`). Here a checkpoint is the full training
state: parameters, optimizer state, epoch, early-stopping state and scaler
statistics, with true resume. Layout: ``<dir>/best.pt`` (weights at the best
validation loss — what ``test`` reloads, `main.py:198`), ``<dir>/latest.pt``
(tensors of the full state) and ``<dir>/host_state.json`` (the rest).
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, obj: Any, name: str) -> None:
        tmp = self._path(name + ".tmp")
        torch.save(obj, tmp)
        os.replace(tmp, self._path(name))  # a reader sees the old or the new file

    # -- best weights (early-stopping checkpoint) -------------------------
    def save_best(self, params: dict[str, torch.Tensor]) -> None:
        self._save({k: v.detach().clone() for k, v in params.items()}, "best.pt")

    def restore_best(self, device: torch.device | str | None = None) -> dict:
        return torch.load(self._path("best.pt"), map_location=device, weights_only=True)

    def has_best(self) -> bool:
        return os.path.exists(self._path("best.pt"))

    # -- full train state (resume) ----------------------------------------
    def save_state(self, tensor_state: Any, host_state: dict) -> None:
        self._save(tensor_state, "latest.pt")
        with open(self._path("host_state.json.tmp"), "w") as f:
            json.dump(host_state, f)
        os.replace(self._path("host_state.json.tmp"), self._path("host_state.json"))

    def restore_state(self, device: torch.device | str | None = None) -> tuple[Any, dict]:
        state = torch.load(self._path("latest.pt"), map_location=device, weights_only=True)
        with open(self._path("host_state.json")) as f:
            host = json.load(f)
        return state, host

    def has_state(self) -> bool:
        return os.path.exists(self._path("latest.pt")) and \
            os.path.exists(self._path("host_state.json"))
