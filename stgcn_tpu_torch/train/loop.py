"""Train / validation / test loops (port of ``stgcn_tpu/train/loop.py``,
single device).

Semantics of the reference training script (`main.py:160-203`), as the JAX
package keeps them: per-batch mean MSE on ``[B, V]`` predictions (the padded tail
batch masked by ``masked_mse``), batch-size-weighted epoch loss, StepLR
stepped per epoch, early stopping on the validation MSE with ties counting
as no improvement, test metrics from the *best* checkpoint.

The series lives on the device; per-step losses stay there and the host
reads them once per epoch. ``fused=True`` trains through the vertex-fused
kernels (K1-K4 forward, K1b-K4b backward); evaluation on a dense graph
operator runs the unfused forward, as the JAX trainer does
(`stgcn_tpu/train/loop.py:157-166`). Dropout masks are keyed by element from
``(seed, global step)`` (:func:`~stgcn_tpu_torch.kernels.dropout.step_seed`),
so the fused and unfused routes drop the same elements, a resumed run
repeats the uninterrupted one, and a recompute under remat draws its mask
again.

Mixed precision and remat are the model's (``STGCN(dtype=torch.bfloat16,
remat=True)``, which the CLI builds from ``compute_dtype`` and ``remat``):
the model trains in bf16 with float32 parameters, gradients and optimizer
state (the LayerNorm affine's in ``ln_param_dtype``), as in the JAX package;
a ``TrainConfig`` whose ``compute_dtype`` or ``remat`` disagrees with the
model's raises ``ValueError``. ``fused=True`` trains a bf16 model through the
bf16 variants of K1-K4 and K1b-K4b around those of the graph kernel (K5 on
the banded operator's nv pack, K6 on ELL, K10 on BCSR; the dense operator's
matmul), as the JAX trainer's ``fused_prec = "bfloat16"`` does. On the fused
route ``remat=True`` takes ``fused_sparse_forward``'s default policy
``"graph-terms"``, which keeps what the plain route keeps and recomputes
nothing (each fused Function saves only its inputs); only
``fused_sparse_forward(remat_policy="minimal")`` recomputes the blocks.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from stgcn_tpu_torch.data.datasets import (
    ForecastDataset, ZScoreScaler, gather_windows, window_starts)
from stgcn_tpu_torch.device import resolve_device
from stgcn_tpu_torch.kernels.dropout import step_seed
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.train import metrics as M
from stgcn_tpu_torch.train.checkpoint import CheckpointManager
from stgcn_tpu_torch.train.earlystop import EarlyStopping
from stgcn_tpu_torch.train.optim import apply_updates, make_optimizer, make_step_lr


@dataclasses.dataclass
class TrainConfig:
    # model (`main.py:44-54` defaults)
    n_his: int = 12
    n_pred: int = 3
    kt: int = 3
    ks: int = 3
    stblock_num: int = 2
    act_func: str = "glu"
    graph_conv_type: str = "cheb_graph_conv"
    enable_bias: bool = True
    droprate: float = 0.5
    # optimization (`main.py:55-62` defaults)
    lr: float = 1e-3
    weight_decay: float = 1e-3
    batch_size: int = 32
    epochs: int = 1000
    opt: str = "adamw"
    step_size: int = 10
    gamma: float = 0.95
    patience: int = 10
    seed: int = 42
    shuffle: bool = False  # reference quirk: no shuffling even in training
    compute_dtype: str | None = None  # 'bfloat16' for mixed-precision training
    remat: bool = False  # the model's; unfused: recompute head and tail per ST block;
    # fused: policy "graph-terms", which keeps what no remat keeps (no recompute)
    fused: bool = False  # train through the vertex-fused kernels
    # io
    ckpt_dir: str = "checkpoints/run"
    log_path: str | None = None
    dataset_name: str = "dataset"


class Trainer:
    """Single-device trainer over a port :class:`~stgcn_tpu_torch.nn.STGCN`
    (its parameters are trained in place). ``device`` defaults to ``"cuda"``;
    the model and the splits are moved there."""

    def __init__(self, config: TrainConfig, model, gop, train_ds: ForecastDataset,
                 val_ds: ForecastDataset, test_ds: ForecastDataset, scaler: ZScoreScaler, *,
                 mesh=None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError("a device mesh (data / graph parallel training) comes "
                                      "with the dist slice of the port")
        if config.compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype {config.compute_dtype!r}: float32 or bfloat16")
        want_dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else None
        if model.dtype != want_dtype or model.remat != config.remat:
            raise ValueError(f"compute_dtype {config.compute_dtype!r} / remat {config.remat} "
                             f"disagree with the model's dtype {model.dtype} / remat "
                             f"{model.remat}: the model's fields decide how it trains")
        self.cfg = config
        self.model = model.to(self.device)
        self.gop = gop
        splits = []
        for name, ds in (("train", train_ds), ("val", val_ds), ("test", test_ds)):
            if ds.num_windows < 1:
                raise ValueError(
                    f"{name} split has {int(ds.series.shape[0])} steps — too few "
                    f"for n_his={config.n_his} + n_pred={config.n_pred} windows")
            splits.append(dataclasses.replace(ds, series=ds.series.to(self.device)))
        self.train_ds, self.val_ds, self.test_ds = splits
        self.scaler = scaler
        self.ckpt = CheckpointManager(config.ckpt_dir)

        self.steps_per_epoch = max(-(-self.train_ds.num_windows // config.batch_size), 1)
        self.lr_schedule = make_step_lr(config.lr, config.step_size, config.gamma,
                                        self.steps_per_epoch)
        self.tx = make_optimizer(config.opt, lr=self.lr_schedule,
                                 weight_decay=config.weight_decay)
        self.params = dict(self.model.named_parameters())
        self.opt_state = self.tx.init(self.params)
        self.epoch = 0
        self.es = EarlyStopping(patience=config.patience, delta=0.0,
                                on_improvement=lambda _vl: self.ckpt.save_best(self.params))
        self._plans: dict = {}

    # ---------------------------------------------------------------- steps
    def _forward(self, params, x, *, deterministic: bool, seed: int | None = None):
        if self.cfg.fused and not (deterministic and hasattr(self.gop, "matrix")):
            return fused_sparse_forward(params, x, self.gop, self.model,
                                        deterministic=deterministic, seed=seed)
        if params is self.params:
            return self.model(x, self.gop, deterministic=deterministic, seed=seed)
        return torch.func.functional_call(self.model, params, (x, self.gop),
                                          {"deterministic": deterministic, "seed": seed})

    def train_step(self, starts: torch.Tensor, n_valid: int, step: int) -> torch.Tensor:
        """One optimizer step on the batch at ``starts``; returns the loss on
        the device. ``step`` is the global step (it keys the dropout)."""
        cfg = self.cfg
        x, y = gather_windows(self.train_ds.series, starts, cfg.n_his, cfg.n_pred)
        pred = self._forward(self.params, x, deterministic=False,
                             seed=step_seed(cfg.seed, step))
        loss = M.masked_mse(pred.reshape(pred.shape[0], -1), y, n_valid)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        updates, self.opt_state = self.tx.update(dict(zip(names, grads)), self.opt_state,
                                                 self.params)
        apply_updates(self.params, updates)
        return loss.detach()

    # ----------------------------------------------------------- batch plans
    def _plan(self, ds: ForecastDataset) -> list[tuple[torch.Tensor, int]]:
        """A split's batches in order, cached: (starts on the device, n_valid)."""
        key = id(ds)
        if key not in self._plans:
            self._plans[key] = (ds, list(ds.batches(self.cfg.batch_size)))
        return self._plans[key][1]

    def _shuffled_plan(self) -> list[tuple[torch.Tensor, int]]:
        """This epoch's batches in an order drawn on the device from (seed,
        epoch); the tail batch is padded with already-used windows and masked
        by n_valid, as in the sequential plan."""
        cfg, ds = self.cfg, self.train_ds
        starts = torch.as_tensor(window_starts(int(ds.series.shape[0]), cfg.n_his, cfg.n_pred),
                                 device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(cfg.seed, self.epoch) ^ 0x5F3759DF)
        perm = starts[torch.randperm(len(starts), generator=gen, device=self.device)]
        steps, b = self.steps_per_epoch, cfg.batch_size
        mat = torch.cat([perm, perm[: steps * b - len(starts)]]).reshape(steps, b)
        n_valid = [b] * (steps - 1) + [len(starts) - (steps - 1) * b]
        return list(zip(mat, n_valid))

    @staticmethod
    def _weighted(losses: list[torch.Tensor], weights: list[int]) -> float:
        """Batch-size-weighted mean of per-batch losses: one host read."""
        host = torch.stack(losses).double().cpu().numpy()
        w = np.asarray(weights, np.float64)
        return float((host * w).sum() / w.sum())

    # ----------------------------------------------------------------- loops
    def train_epoch(self) -> float:
        plan = self._shuffled_plan() if self.cfg.shuffle else self._plan(self.train_ds)
        step0 = self.epoch * self.steps_per_epoch
        losses = [self.train_step(starts, n_valid, step0 + i)
                  for i, (starts, n_valid) in enumerate(plan)]
        return self._weighted(losses, [n for _, n in plan])

    def _eval_loss(self, params, ds: ForecastDataset) -> float:
        cfg = self.cfg
        plan = self._plan(ds)
        losses = []
        with torch.no_grad():
            for starts, n_valid in plan:
                x, y = gather_windows(ds.series, starts, cfg.n_his, cfg.n_pred)
                pred = self._forward(params, x, deterministic=True)
                losses.append(M.masked_mse(pred.reshape(pred.shape[0], -1), y, n_valid))
        return self._weighted(losses, [n for _, n in plan])

    def validate(self) -> float:
        return self._eval_loss(self.params, self.val_ds)

    def current_lr(self) -> float:
        return float(self.lr_schedule(self.epoch * self.steps_per_epoch))

    def fit(self, epochs: int | None = None, *, log: bool = True) -> dict:
        cfg = self.cfg
        n_epochs = cfg.epochs if epochs is None else epochs
        history = []
        log_f = open(cfg.log_path, "a") if cfg.log_path else None
        try:
            while self.epoch < n_epochs:
                t0 = time.time()
                train_loss = self.train_epoch()
                val_loss = self.validate()
                dt = time.time() - t0
                lr = self.current_lr()
                self.epoch += 1
                rec = {"epoch": self.epoch, "lr": lr, "train_loss": train_loss,
                       "val_loss": val_loss, "epoch_time_s": dt,
                       "steps_per_s": self.steps_per_epoch / dt}
                history.append(rec)
                if log:
                    print(f"Epoch: {self.epoch:03d} | Lr: {lr:.20f} "
                          f"|Train loss: {train_loss:.6f} | Val loss: {val_loss:.6f} "
                          f"| {dt:.2f}s ({rec['steps_per_s']:.1f} steps/s)")
                if log_f:
                    log_f.write(json.dumps(rec) + "\n")
                    log_f.flush()
                self.es(val_loss)
                self._save_resume_state()
                if self.es.early_stop:
                    if log:
                        print("Early stopping")
                    break
        finally:
            if log_f:
                log_f.close()
        return {"history": history, "stopped_epoch": self.epoch}

    def test(self, *, use_best: bool = True, log: bool = True) -> dict:
        cfg = self.cfg
        params = self.ckpt.restore_best(self.device) \
            if use_best and self.ckpt.has_best() else self.params
        mse = self._eval_loss(params, self.test_ds)

        def predict(starts):
            x, y = gather_windows(self.test_ds.series, starts, cfg.n_his, cfg.n_pred)
            with torch.no_grad():
                pred = self._forward(params, x, deterministic=True)
            return pred.reshape(pred.shape[0], -1), y

        mets = M.evaluate_metrics(predict, self.test_ds, self.scaler, cfg.batch_size)
        if log:
            print(f"Dataset {cfg.dataset_name:s} | Test loss {mse:.6f} "
                  f"| MAE {mets['MAE']:.6f} | RMSE {mets['RMSE']:.6f} "
                  f"| WMAPE {mets['WMAPE']:.8f}")
        return {"test_mse": mse, **mets}

    # --------------------------------------------------------------- resume
    def _save_resume_state(self) -> None:
        tensors = {"params": {k: v.detach() for k, v in self.params.items()},
                   "opt_state": self.opt_state}
        host = {"epoch": self.epoch, "es": self.es.state_dict(),
                "scaler_mean": np.asarray(self.scaler.mean_).tolist(),
                "scaler_scale": np.asarray(self.scaler.scale_).tolist()}
        self.ckpt.save_state(tensors, host)

    def resume(self) -> bool:
        """Restore the latest full state; returns True if resumed."""
        if not self.ckpt.has_state():
            return False
        state, host = self.ckpt.restore_state(self.device)
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(state["params"][k])
        self.opt_state = state["opt_state"]
        self.epoch = int(host["epoch"])
        self.es.load_state_dict(host["es"])
        self.es.on_improvement = lambda _vl: self.ckpt.save_best(self.params)
        return True
