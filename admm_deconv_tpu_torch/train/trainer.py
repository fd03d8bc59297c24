"""Training harness: train/eval steps, checkpointing, logging.

Counterpart of ``admm_deconv_tpu/train/trainer.py``: per-step gradient and
update, epoch-averaged metrics (loss, GMSD, PSNR, MSE), reduce-LR-on-
plateau, best-validation checkpoint under a metric-encoding name, CSV
history, selectable GMSD/SSIM/MSE loss and AdaBelief/AdaMax/Adam.

What changed from the JAX trainer:

* The train state is the model and its optimizer (``TrainState``); a step
  updates them in place.  The learning rate lives in the optimizer's
  ``param_groups``, where the plateau schedule writes it.
* Per-step metric sums stay on the device and are read once per epoch;
  batches are moved to the device on a background prefetch thread.
* Checkpoints are ``torch.save`` files holding the model, the optimizer,
  the step and the epoch, with resume from the newest (Orbax in the JAX
  package).
* Data parallelism is one process per card (JAX's ``mesh_batch=N`` is N
  devices of one process): in a process group of world size W the trainer
  takes ``mesh_batch`` W, or ``<= 0`` for all, and refuses any other value
  with JAX's message.  Each rank steps on its shard of the global batch
  (``DataLoader(process_count, process_index)``) and the ranks' gradients
  are averaged by one flat all-reduce before ``optimizer.step()``: every
  loss and metric is a batch mean of per-image values, the shards are equal
  and no layer keeps batch statistics, so this is the global-batch step.
  The epoch's metric sums are all-reduced once.  Only rank 0 writes the
  CSV, TensorBoard and the checkpoints, each write followed by a barrier;
  every rank reads them on resume.  With no process group it is one
  process on the model's device.
* The backward runs inside ``fp32_convs()``, as the forward's
  convolutions do: the card's convolutions stay at full fp32, as on the
  CPU.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import re
import time
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from admm_deconv_tpu_torch.metrics import gmsd_loss, mse, peak_snr, ssim_loss
from admm_deconv_tpu_torch.models.blocks import init_parameters
from admm_deconv_tpu_torch.optim.adabelief import AdaBelief
from admm_deconv_tpu_torch.optim.plateau import ReduceLROnPlateau
from admm_deconv_tpu_torch.train.config import TrainConfig
from admm_deconv_tpu_torch.train.logging import TensorBoardLogger
from admm_deconv_tpu_torch.train.prefetch import Prefetcher
from admm_deconv_tpu_torch.utils.arrays import as_tensor
from admm_deconv_tpu_torch.utils.precision import fp32_convs

LOSSES: dict[str, Callable] = {
    "gmsd": gmsd_loss,
    "ssim": ssim_loss,
    "mse": mse,
}

# optax's adam and adamax place eps as torch's Adam and Adamax do: outside
# the square root after bias correction (adam), inside the max (adamax).
OPTIMIZERS: dict[str, Callable] = {
    "adabelief": lambda params, lr: AdaBelief(params, lr),
    "adamax": lambda params, lr: torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999),
                                                   eps=1e-8),
    "adam": lambda params, lr: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
}

METRICS: dict[str, Callable] = {"gmsd": gmsd_loss, "psnr": peak_snr, "mse": mse}

_CKPT = re.compile(r"^epoch_(\d+)\.pt$")


@dataclasses.dataclass
class TrainState:
    """Resumable train state: the model, its optimizer, and the counters."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0


class Trainer:
    """Config-driven training loop for restoration models, on the device
    that holds the model's parameters."""

    def __init__(self, model: nn.Module, config: TrainConfig, loss_fn: Callable | None = None):
        grouped = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if grouped else 1
        self.rank = dist.get_rank() if grouped else 0
        if config.mesh_batch > 0 and config.mesh_batch != self.world:
            raise ValueError(
                "multi-process training requires the data mesh to span all devices: "
                f"mesh_batch={config.mesh_batch} but device_count={self.world} (one process "
                "per card: the device count is the process group's world size)"
            )
        # mesh_batch <= 0 ("all") is the world, too; a world of one all-reduces
        # with itself only under a process group.
        self.data_parallel = grouped
        self.is_lead = self.rank == 0
        self.model = model
        self.config = config
        self.loss_fn = loss_fn if loss_fn is not None else LOSSES[config.loss]
        self.plateau = ReduceLROnPlateau(
            config.lr_rate, config.plateau_patience, config.plateau_factor
        )

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ---- steps -------------------------------------------------------------

    def train_step(self, state: TrainState, x, y, acc: dict) -> dict:
        """One gradient step on ``(x, y)``; adds the step's metrics to the
        on-device running sums ``acc`` and returns them.  The backward runs
        inside ``fp32_convs()`` (the forward's convolutions set it
        themselves)."""
        with fp32_convs():
            out = state.model(x)
            loss = self.loss_fn(out, y)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if self.data_parallel:
                self._average_gradients(state.model)
        state.optimizer.step()
        state.step += 1
        return self._accumulate(acc, loss, out, y)

    @torch.no_grad()
    def _average_gradients(self, model: nn.Module) -> None:
        """The mean over ranks of each rank's gradient, by one all-reduce of
        the gradients laid end to end."""
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= self.world
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    @torch.no_grad()
    def eval_step(self, model: nn.Module, x, y, acc: dict) -> dict:
        out = model(x)
        return self._accumulate(acc, self.loss_fn(out, y), out, y)

    @torch.no_grad()
    def _accumulate(self, acc, loss, out, y):
        metrics = {"loss": loss.detach(), **{k: fn(out, y) for k, fn in METRICS.items()}}
        return {k: acc[k] + v for k, v in metrics.items()}

    def _zero_acc(self) -> dict:
        return {k: torch.zeros((), device=self.device) for k in ("loss", *METRICS)}

    def _epoch_means(self, acc: dict, n: int) -> dict[str, float]:
        """The epoch's metric means from the on-device sums: over the ranks
        by one all-reduce, read on the host once."""
        sums = torch.stack(list(acc.values()))
        if self.data_parallel:
            dist.all_reduce(sums)
            sums /= self.world
        return {k: float(v) / max(n, 1) for k, v in zip(acc, sums.tolist())}

    def _barrier(self) -> None:
        if self.data_parallel:
            dist.barrier()

    # ---- state -------------------------------------------------------------

    def init_state(self, generator: torch.Generator | None = None) -> TrainState:
        """The train state at step 0.  With a ``generator`` the model's
        parameters are redrawn from it first (a seeded initialisation);
        without one they are kept (e.g. carried in from the JAX package)."""
        if generator is not None:
            init_parameters(self.model, generator)
        optimizer = OPTIMIZERS[self.config.optimizer](self.model.parameters(),
                                                      self.config.lr_rate)
        return TrainState(self.model, optimizer)

    def _set_lr(self, state: TrainState, lr: float) -> None:
        for group in state.optimizer.param_groups:
            group["lr"] = lr

    def _to_device(self, x, y):
        """A batch on the model's device; numpy's float64 as float32."""
        dev = self.device
        return tuple(as_tensor(a, dev).to(dev) for a in (x, y))

    # ---- checkpointing -----------------------------------------------------

    @staticmethod
    def _payload(state: TrainState) -> dict:
        return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": state.step, "epoch": state.epoch}

    def _load(self, state: TrainState, path: str) -> TrainState:
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step, state.epoch = int(ckpt["step"]), int(ckpt["epoch"])
        return state

    def save_checkpoint(self, model_dir: str, state: TrainState, epoch: int) -> str | None:
        """Write the epoch checkpoint and keep the newest
        ``keep_checkpoints`` of them."""
        if not self.config.checkpointing:
            return None
        root = os.path.join(model_dir, "checkpoints")
        path = os.path.join(root, f"epoch_{epoch}.pt")
        if self.is_lead:
            os.makedirs(root, exist_ok=True)
            torch.save(self._payload(state), f"{path}.tmp")
            os.replace(f"{path}.tmp", path)
            for old in self._epochs(root)[:-self.config.keep_checkpoints]:
                os.remove(os.path.join(root, f"epoch_{old}.pt"))
        self._barrier()
        return path

    @staticmethod
    def _epochs(root: str) -> list[int]:
        if not os.path.isdir(root):
            return []
        return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(root)) if m)

    def save_best(self, model_dir: str, state: TrainState, epoch: int,
                  eval_metrics: dict[str, float]) -> str | None:
        """Write the best-validation checkpoint under a metric-encoding name
        (``<name>-ep_N-vloss_X-psnr_Y-mse_Z``), replacing the previous best."""
        if not self.config.checkpointing:
            return None
        best_root = os.path.abspath(os.path.join(model_dir, "best"))
        if self.is_lead:
            os.makedirs(best_root, exist_ok=True)
        name = (
            f"{self.config.model_name}-ep_{epoch}"
            f"-vloss_{eval_metrics.get('loss', float('nan')):.4f}"
            f"-psnr_{eval_metrics.get('psnr', float('nan')):.4f}"
            f"-mse_{eval_metrics.get('mse', float('nan')):.6f}"
        )
        path = os.path.join(best_root, name)
        if self.is_lead:
            torch.save(self._payload(state), f"{path}.tmp")
            os.replace(f"{path}.tmp", path)
            for prev in os.listdir(best_root):
                if prev != name:
                    os.remove(os.path.join(best_root, prev))
        self._barrier()
        return path

    @staticmethod
    def _parse_best_name(name: str) -> tuple[float, int] | None:
        """Extract (vloss, epoch) from a metric-encoding checkpoint name."""
        m = re.search(r"-ep_(\d+)-vloss_([0-9.natinf+-]+?)-psnr_", name)
        if m is None:
            return None
        try:
            return float(m.group(2)), int(m.group(1))
        except ValueError:
            return None

    def restore_best(self, model_dir: str, state: TrainState) -> TrainState | None:
        """Load the metric-named best checkpoint into ``state``; None if
        absent.  Several entries (a crash between save and cleanup) resolve
        to the lowest encoded validation loss, newest epoch on a tie."""
        best_root = os.path.abspath(os.path.join(model_dir, "best"))
        if not os.path.isdir(best_root):
            return None
        entries = sorted(os.listdir(best_root))
        if not entries:
            return None
        scored = [
            (p[0], -p[1], e) for e in entries if (p := self._parse_best_name(e)) is not None
        ]
        best = min(scored)[2] if scored else entries[-1]
        return self._load(state, os.path.join(best_root, best))

    def restore_latest(self, model_dir: str, state: TrainState) -> tuple[TrainState, int]:
        """Resume from the newest epoch checkpoint under ``model_dir`` (no-op
        if none exist).  Returns (state, start_epoch)."""
        root = os.path.join(model_dir, "checkpoints")
        epochs = self._epochs(root)
        if not self.config.checkpointing or not epochs:
            return state, 0
        return self._load(state, os.path.join(root, f"epoch_{epochs[-1]}.pt")), epochs[-1] + 1

    # ---- the loop ------------------------------------------------------------

    def fit(
        self,
        state: TrainState,
        train_loader,
        eval_loader,
        epochs: int | None = None,
        model_dir: str | None = None,
        log_fn: Callable[[str], None] = print,
        resume: bool = False,
        tensorboard: bool = False,
    ) -> TrainState:
        cfg = self.config
        epochs = epochs if epochs is not None else cfg.epochs
        model_dir = model_dir or os.path.join(cfg.save_dir, cfg.model_name)
        os.makedirs(model_dir, exist_ok=True)
        history_path = os.path.join(model_dir, "train_eval_metrics_history.csv")
        tb = (TensorBoardLogger(os.path.join(model_dir, "logging"))
              if tensorboard and self.is_lead else None)

        start_epoch = 0
        if resume:
            state, start_epoch = self.restore_latest(model_dir, state)
            if start_epoch:
                log_fn(f"resumed from epoch {start_epoch}")

        # A resumed run continues the recorded history and best-checkpoint
        # bar: completed rows reload from the CSV, the best validation loss
        # is their lowest, and replaying them restores the plateau state.
        # Every rank reads it, so every rank takes the same decisions.
        best_val_loss = float("inf")
        history: list[dict[str, float]] = []
        if resume and start_epoch and os.path.exists(history_path):
            with open(history_path, newline="") as f:
                rows = list(csv.DictReader(f))
            history = [
                {k: float(v) for k, v in r.items()}
                for r in rows
                if r.get("epoch") and int(float(r["epoch"])) < start_epoch
            ]
            losses = [h["eval_loss"] for h in history if "eval_loss" in h]
            if losses:
                best_val_loss = min(losses)
                for loss_v in losses:
                    self.plateau.step(loss_v)

        prefetch = max(int(cfg.prefetch_batches), 0)

        def batches(loader):
            if prefetch == 0:
                for x, y in loader:
                    yield self._to_device(x, y)
            else:
                yield from Prefetcher(loader, transform=self._to_device, depth=prefetch)

        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            acc = self._zero_acc()
            n_train = 0
            for x, y in batches(train_loader):
                acc = self.train_step(state, x, y, acc)
                n_train += 1
            train_metrics = self._epoch_means(acc, n_train)

            acc = self._zero_acc()
            n_eval = 0
            for x, y in batches(eval_loader):
                acc = self.eval_step(state.model, x, y, acc)
                n_eval += 1
            eval_metrics = self._epoch_means(acc, n_eval)

            val_loss = eval_metrics.get("loss", float("inf"))
            new_lr = self.plateau.step(val_loss)
            self._set_lr(state, new_lr)
            state.epoch = epoch + 1

            row = {
                "epoch": epoch,
                **{f"train_{k}": v for k, v in train_metrics.items()},
                **{f"eval_{k}": v for k, v in eval_metrics.items()},
                "lr": new_lr,
                "seconds": time.time() - t0,
            }
            first_row = not history
            history.append(row)
            # Rewrite on the first row of this run (prunes partial rows left
            # after a crash), then append.
            if self.is_lead:
                mode = "w" if first_row or epoch == start_epoch else "a"
                with open(history_path, mode, newline="") as f:
                    writer = csv.DictWriter(f, fieldnames=list(history[0].keys()))
                    if mode == "w":
                        writer.writeheader()
                        writer.writerows(history)
                    else:
                        writer.writerow(row)
            self._barrier()

            if tb is not None:
                tb.log_scalars(train_metrics, epoch, prefix="train/")
                tb.log_scalars(eval_metrics, epoch, prefix="eval/")
                tb.log_scalars({"lr": new_lr}, epoch)
                tb.log_histograms(state.model, epoch)
                tb.flush()

            if (epoch + 1) % cfg.checkpoint_every == 0 or val_loss < best_val_loss:
                self.save_checkpoint(model_dir, state, epoch)
            if val_loss < best_val_loss:
                self.save_best(model_dir, state, epoch, eval_metrics)
                best_val_loss = val_loss

            if self.is_lead:
                log_fn(
                    f"[epoch {epoch}] "
                    + " ".join(f"train_{k}={v:.5f}" for k, v in train_metrics.items())
                    + " | "
                    + " ".join(f"eval_{k}={v:.5f}" for k, v in eval_metrics.items())
                    + f" | lr={new_lr:.2e} ({row['seconds']:.1f}s)"
                )

        if tb is not None:
            tb.close()
        return state
