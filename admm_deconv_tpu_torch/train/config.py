"""Config / CLI system.

Counterpart of ``admm_deconv_tpu/train/config.py``, field for field: the
reference's JSON + ArgParse surface (data paths, ``batch_size``,
``im_shape``, ``epochs``, ``lr_rate``, ``use_iso``) from the same JSON
schema, with validation, plus the JAX package's own knobs.  The port's
trainer runs on one device: ``mesh_batch`` other than 1 raises there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass
class TrainConfig:
    """Validated training configuration."""

    train_x_path: str = ""
    train_y_path: str = ""
    eval_x_path: str = ""
    eval_y_path: str = ""
    batch_size: int = 2
    im_shape: tuple[int, int] = (256, 256)
    epochs: int = 130
    lr_rate: float = 1e-1
    use_iso: bool = True
    model: str = "admm_denoiser"
    model_name: str = "admm-tv_restorer"
    loss: str = "gmsd"  # reference trainer v1 uses gmsd_loss, v2 ssim_loss
    optimizer: str = "adabelief"  # v1: AdaBelief; v2: adamax
    save_dir: str = "trained_models"
    plateau_patience: int = 10
    plateau_factor: float = 0.01
    seed: int = 42
    # No reference counterpart.  Data-parallel mesh axis size in the JAX
    # package; the port's trainer takes 1 only.
    mesh_batch: int = 1
    checkpoint_every: int = 1
    keep_checkpoints: int = 3
    checkpointing: bool = True  # False: skip checkpoint writes (dry runs/tests)
    # Solver x-update FFT mode name (every name computes torch.fft).
    fft_mode: str = "auto"
    # "auto" = the fused stencil kernel (its plain version on CPU tensors).
    prox_impl: str = "auto"
    # bf16 storage for the solver loop carry inside the model's ADMM layers
    # (trainable: the mixed kernel has a backward).
    state_dtype: str | None = None
    # Background batches loaded and moved to the device ahead of the step
    # (0 disables).
    prefetch_batches: int = 2

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.epochs < 1:
            raise ValueError("epochs must be >= 1")
        if self.lr_rate <= 0:
            raise ValueError("lr_rate must be > 0")
        self.im_shape = tuple(self.im_shape)
        if len(self.im_shape) != 2:
            raise ValueError("im_shape must be (H, W)")

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrainConfig":
        """Build from a dict in either this schema or the reference's nested
        ``train_cfg.json`` schema (train_data/eval_data sub-dicts)."""
        kwargs: dict[str, Any] = {}
        if "train_data" in d:
            kwargs["train_x_path"] = d["train_data"].get("x_path", "")
            kwargs["train_y_path"] = d["train_data"].get("y_path", "")
        if "eval_data" in d:
            kwargs["eval_x_path"] = d["eval_data"].get("x_path", "")
            kwargs["eval_y_path"] = d["eval_data"].get("y_path", "")
        field_names = {f.name for f in dataclasses.fields(cls)}
        for key, val in d.items():
            if key in field_names:
                kwargs[key] = val
        return cls(**kwargs)


def load_config(path: str) -> TrainConfig:
    """Load a JSON config file (reference ``fetch_json_data``,
    ``cfg_parse.jl:6-12``, including its extension check)."""
    if os.path.splitext(path)[1] != ".json":
        raise ValueError(
            f"Config file has wrong file extension! .json is required but "
            f"{os.path.splitext(path)[1]!r} is given."
        )
    with open(path) as f:
        return TrainConfig.from_dict(json.load(f))


def parse_args(argv=None) -> argparse.Namespace:
    """CLI matching the reference (``cfg_parse.jl:25-40``)."""
    p = argparse.ArgumentParser(description="ADMM deconvolution training")
    p.add_argument(
        "--cfg_fname", "-c", default="train_cfg.json",
        help="Filename of the training JSON config",
    )
    p.add_argument(
        "--model_name", "-n", default="admm-tv_restorer",
        help="Name of the model to be saved",
    )
    # Multi-process launch flags, parsed as the JAX package's CLI parses
    # them; the port's trainer runs one process (ROADMAP Queue 1 item 14).
    p.add_argument(
        "--coordinator", default=None,
        help="coordinator address (host:port) of a multi-process run",
    )
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)
