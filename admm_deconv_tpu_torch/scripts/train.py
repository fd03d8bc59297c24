"""Training entry point — the reference's ``julia src/train.jl -c cfg -n name``
(``src/train.jl:177-196``) as a CLI over the port's trainer.

Counterpart of ``scripts/train.py``: the same config, flags and printed
lines.  ``--device`` (default ``cuda``) says where the model trains, as
``JAX_PLATFORMS`` does for the JAX script.  A data-parallel run is one
process per card: give each ``--coordinator host:port --num_processes N
--process_id R`` (or ``--coordinator env://`` with torch's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``) and ``mesh_batch`` N or 0 in
the config; each process loads its shard of every global batch, and only
rank 0 logs and writes.

Usage::

    python -m admm_deconv_tpu_torch.scripts.train -c configs/train_cfg.json -n my_model
"""

import argparse
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from admm_deconv_tpu_torch.data import DataLoader, ImageDataFeeder
from admm_deconv_tpu_torch.models import build_model
from admm_deconv_tpu_torch.parallel import distributed
from admm_deconv_tpu_torch.train import Trainer, load_config, parse_args

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def get_dataloaders(cfg, rng):
    """Per-process loaders: identically-seeded shuffle order across
    processes, each yielding its shard of the global ``cfg.batch_size``."""
    shape = cfg.im_shape
    train_feeder = ImageDataFeeder(
        cfg.train_x_path, cfg.train_y_path, ".png", shape, shape, rng=rng
    )
    eval_feeder = ImageDataFeeder(
        cfg.eval_x_path, cfg.eval_y_path, ".png", shape, shape, rng=rng
    )
    count, index = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    shard = dict(process_count=count, process_index=index)
    train_loader = DataLoader(
        train_feeder, batch_size=cfg.batch_size, shuffle=True,
        rng=np.random.default_rng(cfg.seed + 1), **shard,
    )
    eval_loader = DataLoader(eval_feeder, batch_size=cfg.batch_size, **shard)
    return train_loader, eval_loader


def tensorboard_available() -> bool:
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError:
        return False
    return True


def main(argv=None):
    dev_parser = argparse.ArgumentParser(add_help=False)
    dev_parser.add_argument("--device", default="cuda",
                            help='where the model trains: "cuda" (default) or "cpu"')
    dev_args, rest = dev_parser.parse_known_args(argv)
    args = parse_args(rest)
    device_type = torch.device(dev_args.device).type
    if args.coordinator is not None:
        distributed.initialize(
            None if args.coordinator == "env://" else args.coordinator,
            args.num_processes, args.process_id, device_type=device_type,
        )
    if device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(dev_args.device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    cfg_path = args.cfg_fname
    if not os.path.isabs(cfg_path) and not os.path.exists(cfg_path):
        cfg_path = os.path.join(REPO, "configs", cfg_path)
    log(f"Loading config {cfg_path}")
    cfg = load_config(cfg_path)
    cfg.model_name = args.model_name

    rng = np.random.default_rng(cfg.seed)
    log("Initializing data feeders")
    train_loader, eval_loader = get_dataloaders(cfg, rng)
    if len(train_loader.dataset) == 0:
        raise SystemExit("no training images found — check the config data paths")

    log(f"Building model {cfg.model}")
    model = build_model(cfg.model, dataclasses.asdict(cfg), device=device)
    trainer = Trainer(model, cfg)

    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"MODEL SIZE (#parameters): {n_params:,}")

    tensorboard = tensorboard_available()
    log(f"TensorBoard: {'on' if tensorboard else 'off (torch.utils.tensorboard does not import)'}")
    log("Proceeding with training")
    trainer.fit(state, train_loader, eval_loader, resume=True, tensorboard=tensorboard,
                log_fn=log)
    log("DONE")


if __name__ == "__main__":
    main()
