"""Worker of the data-parallel trainer test (``tests/test_torch_data_parallel.py``).

One process per rank, gloo collectives between them on the CPU.  Each
process joins the group through ``parallel.distributed.initialize``, loads
the parameters the test wrote (a flax tree of ``ADMMDeconv(kernel_shape=(3,
3), iters=3)``, carried in by ``utils/params_io.py``), and steps the port's
``Trainer`` (``mesh_batch=0``: the whole world) on its shard of every
global batch: once as it is, once with the gradient all-reduce patched out
(the mutation the test must catch), then ``fit`` for two epochs into
``<outdir>/fit``.  Writes ``<outdir>/rank<r>.npz``.  Imports numpy, torch
and the port, never jax.

Usage: python tests/_torch_dp_worker.py <rank> <world> <port> <outdir>
"""

import os
import sys

import numpy as np

GLOBAL_BATCH, STEPS, HW = 4, 3, 16
TRAIN_CFG = {"model_name": "dp", "lr_rate": 1e-2, "epochs": 2, "plateau_patience": 1,
             "prefetch_batches": 0}


class Pairs:
    """(degraded, clean) pairs from seed 3: clean random frames, a box
    blur and noise, the images of shard 1 brighter than shard 0's so the
    shards' gradients differ."""

    def __init__(self, n: int, seed: int = 3):
        rng = np.random.default_rng(seed)
        clean = rng.random((n, HW, HW, 3)).astype(np.float32) * 0.5
        clean[(np.arange(n) // (GLOBAL_BATCH // 2)) % 2 == 1] += 0.4
        blurred = sum(np.roll(clean, (a, b), (1, 2)) for a in (-1, 0, 1) for b in (-1, 0, 1)) / 9
        noisy = blurred + 0.03 * rng.standard_normal(clean.shape)
        self.x, self.y = np.clip(noisy, 0, 1).astype(np.float32), clean

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idxs):
        idxs = np.atleast_1d(np.asarray(idxs))
        return self.x[idxs], self.y[idxs]


def train_pairs():
    return Pairs(GLOBAL_BATCH * STEPS)


def eval_pairs():
    return Pairs(GLOBAL_BATCH, seed=4)


def flat_params(model) -> dict:
    return {name: p.detach().numpy().copy() for name, p in model.named_parameters()}


def main() -> None:
    rank, world, port, outdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import torch

    torch.set_num_threads(1)
    from admm_deconv_tpu_torch.data import DataLoader
    from admm_deconv_tpu_torch.layers import ADMMDeconv
    from admm_deconv_tpu_torch.parallel import distributed
    from admm_deconv_tpu_torch.train import TrainConfig, Trainer
    from admm_deconv_tpu_torch.utils.params_io import load_flax_params

    distributed.initialize(f"127.0.0.1:{port}", world, rank, device_type="cpu")
    params = dict(np.load(os.path.join(outdir, "params.npz")))

    def trainer():
        model = load_flax_params(ADMMDeconv(kernel_shape=(3, 3), iters=3), params)
        return Trainer(model, TrainConfig(mesh_batch=0, **TRAIN_CFG))

    def loader(pairs):
        return DataLoader(pairs, batch_size=GLOBAL_BATCH, process_count=world, process_index=rank)

    results = {}
    for tag in ("", "mutant."):
        tr = trainer()
        if tag:
            tr._average_gradients = lambda model: None
        state = tr.init_state()
        for step, (x, y) in enumerate(loader(train_pairs()), start=1):
            assert x.shape[0] == GLOBAL_BATCH // world
            tr.train_step(state, *tr._to_device(x, y), tr._zero_acc())
            if step in (1, STEPS):
                results |= {f"{tag}step{step}.{k}": v for k, v in flat_params(state.model).items()}

    tr = trainer()
    logs = []
    state = tr.fit(tr.init_state(), loader(train_pairs()), loader(eval_pairs()),
                   model_dir=os.path.join(outdir, "fit"), log_fn=logs.append)
    results |= {f"fit.{k}": v for k, v in flat_params(state.model).items()}
    results["fit.logs"] = np.asarray(len(logs))
    results["fit.step"] = np.asarray(state.step)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **results)


if __name__ == "__main__":
    main()
