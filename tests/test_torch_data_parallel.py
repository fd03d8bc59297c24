"""The port's data-parallel ``Trainer`` across 2 real ranks, against the
port's one-process trainer and the JAX package's ``mesh_batch=2`` trainer.

Two processes (``tests/_torch_dp_worker.py``: gloo on the CPU, torch and the
port only, a 240 s timeout that kills a hung rank) each step on their half
of every global batch of 4 and average the gradients by one all-reduce.
Their parameters after 1 and after 3 steps are held to:

(a) the port's one-process trainer on the whole global batch, to ``1e-6``
    (the mean of the shards' mean gradients is the global mean, up to the
    order of the sums); a worker with the all-reduce patched out must fail
    this;
(b) the JAX package's ``Trainer(mesh_batch=2)`` on two of the conftest's 8
    virtual CPU devices, to the tolerance of
    ``test_torch_train.py::test_train_step_matches_jax_trainer``: every
    element within ``2.25 lr``, all but 1% within ``1e-3 lr``.

Both ranks hold the same bits.  ``fit`` across the ranks writes its CSV and
checkpoints from rank 0 only, and ends where the one-process ``fit`` ends.
"""

import csv
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_worker as worker
from admm_deconv_tpu.layers import ADMMDeconv as JaxADMMDeconv
from admm_deconv_tpu.train import TrainConfig as JaxConfig
from admm_deconv_tpu.train import Trainer as JaxTrainer
from admm_deconv_tpu_torch.data import DataLoader
from admm_deconv_tpu_torch.layers import ADMMDeconv
from admm_deconv_tpu_torch.train import TrainConfig, Trainer
from admm_deconv_tpu_torch.utils.params_io import load_flax_params

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), "..")
WORLD, SPAWN_TIMEOUT = 2, 240
LR = worker.TRAIN_CFG["lr_rate"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer with mesh_batch=2: its initial parameters and its
    parameters after 1 and 3 steps on the global batches."""
    trainer = JaxTrainer(JaxADMMDeconv(kernel_shape=(3, 3), iters=3),
                         JaxConfig(mesh_batch=WORLD, lr_rate=LR, checkpointing=False))
    assert trainer.mesh is not None and trainer.mesh.devices.size == WORLD
    data = worker.train_pairs()
    state = trainer.init_state(jax.random.PRNGKey(0), jnp.asarray(data.x[:worker.GLOBAL_BATCH]))
    params0 = {k: np.asarray(v) for k, v in jax.device_get(state.params)["params"].items()}
    snaps = {}
    for step, (x, y) in enumerate(DataLoader(data, batch_size=worker.GLOBAL_BATCH), start=1):
        state, _ = trainer._train_step(state, *trainer._shard_batch(x, y), trainer._zero_acc())
        if step in (1, worker.STEPS):
            snaps[step] = {k: np.asarray(v)
                           for k, v in jax.device_get(state.params)["params"].items()}
    return params0, snaps


@pytest.fixture(scope="module")
def ranks(jax_run, tmp_path_factory):
    outdir = tmp_path_factory.mktemp("dp")
    np.savez(outdir / "params.npz", **jax_run[0])
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ""}
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_torch_dp_worker.py"),
             str(r), str(WORLD), str(port), str(outdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for r in range(WORLD)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:  # a hung collective fails the test instead of stalling it
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outdir, [dict(np.load(outdir / f"rank{r}.npz")) for r in range(WORLD)]


def _one_process(params0, steps=(1, worker.STEPS)):
    """The port's trainer with no process group on the whole global batch."""
    model = load_flax_params(ADMMDeconv(kernel_shape=(3, 3), iters=3), params0)
    trainer = Trainer(model, TrainConfig(**worker.TRAIN_CFG))
    assert not trainer.data_parallel
    state = trainer.init_state()
    snaps = {}
    for step, (x, y) in enumerate(DataLoader(worker.train_pairs(),
                                             batch_size=worker.GLOBAL_BATCH), start=1):
        trainer.train_step(state, *trainer._to_device(x, y), trainer._zero_acc())
        if step in steps:
            snaps[step] = worker.flat_params(state.model)
    return snaps


def _rank_params(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def test_ranks_hold_the_same_bits(ranks):
    _, res = ranks
    assert res[0].keys() == res[1].keys()
    for k, v in res[0].items():
        if not k.startswith("mutant.") and k != "fit.logs":  # the mutant's ranks step apart
            np.testing.assert_array_equal(v, res[1][k], err_msg=k)


@pytest.mark.parametrize("step", [1, worker.STEPS])
def test_two_ranks_equal_the_one_process_global_step(jax_run, ranks, step):
    _, res = ranks
    want = _one_process(jax_run[0])[step]
    got = _rank_params(res[0], f"step{step}.")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_without_the_all_reduce_the_ranks_differ_from_the_global_step(jax_run, ranks):
    """The mutation: each rank steps on its own shard's gradient."""
    _, res = ranks
    want = _one_process(jax_run[0])[worker.STEPS]
    got = [_rank_params(r, f"mutant.step{worker.STEPS}.") for r in res]
    for g in got:
        assert max(float(np.abs(g[k] - want[k]).max()) for k in want) > 1e-4
    assert any(not np.array_equal(got[0][k], got[1][k]) for k in want)


@pytest.mark.parametrize("step", [1, worker.STEPS])
def test_two_ranks_equal_the_jax_mesh_batch_2_trainer(jax_run, ranks, step):
    _, res = ranks
    got = _rank_params(res[0], f"step{step}.")
    want = load_flax_params(ADMMDeconv(kernel_shape=(3, 3), iters=3), jax_run[1][step])
    n_off = n_all = 0
    for name, q in want.named_parameters():
        d = np.abs(got[name] - q.detach().numpy())
        assert float(d.max()) <= 2.25 * LR, name
        n_off += int((d > 1e-3 * LR).sum())
        n_all += d.size
    assert n_off <= 0.01 * n_all, (n_off, n_all)


def test_fit_across_ranks_writes_from_rank_0_and_ends_as_one_process(jax_run, ranks, tmp_path):
    outdir, res = ranks
    assert [int(r["fit.logs"]) for r in res] == [2, 0]  # only the lead logs
    assert all(int(r["fit.step"]) == 2 * worker.STEPS for r in res)
    fit_dir = outdir / "fit"
    with open(fit_dir / "train_eval_metrics_history.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(float(r["epoch"])) for r in rows] == [0, 1]
    assert os.listdir(fit_dir / "checkpoints") and len(os.listdir(fit_dir / "best")) == 1

    model = load_flax_params(ADMMDeconv(kernel_shape=(3, 3), iters=3), jax_run[0])
    trainer = Trainer(model, TrainConfig(**worker.TRAIN_CFG))
    state = trainer.fit(trainer.init_state(),
                        DataLoader(worker.train_pairs(), batch_size=worker.GLOBAL_BATCH),
                        DataLoader(worker.eval_pairs(), batch_size=worker.GLOBAL_BATCH),
                        model_dir=str(tmp_path), log_fn=lambda s: None)
    for k, v in worker.flat_params(state.model).items():
        np.testing.assert_allclose(res[0][f"fit.{k}"], v, rtol=0, atol=1e-6, err_msg=k)
    with open(tmp_path / "train_eval_metrics_history.csv", newline="") as f:
        want_rows = list(csv.DictReader(f))
    for row, want in zip(rows, want_rows, strict=True):
        for k in want:
            if k not in ("seconds", "epoch"):
                np.testing.assert_allclose(float(row[k]), float(want[k]), rtol=1e-5, err_msg=k)
