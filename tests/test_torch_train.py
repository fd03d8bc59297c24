"""The port's optimizers, schedule, config and trainer against the JAX
package, on the CPU.

Tolerances: the optimizers follow optax's formulas on the same gradient
sequence; torch's Adam/Adamax and optax order a few operations
differently, so parameters agree to ``rtol=1e-6`` of their scale (AdaBelief
is written in optax's order and agrees to a few ulps).  The train step: the
loss to ``rtol=1e-5``.  AdaBelief's first step moves every element by
about ``lr / 0.9`` in the direction of its gradient's sign, so an element
whose gradient is near zero may move the other way in the other framework
(gradients differ by fp32 rounding through ~20 conv layers): every
element agrees within ``2.25 lr`` and all but a small share within
``1e-3 lr``.
"""

import csv
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from admm_deconv_tpu.models import zoo as jz
from admm_deconv_tpu.optim.plateau import ReduceLROnPlateau as JaxPlateau
from admm_deconv_tpu.train import Trainer as JaxTrainer
from admm_deconv_tpu.train import TrainConfig as JaxConfig
from admm_deconv_tpu.train.config import load_config as jax_load_config
from admm_deconv_tpu_torch.layers import ADMMDeconv
from admm_deconv_tpu_torch.models import zoo as tz
from admm_deconv_tpu_torch.optim import AdaBelief, ReduceLROnPlateau
from admm_deconv_tpu_torch.train import TrainConfig, Trainer, load_config
from admm_deconv_tpu_torch.train.prefetch import Prefetcher
from admm_deconv_tpu_torch.train.trainer import OPTIMIZERS
from admm_deconv_tpu_torch.utils.params_io import load_flax_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grad_sequence(steps=5):
    rng = np.random.default_rng(31)
    shapes = {"a": (4, 3), "b": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize(
    "name, optax_opt, rtol",
    [
        ("adabelief", lambda lr: optax.adabelief(lr), 2e-7),
        ("adam", lambda lr: optax.adam(lr), 1e-6),
        ("adamax", lambda lr: optax.adamax(lr, b1=0.9, b2=0.999, eps=1e-8), 1e-6),
    ],
)
def test_optimizer_matches_optax(name, optax_opt, rtol):
    lr = 1e-2
    params, grads = _grad_sequence()
    opt = optax_opt(lr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = OPTIMIZERS[name](list(tp.values()), lr)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=rtol,
                                       atol=rtol * float(np.abs(params[k]).max()), err_msg=k)


def test_adabelief_state_keeps_eps_root():
    """nu holds eps_root added every step; the error is taken against the
    updated mu (optax's ``scale_by_belief``)."""
    params, grads = _grad_sequence(steps=3)
    p = torch.nn.Parameter(torch.from_numpy(params["a"].copy()))
    opt = AdaBelief([p], 1e-3)
    mu = np.zeros_like(params["a"], np.float64)
    nu = np.zeros_like(mu)
    for g in grads:
        p.grad = torch.from_numpy(g["a"].copy())
        opt.step()
        mu = 0.1 * g["a"] + 0.9 * mu
        nu = 0.001 * (g["a"] - mu) ** 2 + 0.999 * nu + 1e-16
    np.testing.assert_allclose(opt.state[p]["nu"].numpy(), nu, rtol=1e-5)
    np.testing.assert_allclose(opt.state[p]["mu"].numpy(), mu, rtol=1e-5, atol=1e-9)
    assert opt.state[p]["step"] == 3
    with pytest.raises(ValueError, match="lr must be"):
        AdaBelief([p], 0.0)


def test_plateau_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.94, 0.93, 0.5, 0.6, 0.7, 0.8, -0.1, -0.1, -0.05]
    a, b = ReduceLROnPlateau(0.1, patience=2, factor=0.5), JaxPlateau(0.1, patience=2, factor=0.5)
    assert [a.step(v) for v in losses] == [b.step(v) for v in losses]
    with pytest.raises(ValueError, match="factor"):
        ReduceLROnPlateau(0.1, factor=1.5)


def test_config_matches_jax(tmp_path):
    path = os.path.join(REPO, "configs", "train_cfg.json")
    assert dataclasses.asdict(load_config(path)) == dataclasses.asdict(jax_load_config(path))
    cfg = TrainConfig.from_dict({"train_data": {"x_path": "a"}, "batch_size": 4, "nope": 1})
    assert cfg.train_x_path == "a" and cfg.batch_size == 4
    bad = tmp_path / "cfg.yaml"
    bad.write_text("{}")
    with pytest.raises(ValueError, match="wrong file extension"):
        load_config(str(bad))
    with pytest.raises(ValueError, match="batch_size"):
        TrainConfig(batch_size=0)


@pytest.fixture(scope="module")
def jax_step():
    """One JAX Trainer step of the flagship (gmsd + AdaBelief, lr 1e-4) at
    96^2, batch 1 (XLA's CPU backward of the 23x23 transposed convolutions
    is the slow part)."""
    rng = np.random.default_rng(41)
    x = rng.random((1, 96, 96, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    cfg = {"lr_rate": 1e-4, "checkpointing": False, "loss": "gmsd", "optimizer": "adabelief"}
    trainer = JaxTrainer(jz.AdmmDenoiser(denoiser_iters=2), JaxConfig(**cfg))
    state = trainer.init_state(jax.random.PRNGKey(0), jnp.asarray(x))
    params0 = jax.device_get(state.params)
    state, acc = trainer._train_step(state, jnp.asarray(x), jnp.asarray(y), trainer._zero_acc())
    return x, y, cfg, params0, jax.device_get(state.params), {k: float(v) for k, v in acc.items()}


def test_train_step_matches_jax_trainer(jax_step):
    x, y, cfg, params0, params1, acc_j = jax_step
    model = load_flax_params(tz.AdmmDenoiser(denoiser_iters=2), params0)
    trainer = Trainer(model, TrainConfig(**cfg))
    state = trainer.init_state()
    acc = trainer.train_step(state, torch.from_numpy(x), torch.from_numpy(y),
                             trainer._zero_acc())
    assert state.step == 1
    for k in ("loss", "gmsd", "psnr", "mse"):
        np.testing.assert_allclose(float(acc[k]), acc_j[k], rtol=1e-5, err_msg=k)
    want = load_flax_params(tz.AdmmDenoiser(denoiser_iters=2), params1)
    lr = cfg["lr_rate"]
    n_off = n_all = 0
    for (name, p), q in zip(model.named_parameters(), want.parameters()):
        d = (p.detach() - q.detach()).abs()
        assert float(d.max()) <= 2.25 * lr, name
        n_off += int((d > 1e-3 * lr).sum())
        n_all += d.numel()
    assert n_off <= 0.01 * n_all, (n_off, n_all)


def _pairs(seed, n, hw=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.random((2, hw, hw, 3)).astype(np.float32)
        out.append((np.clip(y + 0.05 * rng.standard_normal(y.shape), 0, 1).astype(np.float32),
                    y))
    return out


def _small_trainer(**kw):
    cfg = TrainConfig(model_name="tv", lr_rate=1e-2, epochs=3, plateau_patience=1, **kw)
    return Trainer(ADMMDeconv(kernel_shape=(3, 3), iters=3), cfg)


def test_fit_writes_history_checkpoints_and_resumes(tmp_path):
    logs = []
    trainer = _small_trainer(keep_checkpoints=2)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state = trainer.fit(state, _pairs(1, 2), _pairs(2, 1), epochs=2, model_dir=str(tmp_path),
                        log_fn=logs.append, tensorboard=True)
    assert state.epoch == 2 and state.step == 4 and len(logs) == 2
    with open(tmp_path / "train_eval_metrics_history.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(float(r["epoch"])) for r in rows] == [0, 1]
    assert {"train_loss", "eval_loss", "eval_psnr", "eval_gmsd", "eval_mse", "lr"} <= set(rows[0])
    assert all(np.isfinite(float(v)) for r in rows for v in r.values())
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["epoch_0.pt", "epoch_1.pt"]
    best = os.listdir(tmp_path / "best")
    assert len(best) == 1 and best[0].startswith("tv-ep_")
    assert os.listdir(tmp_path / "logging")  # TensorBoard event file

    saved = state.model.lam.detach().clone()
    resumed = _small_trainer(keep_checkpoints=2)
    rstate = resumed.init_state(torch.Generator().manual_seed(9))
    assert not torch.equal(rstate.model.lam, saved)
    rstate = resumed.fit(rstate, _pairs(1, 2), _pairs(2, 1), epochs=3,
                         model_dir=str(tmp_path), log_fn=logs.append, resume=True)
    assert logs[2] == "resumed from epoch 2"
    assert rstate.epoch == 3 and rstate.step == 6
    with open(tmp_path / "train_eval_metrics_history.csv", newline="") as f:
        assert [int(float(r["epoch"])) for r in csv.DictReader(f)] == [0, 1, 2]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["epoch_1.pt", "epoch_2.pt"]

    again = _small_trainer()
    st = again.restore_best(str(tmp_path), again.init_state())
    assert st is not None and st.epoch in (1, 2, 3)


def test_restore_best_takes_lowest_loss(tmp_path):
    trainer = _small_trainer()
    state = trainer.init_state(torch.Generator().manual_seed(0))
    for ep, vloss, lam in ((0, 0.5, 0.1), (1, 0.2, 0.2), (2, 0.3, 0.3)):
        with torch.no_grad():
            state.model.lam.fill_(lam)
        state.epoch = ep + 1
        path = trainer.save_best(str(tmp_path), state, ep, {"loss": vloss, "psnr": 1.0,
                                                             "mse": 0.1})
        assert os.path.isfile(path)
    names = os.listdir(tmp_path / "best")
    assert len(names) == 1 and "-ep_2-vloss_0.3000-" in names[0]
    assert Trainer._parse_best_name(names[0]) == (0.3, 2)
    # Two entries left behind by a crash: the lower loss wins.
    torch.save(trainer._payload(state), tmp_path / "best" / "tv-ep_1-vloss_0.1000-psnr_1-mse_0")
    with torch.no_grad():
        state.model.lam.fill_(0.0)
    assert trainer.restore_best(str(tmp_path), state).epoch == 3
    assert trainer.restore_best(str(tmp_path / "none"), state) is None


def test_trainer_rejects_data_parallel():
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        Trainer(ADMMDeconv(), TrainConfig(mesh_batch=2))


def test_prefetcher_order_errors_and_early_exit():
    items = [(i, -i) for i in range(6)]
    got = list(Prefetcher(items, transform=lambda a, b: (a * 2, b), depth=2))
    assert got == [(2 * i, -i) for i in range(6)]

    def bad():
        yield (1, 1)
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(Prefetcher(bad()))
    before = threading.active_count()
    for i, _ in enumerate(Prefetcher(((k, k) for k in range(10)), depth=1)):
        if i == 2:
            break
    assert threading.active_count() <= before
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(items, depth=0)
