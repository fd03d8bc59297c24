"""The flagship's fp32 gradient, leaf by leaf, against the JAX package's
fp32 gradient and against float64, on the CPU.

``AdmmDenoiser`` at 96^2 x 3, batch 1 (the least crop its valid
convolutions take), the bank at its full ``denoiser_iters=50``, the gmsd
loss.  Two points: JAX's init at ``PRNGKey(0)``, and the same parameters
with every leaf moved by 5% of its RMS in seeded numpy noise (a stand-in
for trained weights).  At each point, on the same seeded input and target:

* JAX fp32: ``jax.value_and_grad`` of the loss as
  ``admm_deconv_tpu.train.Trainer._train_step_impl`` builds it, carried
  onto the port's names with ``load_flax_params``;
* the port in fp32 (its kernels' plain twins on CPU tensors);
* float64: ``bench_torch.train_reference.loss_and_grads``, which shares no
  function with the port.

For each of the 81 leaves and for all of them as one vector, e = ||g_fp32 -
g64|| / ||g64||.

Why the fp32 tail is heavy: a max-pool window whose two largest values lie
within fp32 rounding of each other may take the other argmax in fp32, and
a clamp of ``relu6``/``relu1`` whose input lies within rounding of 0 or of
its top may take the other branch; the window's or element's whole
cotangent then goes elsewhere.  A few such route flips at 96^2 put the
plain e at 1e-4 to 1e-2 in either framework, and which ones flip follows
the order of the sums: at one point (k = 2) the port's CPU gradient reads
6.6e-4 on two threads and 1.3e-3 on four, and at another JAX's reads
3.8e-5 where the port's reads 1.7e-3.  The port's forward flips more
routes than JAX's on the CPU (16 and 26 against 7 and 10 at the two points
here), because torch's CPU (oneDNN) convolutions round 2-4x more than
XLA's.  So the two frameworks' arithmetic is compared along the routes
each fp32 forward took: the float64 reference is run again with every max
pool's argmax and every clamp's branch taken from that fp32 forward
(``e_routed``).  The routes are read from the forward the gradient came
from (for JAX, from the same jitted ``value_and_grad``, returned beside the
model's output).

The port's forward is also made to take JAX's routes: the two fp32
gradients then differ only by their arithmetic, and are held to each other
directly.  The route recording and following are ``chip_smoke.py``'s
(``port_routes``, ``reference_gradient``), which run the same comparison
on the card.

Limits:

1. the port's arithmetic is no worse than JAX's, along each one's routes:
   whole-vector e_routed_port <= 4 e_routed_jax + 1e-6, and the port's
   worst leaf <= 10 x JAX's worst leaf + 1e-6 (fixed before the first run);
2. along JAX's routes, the port's gradient is within ``JAX_PARITY`` of
   JAX's, ||g_port - g_jax|| / ||g_jax|| as one vector and by leaf (4x the
   larger reading of the two points); the lam gradient x 1.05 fails it;
3. along its own routes each fp32 gradient is within 1e-4 of float64 as one
   vector: the rest of the plain e is route flips (fixed before the first
   run).

A failing assertion prints the five worst leaves on each side, plain and
along the routes, and the routes each forward flipped against float64's.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_deconv_tpu.models import blocks as jb
from admm_deconv_tpu.models import zoo as jz
from admm_deconv_tpu.train import Trainer as JaxTrainer
from admm_deconv_tpu.train import TrainConfig as JaxConfig
from admm_deconv_tpu_torch.models import zoo as tz
from admm_deconv_tpu_torch.train import TrainConfig, Trainer
from admm_deconv_tpu_torch.utils.params_io import load_flax_params
from admm_deconv_tpu_torch.utils.precision import fp32_convs
from bench_torch.cells import leaf_error

torch.set_num_threads(2)  # the port's fp32 routes follow oneDNN's order of sums
REFERENCE_THREADS = 4

ITERS = 50  # the bank's iterations, as in both benchmark cells
SEED = 100  # input, target and perturbation
SHAPE = (1, 96, 96, 3)
PERTURB = 0.05  # of each leaf's RMS
CFG = {"lr_rate": 1e-4, "checkpointing": False, "loss": "gmsd", "optimizer": "adabelief"}
POINTS = ("init", "perturbed")
LAM = "DenoiserBank_0.lam"
# Limit 2: the port along JAX's routes against JAX, as one vector and the
# worst leaf: 4x the larger of the two points' readings (3.15e-5 and
# 2.01e-4, the lam leaf, on two threads).
JAX_PARITY = {"whole": 1.3e-4, "leaf": 8.1e-4}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.random(SHAPE).astype(np.float32)
    t = np.clip(x + 0.1 * rng.standard_normal(SHAPE), 0, 1).astype(np.float32)
    return x, t


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (v + PERTURB * np.sqrt(np.mean(np.square(v))) * rng.standard_normal(v.shape))
        .astype(np.float32), params)


def _named(tree) -> dict:
    """A flax tree (parameters or their gradients) under the port's names."""
    model = load_flax_params(tz.AdmmDenoiser(denoiser_iters=ITERS), tree)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _record_jax(mp, seen: list) -> None:
    """Collect the JAX model's pool and clamp inputs while it is traced, as
    ``(kind, value, window)``."""
    pool, relu6, relu1 = flax.linen.max_pool, jb.relu6, jz.relu1

    def rec_pool(x, window, **kw):
        seen.append(("pool", x, tuple(window)))
        return pool(x, window, **kw)

    def rec(kind, fn):
        def clamp(x):
            seen.append((kind, x, None))
            return fn(x)
        return clamp

    mp.setattr(flax.linen, "max_pool", rec_pool)
    mp.setattr(jb, "relu6", rec("relu6", relu6))
    mp.setattr(jz, "relu1", rec("relu1", relu1))


def _port_gradient(params, x, t, routes: list, follow: bool) -> tuple[dict, dict]:
    """The port's fp32 gradient and the parameters it was taken at; its
    forward records its routes into ``routes`` or, with ``follow``, takes
    them from it."""
    with chip_smoke.port_routes(routes, follow):
        model = load_flax_params(tz.AdmmDenoiser(denoiser_iters=ITERS), params)
        with fp32_convs():
            Trainer(model, TrainConfig(**CFG)).loss_fn(
                model(torch.from_numpy(x)), torch.from_numpy(t)).backward()
    return ({n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def _reference(params: dict, x, t, routes: list, follow: bool) -> dict:
    """The float64 gradient, on REFERENCE_THREADS threads (its rounding is
    far below every limit whatever their number)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(REFERENCE_THREADS)
    try:
        return chip_smoke.reference_gradient(params, torch.from_numpy(x), torch.from_numpy(t),
                                             routes, follow, bank_iters=ITERS)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gradients():
    """Every gradient at both points: plain and routed errors by leaf."""
    x, t = _inputs(SEED)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        seen = []
        _record_jax(mp, seen)
        trainer = JaxTrainer(jz.AdmmDenoiser(denoiser_iters=ITERS), JaxConfig(**CFG))
        params0 = jax.device_get(
            jax.jit(trainer.model.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
        seen.clear()
        meta = []

        @jax.jit
        def jax_grad(params, x, y):
            def loss_of(params):
                seen.clear()
                out = trainer.model.apply(params, x)
                meta[:] = [(kind, window) for kind, _, window in seen]
                return trainer.loss_fn(out, y), (out, [v for _, v, _ in seen])

            (_, (_, values)), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
            return grads, values

        for point in POINTS:
            params = params0 if point == "init" else _perturbed(params0, SEED)
            grads, values = jax.device_get(jax_grad(params, jnp.asarray(x), jnp.asarray(t)))
            jax_routes = [chip_smoke.route(kind, _nchw(torch.from_numpy(np.array(v))), window)
                          for (kind, window), v in zip(meta, values)]
            routes, routes64 = [], []
            g_port, at = _port_gradient(params, x, t, routes, follow=False)
            out[point] = {
                "jax": _named(grads), "port": g_port,
                "port_jax_routes": _port_gradient(params, x, t, jax_routes, follow=True)[0],
                "g64": _reference(at, x, t, routes64, False),
                "g64_jax_routes": _reference(at, x, t, jax_routes, True),
                "g64_port_routes": _reference(at, x, t, routes, True),
                "flips": {"jax": chip_smoke.route_flips(jax_routes, routes64),
                          "port": chip_smoke.route_flips(routes, routes64)},
            }
    return out


def _flat(g: dict) -> torch.Tensor:
    return torch.cat([g[n].flatten().to(torch.float64) for n in sorted(g)])


def _errors(got: dict, want: dict) -> tuple[dict, float]:
    return {n: leaf_error(got[n], want[n]) for n in want}, leaf_error(_flat(got), _flat(want))


def _worst(errors: dict, k: int = 5) -> str:
    return ", ".join(f"{n} {errors[n]:.3e}" for n in sorted(errors, key=errors.get)[::-1][:k])


def _report(point: str, g: dict) -> str:
    lines = [f"{point}: route flips against float64 {g['flips']}"]
    for side in ("port", "jax"):
        plain, whole = _errors(g[side], g["g64"])
        routed, whole_r = _errors(g[side], g[f"g64_{side}_routes"])
        lines.append(f"{side}: whole {whole:.3e} (along its routes {whole_r:.3e}); worst "
                     f"leaves {_worst(plain)}; along its routes {_worst(routed)}")
    by_leaf, whole = _errors(g["port_jax_routes"], g["jax"])
    lines.append(f"port along JAX's routes against JAX: whole {whole:.3e}; worst leaves "
                 f"{_worst(by_leaf)}")
    return "\n".join(lines)


def _jax_parity_faults(got: dict, g_jax: dict) -> list[str]:
    """Where the port's gradient along JAX's routes is over limit 2."""
    by_leaf, whole = _errors(got, g_jax)
    worst = max(by_leaf, key=by_leaf.get)
    faults = []
    if whole > JAX_PARITY["whole"]:
        faults.append(f"whole {whole:.3e} > {JAX_PARITY['whole']}")
    if by_leaf[worst] > JAX_PARITY["leaf"]:
        faults.append(f"{worst} {by_leaf[worst]:.3e} > {JAX_PARITY['leaf']}")
    return faults


@pytest.mark.parametrize("point", POINTS)
def test_port_gradient_is_no_worse_than_jax(gradients, point):
    g = gradients[point]
    assert sorted(g["jax"]) == sorted(g["port"]) == sorted(g["g64"]) and len(g["g64"]) == 81
    e_port, whole_port = _errors(g["port"], g["g64_port_routes"])
    e_jax, whole_jax = _errors(g["jax"], g["g64_jax_routes"])
    assert whole_port <= 4 * whole_jax + 1e-6, _report(point, g)
    assert max(e_port.values()) <= 10 * max(e_jax.values()) + 1e-6, _report(point, g)


@pytest.mark.parametrize("point", POINTS)
def test_port_gradient_along_jax_routes_is_jaxs(gradients, point):
    g = gradients[point]
    assert not _jax_parity_faults(g["port_jax_routes"], g["jax"]), _report(point, g)


@pytest.mark.parametrize("point", POINTS)
def test_jax_parity_catches_a_lam_gradient_off_by_5_percent(gradients, point):
    g = gradients[point]
    planted = {**g["port_jax_routes"], LAM: g["port_jax_routes"][LAM] * 1.05}
    assert _jax_parity_faults(planted, g["jax"]), _report(point, g)


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("point", POINTS)
def test_fp32_gradient_along_its_routes_is_float64s(gradients, point, side):
    g = gradients[point]
    _, whole = _errors(g[side], g[f"g64_{side}_routes"])
    assert whole <= 1e-4, _report(point, g)
