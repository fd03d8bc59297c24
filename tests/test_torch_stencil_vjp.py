"""The port's stencil backward against the JAX package's custom VJP, on the CPU.

The same numpy inputs go to JAX's ``prox_vjp``, ``_bwd_jnp`` and
``jax.grad`` of ``fused_admm_stencil`` (Pallas in interpret mode, through
its custom VJP) and to the port's ``prox_vjp``, ``_bwd_plain`` and the
autograd Function, whose backward on a CPU tensor is ``_bwd_plain``.  The
CUDA backward kernel is held against ``_bwd_plain`` on the card by
``chip_smoke.py``.

Tolerances: aniso and hard are bit-exact in the elementwise outputs.  iso
and gauss go through sqrt, exp and divisions by |v|^3, where torch's
vectorised CPU functions may round one ulp away from XLA's; fp32 outputs
agree to ``rtol=1e-5, atol=1e-6``.  tau's cotangent is a sum over a plane
in another order: ``1e-5`` of the sum of |terms|.  bf16 dual cotangents are
equal or one bf16 ulp apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_deconv_tpu.ops.pallas import prox_math as jax_prox_math
from admm_deconv_tpu.ops.pallas.stencil_kernels import _bwd_jnp
from admm_deconv_tpu.ops.pallas.stencil_kernels import fused_admm_stencil as jax_stencil
from admm_deconv_tpu.ops.pallas.stencil_kernels import (
    fused_admm_stencil_mixed as jax_stencil_mixed,
)
from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES, prox_vjp
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
    _bwd_plain,
    _stencil_plain,
    fused_admm_stencil,
    fused_admm_stencil_bwd,
    fused_admm_stencil_mixed,
)

torch.set_num_threads(2)

SHAPE = (2, 16, 128)
EXACT_MODES = ("aniso", "hard")


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _close(got, want, mode):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if mode in EXACT_MODES:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _bf16_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, np.finfo(np.float32).tiny))) - 7)
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) - ulp))


def _taub_scale(x, ux, uy, tau, gq, gux, guy, mode):
    """Per-plane sum of |tau terms|, the scale of the tau tolerance."""
    t = tau if tau.ndim == 0 else tau[:, None, None]
    dxx = x - torch.roll(x, 1, -1)
    dxy = x - torch.roll(x, 1, -2)
    wbx = gq - torch.roll(gq, 1, -1)
    wby = gq - torch.roll(gq, 1, -2)
    _, _, terms = prox_vjp(mode, dxx + ux, dxy + uy, t, 2 * wbx - gux, 2 * wby - guy)
    return terms.abs().sum(dim=(-2, -1)).numpy()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    arrs = {k: rng.standard_normal(SHAPE).astype(np.float32) for k in
            ("x", "ux", "uy", "gq", "gux", "guy")}
    for k in ("ux", "uy"):
        arrs[k] *= 0.5
    arrs["tau_plane"] = rng.uniform(0.1, 0.5, SHAPE[0]).astype(np.float32)
    return arrs


def _tau(data, per_plane):
    return data["tau_plane"] if per_plane else np.float32(0.3)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "vector"])
def test_prox_vjp_matches_jax(data, mode, per_plane):
    vx, vy, zbx, zby = (data[k] for k in ("x", "ux", "gq", "gux"))
    tau = data["tau_plane"][:, None, None] if per_plane else np.float32(0.3)
    want = jax_prox_math.prox_vjp(mode, *map(jnp.asarray, (vx, vy, tau, zbx, zby)))
    got = prox_vjp(mode, *map(_t, (vx, vy, tau, zbx, zby)))
    for g, w in zip(got, want):
        _close(g, w, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "vector"])
def test_bwd_plain_fp32_matches_bwd_jnp(data, mode, per_plane):
    names = ("x", "ux", "uy", "gq", "gux", "guy")
    tau = _tau(data, per_plane)
    j = [jnp.asarray(data[k]) for k in names]
    want = _bwd_jnp(*j[:3], jnp.asarray(tau), *j[3:], mode)
    t = [_t(data[k]) for k in names]
    got = _bwd_plain(*t[:3], _t(tau), *t[3:], mode)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32 and tuple(g.shape) == SHAPE
        _close(g, w, mode)
    assert tuple(got[3].shape) == (SHAPE[0],)
    scale = _taub_scale(*t[:3], _t(tau), *t[3:], mode)
    assert np.all(np.abs(got[3].numpy() - np.asarray(want[3])) <= 1e-5 * scale + 1e-30)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "vector"])
def test_bwd_plain_bf16_matches_bwd_jnp(data, mode, per_plane):
    """bf16 duals and cotangents: JAX casts them up, computes fp32, casts
    the dual cotangents back; so does the port."""
    bf = {k: jnp.asarray(data[k]).astype(jnp.bfloat16)
          for k in ("ux", "uy", "gq", "gux", "guy")}
    up = {k: v.astype(jnp.float32) for k, v in bf.items()}
    tau = _tau(data, per_plane)
    want = _bwd_jnp(jnp.asarray(data["x"]), up["ux"], up["uy"], jnp.asarray(tau),
                    up["gq"], up["gux"], up["guy"], mode)
    tb = {k: _t(np.asarray(v)).to(torch.bfloat16) for k, v in up.items()}
    got = _bwd_plain(_t(data["x"]), tb["ux"], tb["uy"], _t(tau), tb["gq"], tb["gux"],
                     tb["guy"], mode)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    _close(got[0], want[0], mode)
    for g, w in zip(got[1:3], want[1:3]):
        _bf16_ulp(g, w.astype(jnp.bfloat16))


def _loss_weights(rng):
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("dual", ["float32", "bfloat16"])
def test_function_grad_matches_jax_custom_vjp(data, mode, per_plane, dual):
    """Gradient of sum(q*cq + ux'*cux + uy'*cuy) in (x, ux, uy, tau): the
    port's Function against jax.grad through JAX's custom VJP."""
    cq, cux, cuy = _loss_weights(np.random.default_rng(5))
    tau = _tau(data, per_plane)
    jdt = jnp.float32 if dual == "float32" else jnp.bfloat16
    jx = jnp.asarray(data["x"])
    jux, juy = (jnp.asarray(data[k]).astype(jdt) for k in ("ux", "uy"))

    def jloss(x, ux, uy, t):
        if dual == "float32":
            out = jax_stencil(x, ux, uy, t, mode=mode, interpret=True)
        else:
            out = jax_stencil_mixed(x, ux, uy, t, mode=mode, impl="blocked", interpret=True)
        return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(out, (cq, cux, cuy)))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(jx, jux, juy, jnp.asarray(tau))

    tdt = getattr(torch, dual)
    leaves = [_t(data["x"]), _t(np.asarray(jux.astype(jnp.float32))).to(tdt),
              _t(np.asarray(juy.astype(jnp.float32))).to(tdt), _t(tau)]
    for leaf in leaves:
        leaf.requires_grad_()
    fn = fused_admm_stencil if dual == "float32" else fused_admm_stencil_mixed
    out = fn(*leaves, mode=mode)
    sum((o.float() * _t(c)).sum() for o, c in zip(out, (cq, cux, cuy))).backward()
    got = [leaf.grad for leaf in leaves]

    assert got[0].dtype == torch.float32 and got[1].dtype == tdt
    _close(got[0], want[0], mode)
    for g, w in zip(got[1:3], want[1:3]):
        if dual == "float32":
            _close(g, w, mode)
        else:
            _bf16_ulp(g, w)
    assert tuple(got[3].shape) == np.shape(tau)
    # The same data through _bwd_plain gives the scale of tau's sum.
    gcts = [_t(np.asarray(w.astype(jnp.float32))) for w in (cq, cux, cuy)]
    scale = _taub_scale(leaves[0].detach(), leaves[1].detach().float(),
                        leaves[2].detach().float(), _t(tau), *gcts, mode)
    bound = 1e-5 * (scale if per_plane else scale.sum()) + 1e-30
    assert np.all(np.abs(got[3].numpy() - np.asarray(want[3])) <= bound)


def test_iso_flat_region_gradient_is_finite_and_equals_jax():
    """An image with a flat region under zero duals: iso's v = 0 there.
    Autograd through sqrt gives 0 * inf = NaN; the analytic backward's
    mask gives JAX's finite gradient."""
    x = np.zeros((1, 8, 8), np.float32)
    x[0, :, 4:] = 1.0
    z = jnp.zeros_like(jnp.asarray(x))

    def jloss(xx):
        q, ux, _ = jax_stencil(xx, z, z, 0.1, mode="iso", interpret=True)
        return q.sum() + 0.3 * ux.sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    assert np.all(np.isfinite(want))
    xt = _t(x).requires_grad_()
    q, ux, _ = fused_admm_stencil(xt, torch.zeros(1, 8, 8), torch.zeros(1, 8, 8), 0.1,
                                  mode="iso")
    (q.sum() + 0.3 * ux.sum()).backward()
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def _away_from_thresholds(mode, seed=3, shape=(2, 6, 7)):
    """float64 (x, ux, uy) whose v keeps |v| (aniso/hard) or |v|_2 (iso,
    gauss) in [0.05, 0.2] or [0.45, 1] for tau = 0.3: the prox is smooth
    there, so finite differences see the analytic gradient."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    mag = np.where(rng.random(shape) < 0.5, rng.uniform(0.05, 0.2, shape),
                   rng.uniform(0.45, 1.0, shape))
    if mode in ("aniso", "hard"):
        s = np.where(rng.random(shape) < 0.5, 1.0, -1.0)
        vx, vy = s * mag, -s * mag[..., ::-1]
    else:
        ang = rng.uniform(0, 2 * np.pi, shape)
        vx, vy = mag * np.cos(ang), mag * np.sin(ang)
    ux = vx - (x - np.roll(x, 1, -1))
    uy = vy - (x - np.roll(x, 1, -2))
    return [torch.from_numpy(a.copy()).requires_grad_() for a in (x, ux, uy)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_plane", [False, True], ids=["scalar", "vector"])
def test_function_gradcheck_float64(mode, per_plane):
    x, ux, uy = _away_from_thresholds(mode)
    tau = (torch.full((2,), 0.3, dtype=torch.float64) if per_plane
           else torch.tensor(0.3, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *a: fused_admm_stencil(*a, mode=mode), (x, ux, uy, tau), eps=1e-6, atol=1e-7
    )


@pytest.mark.parametrize("mode", MODES)
def test_function_equals_autograd_through_plain_forward(mode):
    """Away from the thresholds the Function's analytic gradient is the
    derivative autograd takes through the plain forward (float64)."""
    leaves_a = _away_from_thresholds(mode)
    leaves_b = [t.detach().clone().requires_grad_() for t in leaves_a]
    tau_a = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    tau_b = tau_a.detach().clone().requires_grad_()
    w = [torch.randn(leaves_a[0].shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(k)) for k in range(3)]
    for fn, leaves, tau in ((lambda *a: fused_admm_stencil(*a, mode=mode), leaves_a, tau_a),
                            (lambda *a: _stencil_plain(*a, mode), leaves_b, tau_b)):
        sum((o * c).sum() for o, c in zip(fn(*leaves, tau), w)).backward()
    for a, b in zip(leaves_a + [tau_a], leaves_b + [tau_b]):
        want = torch.zeros_like(a) if b.grad is None else b.grad  # hard: tau only in a mask
        torch.testing.assert_close(a.grad, want, rtol=1e-10, atol=1e-12)


def test_backward_skips_what_nobody_asked_for(data):
    """Only the inputs that require grad get one; the CPU path counts no
    kernel launches."""
    before = fused_admm_stencil_bwd.launches
    x = _t(data["x"]).requires_grad_()
    tau = torch.tensor(0.3, requires_grad=True)
    ux, uy = _t(data["ux"]), _t(data["uy"])
    q, ux2, uy2 = fused_admm_stencil(x, ux, uy, tau, mode="aniso")
    (q.sum() + ux2.sum()).backward()
    assert x.grad is not None and tau.grad is not None and tau.grad.shape == ()
    assert ux.grad is None and uy.grad is None
    assert fused_admm_stencil_bwd.launches == before
    got = fused_admm_stencil_bwd(_t(data["x"]), ux, uy, torch.tensor(0.3),
                                 torch.ones(SHAPE), torch.ones(SHAPE), torch.zeros(SHAPE),
                                 "aniso")
    want = _bwd_plain(_t(data["x"]), ux, uy, torch.tensor(0.3), torch.ones(SHAPE),
                      torch.ones(SHAPE), torch.zeros(SHAPE), "aniso")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
