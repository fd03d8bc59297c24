"""The x-update's complex right-hand side as one pass (``spectral_rhs``) on
the CPU: its wrapper, the solver's dispatch to it, and the x-update against
the JAX package's.

On a CPU tensor the wrapper takes its plain twin (the composition
``C * (B + rho * F)``) and writes it into ``F``, so its output equals the
composition bit for bit (``torch.equal``).  The CUDA kernel's arithmetic,
each part of each bin as ``C * (Br + rho * Fr)``, is emulated part by part
here and held to the composition as well: torch's complex product of a
real operand promoted to ``(a, 0)`` rounds to the same values.  The kernel
itself is held to the twin on the card by ``chip_smoke.py``.  The port's
x-update agrees with JAX's to ``atol=2e-5`` (pocketfft and XLA's FFT round
differently); a gradient through ``tv_deconvolve`` is the composition's
exactly.
"""

import numpy as np
import pytest
import torch

from admm_deconv_tpu.ops.solver import _solve_spectral as jax_solve_spectral
from admm_deconv_tpu_torch import tv_deconvolve
from admm_deconv_tpu_torch.ops import solver
from admm_deconv_tpu_torch.ops.fft import laplacian_spectrum, psf_to_otf
from admm_deconv_tpu_torch.ops.kernels.spectral_kernels import (
    _spectral_rhs_plain,
    spectral_rhs,
)

torch.set_num_threads(2)

LAM, RHO = 0.0041, 0.021


def _operands(seed: int, n: int, h: int, w: int, per_plane: bool):
    """F = rfft2(q), B = conj(otf) rfft2(y), C and rho as the solver forms
    them (a 7-tap motion PSF), from seeded numpy draws."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((n, h, w)).astype(np.float32))
    y = torch.from_numpy(rng.random((n, h, w)).astype(np.float32))
    psf = torch.zeros((7, 7))
    psf[3, :] = 1.0 / 7.0
    otf = psf_to_otf(psf, (h, w))
    rho = (torch.from_numpy(rng.uniform(0.01, 0.05, (n, 1, 1)).astype(np.float32))
           if per_plane else torch.tensor(RHO))
    c = 1.0 / (torch.abs(otf) ** 2 + rho * laplacian_spectrum((h, w), dtype=torch.float32))
    return torch.fft.rfft2(q), torch.conj(otf) * torch.fft.rfft2(y), c, rho


SHAPES = [(3, 16, 24), (3, 16, 25), (2, 9, 31), (4, 12, 18)]


@pytest.mark.parametrize("per_plane", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_pass_equals_composition(shape, per_plane):
    f, b, c, rho = _operands(0, *shape, per_plane)
    assert c.shape == ((shape[0],) if per_plane else ()) + f.shape[1:]
    want = c * (b + rho * f)
    got_f = f.clone()
    out = spectral_rhs(got_f, b, c, rho)
    assert out.data_ptr() == got_f.data_ptr()  # written into F
    assert torch.equal(out, want)
    assert torch.equal(_spectral_rhs_plain(f, b, c, rho), want)


@pytest.mark.parametrize("per_plane", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_arithmetic_equals_composition(shape, per_plane):
    """``C * (Br + rho * Fr)``, part by part and rounded after each
    operation as the CUDA kernel computes it, is the composition's values."""
    f, b, c, rho = _operands(1, *shape, per_plane)
    by_part = torch.complex(c * (b.real + rho * f.real), c * (b.imag + rho * f.imag))
    assert torch.equal(by_part, c * (b + rho * f))


def _bad_cases():
    f, b, c, rho = _operands(2, 3, 8, 10, False)
    n, h, wf = f.shape
    wide = torch.zeros((n, h, 2 * wf), dtype=torch.complex64)
    return {
        "F not contiguous": (wide[..., ::2], b, c, rho),
        "F complex128": (f.to(torch.complex128), b.to(torch.complex128), c, rho),
        "F two-dimensional": (f[0], b[0], c, rho),
        "B conjugate view": (f, torch.conj(b), c, rho),
        "B of another shape": (f, b[:2], c, rho),
        "C float64": (f, b, c.double(), rho),
        "C of another shape": (f, b, c[:, :-1].contiguous(), rho),
        "C not contiguous": (f, b, c.t().contiguous().t(), rho),
        "rho (N,)": (f, b, c, torch.full((n,), RHO)),
        "rho a Python float": (f, b, c, RHO),
        "rho float64": (f, b, c, rho.double()),
        "F on the meta device": (f.to("meta"), b.to("meta"), c.to("meta"), rho.to("meta")),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_rejects_bad_operands(case):
    with pytest.raises(ValueError):
        spectral_rhs(*_bad_cases()[case])


def test_rejects_an_operand_that_requires_grad():
    f, b, c, rho = _operands(3, 2, 8, 10, False)
    rho = rho.clone().requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        spectral_rhs(f, b, c, rho)
    with torch.no_grad():
        assert torch.equal(spectral_rhs(f.clone(), b, c, rho), c * (b + rho * f))


def _composition_only(b_f, c_spec, rho, q, h, w):
    """The x-update as it was before the pass: the three torch calls."""
    q = q.to(c_spec.dtype)
    return torch.fft.irfft2(c_spec * (b_f + rho * torch.fft.rfft2(q)), s=(h, w))


def _counting(monkeypatch) -> list:
    calls = []

    def counted(*args):
        calls.append(1)
        return spectral_rhs(*args)

    monkeypatch.setattr(solver, "spectral_rhs", counted)
    return calls


def _scene(seed: int):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.random((2, 24, 30, 3)).astype(np.float32))
    psf = torch.zeros((7, 7))
    psf[3, :] = 1.0 / 7.0
    return y, psf


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_solve_takes_the_pass_without_a_graph(monkeypatch, state_dtype):
    """A solve that records no graph goes through the pass at every
    x-update (iters of them) and returns the composition's bits."""
    y, psf = _scene(4)
    kw = {"psf": psf, "lam": LAM, "rho": RHO, "iters": 12, "state_dtype": state_dtype}
    calls = _counting(monkeypatch)
    x = tv_deconvolve(y, **kw)
    assert len(calls) == 12
    monkeypatch.setattr(solver, "_solve_spectral", _composition_only)
    assert torch.equal(x, tv_deconvolve(y, **kw))
    assert len(calls) == 12


def test_gradient_keeps_the_composition(monkeypatch):
    """A gradient through ``tv_deconvolve`` in rho records a graph: the
    x-update keeps the composition (the pass is never called, on either
    device), and dL/drho is the composition's value exactly."""
    y, psf = _scene(5)

    def grad_rho():
        rho = torch.tensor(RHO, requires_grad=True)
        x = tv_deconvolve(y, psf=psf, lam=LAM, rho=rho, iters=8, remat=True)
        return torch.autograd.grad((x ** 2).sum(), rho)[0]

    calls = _counting(monkeypatch)
    got = grad_rho()
    assert calls == [] and spectral_rhs.launches == 0
    monkeypatch.setattr(solver, "_solve_spectral", _composition_only)
    assert torch.equal(got, grad_rho())
    assert bool(torch.isfinite(got))


@pytest.mark.parametrize("per_plane", [False, True])
@pytest.mark.parametrize("shape", [(3, 16, 24), (2, 9, 31)])
def test_x_update_matches_jax(shape, per_plane):
    """The port's ``_solve_spectral`` (through the pass) against the JAX
    package's on the same numpy spectra, rho, C and q."""
    n, h, w = shape
    f, b, c, rho = _operands(6, n, h, w, per_plane)
    q = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    got = solver._solve_spectral(b, c, rho, torch.from_numpy(q), h, w)
    want = jax_solve_spectral(b.numpy(), c.numpy(), rho.numpy(), q, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_spectra_take_the_standard_layout(monkeypatch):
    """cuFFT returns a 2-D rfft2 with its rows fastest; the solver's B and C
    built from such an OTF are contiguous all the same (the pass reads
    them as flat arrays), and the solve's bits do not move."""
    y, psf = _scene(8)
    kw = {"psf": psf, "lam": LAM, "rho": torch.tensor([RHO, 2 * RHO]), "iters": 6}
    want = tv_deconvolve(y, **kw)
    made = solver.psf_to_otf

    def rows_fastest(*args):
        otf = made(*args)
        return otf.t().contiguous().t()

    monkeypatch.setattr(solver, "psf_to_otf", rows_fastest)
    assert not rows_fastest(psf, (24, 30)).is_contiguous()
    _, b_f, denom_h, lap, _, rho_f, _ = solver._prepare(y, psf, LAM, kw["rho"])
    c_spec = solver._form_cspec(denom_h, lap, rho_f)
    assert b_f.is_contiguous() and c_spec.is_contiguous() and c_spec.shape == b_f.shape
    calls = _counting(monkeypatch)
    assert torch.equal(tv_deconvolve(y, **kw), want)
    assert len(calls) == 6
