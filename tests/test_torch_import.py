"""The PyTorch port stands alone: it imports and solves with JAX blocked,
never imports the JAX package, builds nothing at import, and its GPU smoke
script refuses to run without a CUDA device or outside a checkout."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "admm_deconv_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_smoke_multi.py", REPO / "chip_times.py"]
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|admm_deconv_tpu)(\.|\s|$)", re.M)


def _run(code_or_args, cwd=REPO, timeout=120):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = {**os.environ, "PYTHONPATH": "", "OMP_NUM_THREADS": "2"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout,
    )


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_port_sources(path):
    assert not _FORBIDDEN.search(path.read_text()), path


def test_port_solves_with_jax_blocked():
    proc = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import admm_deconv_tpu_torch as adt\n"
        "from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk\n"
        "y = torch.rand(2, 16, 24, 3, generator=torch.Generator().manual_seed(0))\n"
        "psf = torch.zeros(5, 5); psf[2, :] = 0.2\n"
        "x = adt.tv_deconvolve(y, psf=psf, lam=0.01, rho=0.1, iters=4)\n"
        "xb = adt.tv_deconvolve(y, psf=psf, lam=0.01, rho=0.1, iters=4,\n"
        "                       state_dtype='bfloat16')\n"
        "assert x.shape == y.shape and bool(torch.isfinite(x).all())\n"
        "assert bool(torch.isfinite(adt.peak_snr(x, y)))\n"
        "assert float((x - xb).abs().max()) < 0.05\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "        or m == 'admm_deconv_tpu' or m.startswith('admm_deconv_tpu.')]\n"
        "assert mods == ['jax'], mods\n"
        "assert sk._kernel_fn.cache_info().currsize == 0, 'kernel built on CPU'\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_trains_with_jax_blocked():
    """Every module of the training slice imports without jax, and one
    flagship train step (gmsd + AdaBelief) runs at 96^2."""
    proc = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import admm_deconv_tpu_torch.layers, admm_deconv_tpu_torch.models\n"
        "import admm_deconv_tpu_torch.metrics, admm_deconv_tpu_torch.optim\n"
        "import admm_deconv_tpu_torch.train, admm_deconv_tpu_torch.utils.params_io\n"
        "from admm_deconv_tpu_torch.models import build_model\n"
        "from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk\n"
        "from admm_deconv_tpu_torch.train import TrainConfig, Trainer\n"
        "model = build_model('admm_denoiser', device='cpu')\n"
        "model.DenoiserBank_0.iters = 2\n"
        "trainer = Trainer(model, TrainConfig(lr_rate=1e-4, checkpointing=False))\n"
        "state = trainer.init_state(torch.Generator().manual_seed(0))\n"
        "g = torch.Generator().manual_seed(1)\n"
        "x, y = torch.rand(1, 96, 96, 3, generator=g), torch.rand(1, 96, 96, 3, generator=g)\n"
        "before = [p.detach().clone() for p in model.parameters()]\n"
        "acc = trainer.train_step(state, x, y, trainer._zero_acc())\n"
        "assert state.step == 1 and bool(torch.isfinite(acc['loss']))\n"
        "assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "        or m == 'admm_deconv_tpu' or m.startswith('admm_deconv_tpu.')]\n"
        "assert mods == ['jax'], mods\n"
        "assert sk._kernel_fn.cache_info().currsize == 0, 'kernel built on CPU'\n"
        "assert sk._bwd_kernel_fn.cache_info().currsize == 0, 'kernel built on CPU'\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_inference_solvers_run_with_jax_blocked():
    """The inference slice's modules import without jax; solve_auto (both
    branches) and the composite solvers run, and no kernel is built."""
    proc = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import admm_deconv_tpu_torch as adt\n"
        "import admm_deconv_tpu_torch.ops.composite, admm_deconv_tpu_torch.ops.policy\n"
        "from admm_deconv_tpu_torch.ops.kernels import prox_kernels as pk, stencil_kernels as sk\n"
        "y = torch.rand(1, 16, 24, 3, generator=torch.Generator().manual_seed(0))\n"
        "psf = torch.zeros(5, 5); psf[2, :] = 0.2\n"
        "x, d = adt.solve_auto(y, psf=psf, lam=0.01, rho=0.1, iters=8)\n"
        "assert x.shape == y.shape and int(d.iterations) == 8\n"
        "x, d = adt.solve_auto(y, psf=psf, lam=0.01, rho=0.1, max_iters=16)\n"
        "assert bool(torch.isfinite(x).all()) and int(d.iterations) % 8 == 0\n"
        "x = adt.composite_tv_deconvolve(y, psf=psf, lam_l1=0.002, x_bounds=(0, 1), iters=5)\n"
        "assert float(x.min()) >= 0 and float(x.max()) <= 1\n"
        "x, d = adt.composite_tv_deconvolve_adaptive(y, psf=psf, max_iters=4)\n"
        "assert bool(torch.isfinite(adt.tv_objective(x, y, psf, 0.01)))\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "        or m == 'admm_deconv_tpu' or m.startswith('admm_deconv_tpu.')]\n"
        "assert mods == ['jax'], mods\n"
        "for fn in (sk._kernel_fn, sk._composite_kernel_fn, pk._kernel_fn):\n"
        "    assert fn.cache_info().currsize == 0, 'kernel built on CPU'\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_tiled_solvers_run_with_jax_blocked():
    """The tiled slice (``parallel/``) imports without jax; both tiled
    solvers run on a one-rank CPU mesh, and no kernel is built."""
    proc = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk\n"
        "from admm_deconv_tpu_torch.parallel import (\n"
        "    make_mesh, tiled_composite_tv_deconvolve, tiled_tv_deconvolve)\n"
        "mesh = make_mesh({'tile': 1}, device_type='cpu')\n"
        "y = torch.rand(2, 16, 24, 3, generator=torch.Generator().manual_seed(0))\n"
        "psf = torch.zeros(5, 5); psf[2, :] = 0.2\n"
        "x = tiled_tv_deconvolve(y, psf=psf, lam=0.01, rho=0.1, iters=4, mesh=mesh)\n"
        "assert x.shape == y.shape and bool(torch.isfinite(x).all())\n"
        "x, d = tiled_tv_deconvolve(y, psf=psf, lam=0.01, rho=0.1, iters=8, mesh=mesh,\n"
        "                           adapt_rho=True, early_stop=True, check_every=4,\n"
        "                           return_diagnostics=True, state_dtype='bfloat16')\n"
        "assert int(d.iterations) % 4 == 0\n"
        "z = tiled_composite_tv_deconvolve(y, psf=psf, x_bounds=(0, 1), iters=4, mesh=mesh)\n"
        "assert float(z.min()) >= 0 and float(z.max()) <= 1\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "        or m == 'admm_deconv_tpu' or m.startswith('admm_deconv_tpu.')]\n"
        "assert mods == ['jax'], mods\n"
        "assert sk._halo_kernel_fn.cache_info().currsize == 0, 'kernel built on CPU'\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_solver_family_runs_with_jax_blocked():
    """The rest of the solver family imports without jax: the Anderson
    solvers (single-device and tiled), the implicit gradient and its layer,
    and ``utils``; every new name is exported; no kernel is built."""
    proc = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import admm_deconv_tpu_torch as adt\n"
        "import admm_deconv_tpu_torch.ops.implicit, admm_deconv_tpu_torch.utils as utils\n"
        "import admm_deconv_tpu_torch.utils.arrays, admm_deconv_tpu_torch.utils.diff3d\n"
        "import admm_deconv_tpu_torch.utils.debug, admm_deconv_tpu_torch.utils.profiling\n"
        "from admm_deconv_tpu_torch import ops, parallel\n"
        "from admm_deconv_tpu_torch.layers import ADMMDeconv\n"
        "from admm_deconv_tpu_torch.ops.kernels import prox_kernels as pk, stencil_kernels as sk\n"
        "for name in ('tv_deconvolve_anderson', 'anderson_history_bytes',\n"
        "             'tv_deconvolve_implicit'):\n"
        "    assert name in adt.__all__ and name in ops.__all__, name\n"
        "assert 'psf_to_otf_full' in ops.__all__\n"
        "assert 'tiled_tv_deconvolve_anderson' in parallel.__all__\n"
        "assert len(utils.__all__) == 10 and all(hasattr(utils, n) for n in utils.__all__)\n"
        "y = torch.rand(2, 16, 24, 3, generator=torch.Generator().manual_seed(0))\n"
        "psf = torch.zeros(5, 5); psf[2, :] = 0.2\n"
        "x, d = adt.tv_deconvolve_anderson(y, psf=psf, lam=0.01, rho=0.1, iters=9, m='auto',\n"
        "                                  aa_interval=4)\n"
        "assert x.shape == y.shape and int(d.iterations) == 9\n"
        "assert adt.anderson_history_bytes(tuple(y.shape), 5) == 2 * 6 * 6 * 4 * 16 * 24 * 4\n"
        "mesh = parallel.make_mesh({'tile': 1}, device_type='cpu')\n"
        "xt, dt = parallel.tiled_tv_deconvolve_anderson(y, psf=psf, lam=0.01, rho=0.1, iters=9,\n"
        "                                               aa_interval=4, mesh=mesh)\n"
        "assert float((xt - x).abs().max()) < 1e-5\n"
        "lam = torch.tensor(0.01, requires_grad=True)\n"
        "adt.tv_deconvolve_implicit(y, psf=psf, lam=lam, rho=0.1, iters=6, bwd_iters=3)\\\n"
        "    .sum().backward()\n"
        "assert bool(torch.isfinite(lam.grad))\n"
        "layer = ADMMDeconv(kernel_shape=(3, 3), iters=3, diff_mode='implicit', bwd_iters=2,\n"
        "                   lam_init=0.01, rho_init=0.1)\n"
        "layer(y).sum().backward()\n"
        "assert bool(torch.isfinite(layer.weight.grad).all())\n"
        "with utils.deterministic_mode(), utils.trace_annotation('solve'):\n"
        "    adt.tv_deconvolve(y, psf=psf, iters=2)\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "        or m == 'admm_deconv_tpu' or m.startswith('admm_deconv_tpu.')]\n"
        "assert mods == ['jax'], mods\n"
        "for fn in (sk._kernel_fn, sk._halo_kernel_fn, pk._kernel_fn):\n"
        "    assert fn.cache_info().currsize == 0, 'kernel built on CPU'\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_data_and_scripts_run_with_jax_blocked(tmp_path):
    """``data`` and the three entry points import without jax; the native
    loader builds into the directory it is given and loads that library,
    never the tracked ``native/build/libimagefeeder.so``; the demo's
    ``run`` solves on the CPU; no kernel is built."""
    proc = _run(
        "import sys, ctypes\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "opened = []\n"
        "_cdll = ctypes.CDLL.__init__\n"
        "def cdll(self, name, *a, **k):\n"
        "    opened.append(str(name))\n"
        "    _cdll(self, name, *a, **k)\n"
        "ctypes.CDLL.__init__ = cdll\n"
        "import admm_deconv_tpu_torch.data as data\n"
        "from admm_deconv_tpu_torch.data import native\n"
        "from admm_deconv_tpu_torch.scripts import demo_deconv, make_dataset, train\n"
        "from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk\n"
        "from pathlib import Path\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "assert native.available()\n"
        "fx = 'tests/fixtures'\n"
        "x, y = data.ImageDataFeeder(fx, fx, '.png', (64, 64), (64, 64), backend='native',\n"
        "                            rng=np.random.default_rng(0))[[0, 1, 2]]\n"
        "assert x.shape == (3, 64, 64, 3) and np.array_equal(x, y)\n"
        "assert len(data.__all__) == 10 and all(hasattr(data, n) for n in data.__all__)\n"
        "tracked = (Path('native') / 'build' / 'libimagefeeder.so').resolve()\n"
        "assert opened and all(Path(p).resolve() != tracked for p in opened), opened\n"
        "assert all(Path(p).parent == Path(native.BUILD_DIR) for p in opened), opened\n"
        "args = demo_deconv.parser().parse_args(['--iters', '3', '--device', 'cpu'])\n"
        "restored, m = demo_deconv.run(args, demo_deconv.synthetic_images(n=1, size=32))\n"
        "assert restored.shape == (1, 32, 32, 3) and np.isfinite(m['mean_ssim'])\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "        or m == 'admm_deconv_tpu' or m.startswith('admm_deconv_tpu.')]\n"
        "assert mods == ['jax'], mods\n"
        "for fn in (sk._kernel_fn, sk._bwd_kernel_fn, sk._composite_kernel_fn):\n"
        "    assert fn.cache_info().currsize == 0, 'kernel built on CPU'\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_multi_imports_with_jax_blocked():
    """The multi-card script and every module its ranks import load with
    jax and the JAX package blocked."""
    proc = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['admm_deconv_tpu'] = None\n"
        "import chip_smoke_multi\n"
        "import admm_deconv_tpu_torch.parallel, admm_deconv_tpu_torch.scripts.train\n"
        "import admm_deconv_tpu_torch.data, admm_deconv_tpu_torch.layers\n"
        "from admm_deconv_tpu_torch.ops.kernels import stencil_kernels as sk\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "        or m == 'admm_deconv_tpu' or m.startswith('admm_deconv_tpu.')]\n"
        "assert sorted(mods) == ['admm_deconv_tpu', 'jax'], mods\n"
        "assert sk._halo_kernel_fn.cache_info().currsize == 0, 'kernel built on CPU'\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout


def test_chip_times_refuses_without_cuda():
    """The kernel-time script prints no time without a card."""
    proc = _run(["chip_times.py"])
    assert proc.returncode != 0
    assert "ms" not in proc.stdout


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
