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
PORT_FILES = sorted((REPO / "admm_deconv_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
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
        "model = build_model('admm_denoiser')\n"
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


def test_chip_smoke_refuses_without_cuda():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
