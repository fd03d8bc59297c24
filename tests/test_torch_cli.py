"""The port's three entry points (``admm_deconv_tpu_torch.scripts``) beside
the JAX package's ``scripts/`` on the CPU.

* ``make_dataset``: the same arguments on temporary directories give the
  same file lists, the same bytes and the same printed line, single and
  dual split; the same argument errors.
* ``demo_deconv``: two 64x64 PNGs, ``--iters 20``, each of the six branches
  with ``--device cpu`` against the JAX script on ``JAX_PLATFORMS=cpu``:
  the printed SSIM and PSNR agree to their printed precision, give or take
  one in the last digit (0.0001 SSIM, 0.01 dB), and so do the branches'
  iteration counts; the argument errors are the JAX script's.
* ``train``: one epoch of the production model (``admm_denoiser``, gmsd +
  AdaBelief) from PNG files at 96^2 (the smallest crop its valid
  convolutions take), its CSV row and checkpoints, then a resume to the
  second epoch.
"""

import csv
import glob
import importlib.util
import json
import os
import re

import numpy as np
import pytest

from admm_deconv_tpu.data import save_image
from admm_deconv_tpu_torch.scripts import demo_deconv, make_dataset, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    """``scripts/<name>.py`` of the JAX package as a module, with its
    persistent compile cache off."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADMM_TPU_NO_COMPILE_CACHE", "1")
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_demo():
    return _jax_script("demo_deconv")


def _call(main, argv, capsys):
    """(exit code, stdout, stderr) of ``main(argv)``."""
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, out.out, out.err


# -- make_dataset -----------------------------------------------------------------


@pytest.fixture
def clean_dirs(tmp_path):
    rng = np.random.default_rng(12)
    for split, n in (("train", 3), ("test", 2)):
        (tmp_path / "clean" / split).mkdir(parents=True)
        for i in range(n):
            save_image(str(tmp_path / "clean" / split / f"img{i}.png"),
                       rng.random((20, 28, 3)).astype(np.float32))
    return tmp_path


def _tree(root):
    return {os.path.relpath(p, root): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True))
            if os.path.isfile(p)}


@pytest.mark.parametrize("mode", ["single", "dual"])
def test_make_dataset_equals_jax(clean_dirs, capsys, mode):
    jax_main = _jax_script("make_dataset").main
    outs = {}
    for name, main in (("port", make_dataset.main), ("jax", jax_main)):
        dest = str(clean_dirs / name)
        if mode == "single":
            argv = ["--src", str(clean_dirs / "clean" / "train"), "--dest", dest,
                    "--min-sigma", "5", "--max-sigma", "30", "--seed", "4"]
        else:
            argv = ["--train-src", str(clean_dirs / "clean" / "train"),
                    "--test-src", str(clean_dirs / "clean" / "test"), "--dest", dest]
        code, out, _ = _call(main, argv, capsys)
        assert code == 0
        outs[name] = (out.replace(dest, "<dest>"), _tree(dest))
    assert outs["port"][0] == outs["jax"][0] and outs["port"][0].startswith("wrote")
    assert outs["port"][1].keys() == outs["jax"][1].keys()
    assert len(outs["port"][1]) == (6 if mode == "single" else 10)
    for rel, data in outs["port"][1].items():
        assert data == outs["jax"][1][rel], rel


@pytest.mark.parametrize("argv", [["--train-src", "a"], [], ["--src", "a"]],
                         ids=["train_src_alone", "no_src", "no_dest"])
def test_make_dataset_errors_equal_jax(capsys, argv):
    jax_main = _jax_script("make_dataset").main
    port = _call(make_dataset.main, argv + (["--dest", "d"] if argv != ["--src", "a"] else []),
                 capsys)
    want = _call(jax_main, argv + (["--dest", "d"] if argv != ["--src", "a"] else []), capsys)
    assert port[0] == want[0] == 2
    assert port[2].splitlines()[-1].split("error: ")[1] == want[2].splitlines()[-1].split(
        "error: ")[1]


# -- demo_deconv -------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_src(tmp_path_factory):
    src = tmp_path_factory.mktemp("demo_src")
    for i, img in enumerate(demo_deconv.synthetic_images(n=2, size=64, seed=5)):
        save_image(str(src / f"frame{i}.png"), img)
    return src


BRANCHES = {
    "plain": [],
    "adaptive": ["--adaptive"],
    "l1": ["--l1", "0.002"],
    "anderson": ["--anderson", "--aa-interval", "4"],
    "auto": ["--auto"],
    # JAX's CPU "auto" is the plain path, which has no bf16 state: both
    # take the kernel path ("pallas": JAX's interpreted kernel, the port's
    # plain twin of its CUDA kernel).
    "bf16_state": ["--bf16-state", "--prox-impl", "pallas"],
}
_IMAGE = re.compile(r"image (\d+): SSIM ([\d.]+) -> ([\d.]+)   PSNR ([\d.]+) -> ([\d.]+) dB")


def _numbers(out):
    """The printed (image, SSIM before, SSIM after, PSNR before, PSNR after)
    rows, the mean SSIM and the branch's report in parentheses."""
    rows = [tuple(float(v) for v in m.groups()) for m in _IMAGE.finditer(out)]
    mean = float(re.search(r"mean restored SSIM: ([\d.]+)", out).group(1))
    extra = re.search(r"solver wall clock \(incl\. compile\): [\d.]+s(.*)", out).group(1)
    return rows, mean, extra


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_demo_prints_what_jax_prints(jax_demo, demo_src, tmp_path, capsys, branch):
    argv = ["--src", str(demo_src), "--iters", "20", *BRANCHES[branch]]
    code, out, err = _call(demo_deconv.main,
                           [*argv, "--out", str(tmp_path / "port"), "--device", "cpu"], capsys)
    assert code == 0, err
    jcode, jout, jerr = _call(jax_demo.main, [*argv, "--out", str(tmp_path / "jax")], capsys)
    assert jcode == 0, jerr
    assert out.splitlines()[-1] == jout.splitlines()[-1] == "ADMM demo finished with no errors!"
    rows, mean, extra = _numbers(out)
    jrows, jmean, jextra = _numbers(jout)
    assert len(rows) == len(jrows) == 2
    for row, jrow in zip(rows, jrows):
        assert row[0] == jrow[0]
        for k, unit in ((1, 1e-4), (2, 1e-4), (3, 1e-2), (4, 1e-2)):
            assert abs(row[k] - jrow[k]) <= unit * 1.01, (branch, row, jrow)
        assert row[4] > row[3] + 1.0  # the solve restores
    assert abs(mean - jmean) <= 1e-4 * 1.01
    # The same iteration counts; rho and the Anderson residual to their
    # printed digits, give or take one.
    its, jits = (re.findall(r"(\d+) iters", e) for e in (extra, jextra))
    assert its == jits, (extra, jextra)
    for v, jv in zip(re.findall(r"=([\d.]+)\)", extra), re.findall(r"=([\d.]+)\)", jextra)):
        assert abs(float(v) - float(jv)) <= 10 ** -len(v.split(".")[1]) * 1.01, (extra, jextra)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 6


@pytest.mark.parametrize("argv", [["--adaptive", "--auto"], ["--l1", "0.1", "--anderson"],
                                  ["--bf16-state", "--l1", "0.1"], ["--bf16-state", "--auto"]],
                         ids=["adaptive_auto", "l1_anderson", "bf16_l1", "bf16_auto"])
def test_demo_argument_errors_equal_jax(jax_demo, demo_src, tmp_path, capsys, argv):
    argv = ["--src", str(demo_src), "--out", str(tmp_path), *argv]
    code, _, err = _call(demo_deconv.main, [*argv, "--device", "cpu"], capsys)
    jcode, _, jerr = _call(jax_demo.main, argv, capsys)
    assert code == jcode == 2
    assert err.splitlines()[-1].split("error: ")[1] == jerr.splitlines()[-1].split("error: ")[1]


def test_demo_default_device_is_the_card(monkeypatch, demo_src, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="goes to the CUDA device"):
        demo_deconv.main(["--src", str(demo_src), "--out", str(tmp_path), "--iters", "2"])


def test_demo_run_is_numpy_in_numpy_out():
    args = demo_deconv.parser().parse_args(["--iters", "5", "--device", "cpu"])
    imgs = demo_deconv.synthetic_images(n=2, size=32, seed=1)
    restored, m = demo_deconv.run(args, imgs)
    assert isinstance(restored, np.ndarray) and restored.shape == (2, 32, 32, 3)
    assert restored.dtype == np.float32 and restored.min() >= 0 and restored.max() <= 1
    assert len(m["restored_psnr"]) == 2 and m["restored_psnr"][0] > m["blurred_psnr"][0]


# -- train ---------------------------------------------------------------------------


def test_train_cli_one_epoch_and_resume(tmp_path, capsys):
    rng = np.random.default_rng(21)
    for split, n in (("train", 2), ("test", 1)):
        for sub in ("x", "y"):
            (tmp_path / "data" / split / sub).mkdir(parents=True)
        for i in range(n):
            clean = rng.random((104, 100, 3)).astype(np.float32)
            save_image(str(tmp_path / "data" / split / "y" / f"{i}.png"), clean)
            save_image(str(tmp_path / "data" / split / "x" / f"{i}.png"),
                       np.clip(clean + 0.1 * rng.standard_normal(clean.shape), 0, 1))
    with open(os.path.join(REPO, "configs", "train_cfg.json")) as f:
        cfg = json.load(f)
    cfg |= {"train_data": {"x_path": str(tmp_path / "data/train/x"),
                           "y_path": str(tmp_path / "data/train/y")},
            "eval_data": {"x_path": str(tmp_path / "data/test/x"),
                          "y_path": str(tmp_path / "data/test/y")},
            "batch_size": 1, "im_shape": [96, 96], "epochs": 1, "lr_rate": 1e-4,
            "save_dir": str(tmp_path / "models")}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    argv = ["-c", str(cfg_path), "-n", "cli", "--device", "cpu"]
    code, out, err = _call(train.main, argv, capsys)
    assert code == 0, err
    lines = out.splitlines()
    assert lines[0] == f"Loading config {cfg_path}" and lines[-1] == "DONE"
    assert "MODEL SIZE (#parameters): " in out and "Building model admm_denoiser" in out
    assert any(line.startswith("TensorBoard: ") for line in lines)
    model_dir = tmp_path / "models" / "cli"
    with open(model_dir / "train_eval_metrics_history.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and all(np.isfinite(float(v)) for v in rows[0].values())
    assert os.listdir(model_dir / "checkpoints") == ["epoch_0.pt"]
    assert len(os.listdir(model_dir / "best")) == 1

    cfg_path.write_text(json.dumps(cfg | {"epochs": 2}))
    code, out, err = _call(train.main, argv, capsys)
    assert code == 0, err
    assert "resumed from epoch 1" in out and "[epoch 1]" in out and "[epoch 0]" not in out
    with open(model_dir / "train_eval_metrics_history.csv", newline="") as f:
        assert [int(float(r["epoch"])) for r in csv.DictReader(f)] == [0, 1]
