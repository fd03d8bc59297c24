"""The port's data pipeline (``admm_deconv_tpu_torch.data``) against the JAX
package's (``admm_deconv_tpu.data``), on the CPU.

The same PNG files and the same seeded ``numpy.random.Generator`` go through
both packages, and the batches must be equal bit for bit: on the PIL path,
on the native path (one ``rng.integers`` draw seeds the C++ loader's
splitmix64 crops) and through the shuffled loader.  The port's native
library is built into a temporary directory, never into ``native/build/``.
Also ported: ``tests/test_data.py``, ``tests/test_native.py`` and the
``DataLoader`` cases of ``tests/test_distributed.py``.
"""

import glob
import os
import subprocess

import numpy as np
import pytest

from admm_deconv_tpu import data as jd
from admm_deconv_tpu.data import native as jnative
from admm_deconv_tpu_torch import data as td
from admm_deconv_tpu_torch.data import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


@pytest.fixture(scope="module")
def port_native(tmp_path_factory):
    """The port's native loader, built into a temporary directory."""
    build = tmp_path_factory.mktemp("native_build")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative, "BUILD_DIR", build)
        mp.setattr(tnative, "_lib", None)
        mp.setattr(tnative, "_build_failed", False)
        if not tnative.available():
            pytest.fail("the native loader did not build (g++, make and libpng are here)")
        yield build


@pytest.fixture
def image_dirs(tmp_path):
    """Paired x/y dirs with 4 images each, written by the JAX package."""
    rng = np.random.default_rng(42)
    xd, yd = tmp_path / "x", tmp_path / "y"
    xd.mkdir()
    yd.mkdir()
    for i in range(4):
        img = (rng.random((40, 48, 3)) * 0.8).astype(np.float32)
        jd.save_image(str(yd / f"{i}.png"), img)
        jd.save_image(str(xd / f"{i}.png"), img + 0.1)
    return str(xd), str(yd)


def _equal(a, b):
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


# -- imageio -------------------------------------------------------------------


def test_imageio_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.random((16, 12, 3)).astype(np.float32)
    td.save_image(str(tmp_path / "t.png"), img)
    jd.save_image(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    _equal([td.load_image(str(tmp_path / "t.png"))], [jd.load_image(str(tmp_path / "j.png"))])
    np.testing.assert_allclose(td.load_image(str(tmp_path / "t.png")), img, atol=1 / 255 + 1e-6)
    for arr in ((rng.random((8, 8)) * 255).astype(np.uint8),
                (rng.random((8, 8, 3)) * 65535).astype(np.uint16), img.astype(np.float64)):
        _equal([td.img_to_tensor(arr)], [jd.img_to_tensor(arr)])
    assert td.img_to_tensor(np.zeros((8, 8), np.uint8)).shape == (8, 8, 1)
    clamped = np.asarray(td.tensor_to_img(np.array([[[2.0], [-1.0]]])))
    assert clamped.max() == 255 and clamped.min() == 0


# -- the feeder ------------------------------------------------------------------


@pytest.mark.parametrize("crop", [(16, 16), (32, 24), (40, 48)])
def test_pil_feeder_batches_equal_jax(image_dirs, crop):
    xd, yd = image_dirs
    feeders = [m.ImageDataFeeder(xd, yd, ".png", crop, crop, rng=np.random.default_rng(0),
                                 backend="pil") for m in (td, jd)]
    assert len(feeders[0]) == len(feeders[1]) == 4
    for idxs in ([0, 1], [3], 2, [2, 0, 1]):
        _equal(feeders[0][idxs], feeders[1][idxs])
    # Aligned crops: x = y + 0.1 everywhere.
    bx, by = feeders[0][[0]]
    assert float(np.abs(bx - by - 0.1).max()) < 2 / 255


@pytest.mark.parametrize("crop", [(16, 16), (24, 40), (40, 48)])
def test_native_feeder_batches_equal_jax(image_dirs, port_native, crop):
    xd, yd = image_dirs
    feeders = [m.ImageDataFeeder(xd, yd, ".png", crop, crop, rng=np.random.default_rng(3),
                                 backend="native") for m in (td, jd)]
    for idxs in ([0, 2], [1, 3, 0], [3]):
        _equal(feeders[0][idxs], feeders[1][idxs])
    assert feeders[0].rng.integers(0, 2**63) == feeders[1].rng.integers(0, 2**63)
    bx, by = feeders[0][[0, 2]]
    np.testing.assert_allclose(bx - by, 0.1, atol=2 / 255)


def test_fixture_batches_equal_jax_on_both_paths(port_native):
    """The repo's fixtures (3 x 256^2 RGB) at the crop ``chip_smoke.py``
    hashes, and the auto backend's choice."""
    for backend in ("native", "pil", "auto"):
        got, want = (m.ImageDataFeeder(FIXTURES, FIXTURES, ".png", (128, 128), (128, 128),
                                       rng=np.random.default_rng(0), backend=backend)[[0, 1, 2]]
                     for m in (td, jd))
        _equal(got, want)


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_shuffled_loader_equals_jax(image_dirs, port_native, backend):
    xd, yd = image_dirs

    def batches(m):
        feeder = m.ImageDataFeeder(xd, yd, ".png", (16, 16), (16, 16),
                                   rng=np.random.default_rng(5), backend=backend)
        loader = m.DataLoader(feeder, batch_size=3, shuffle=True, rng=np.random.default_rng(6))
        return [b for _ in range(2) for b in loader]

    got, want = batches(td), batches(jd)
    assert [b[0].shape[0] for b in got] == [3, 1, 3, 1]
    for a, b in zip(got, want, strict=True):
        _equal(a, b)


def test_whole_image_warning_equals_jax(image_dirs):
    xd, yd = image_dirs
    out = []
    for m in (td, jd):
        feeder = m.ImageDataFeeder(xd, yd, ".png", (100, 100), (100, 100), backend="pil")
        with pytest.warns(UserWarning, match="exceeds image size"):
            out.append(feeder[[0]])
    _equal(*out)
    assert out[0][1].shape[1:3] == (40, 48)
    with pytest.warns(UserWarning, match="empty list of images"):
        td.ImageDataFeeder(xd + "_none", yd, ".png")


def test_native_falls_back_to_pil_as_jax(image_dirs, port_native):
    """A crop larger than an image: the native loader raises ``IOError`` and
    the feeder falls back to PIL's whole image with a warning, as in JAX."""
    xd, yd = image_dirs
    out = []
    for m in (td, jd):
        feeder = m.ImageDataFeeder(xd, yd, ".png", (44, 44), (44, 44),
                                   rng=np.random.default_rng(0), backend="native")
        with pytest.warns(UserWarning, match="native loader fell back to PIL"):
            out.append(feeder[[0, 1]])
    _equal(*out)


def test_backend_errors_equal_jax(image_dirs, port_native, monkeypatch):
    xd, yd = image_dirs
    for m in (td, jd):
        with pytest.raises(ValueError, match="unknown backend 'gpu'"):
            m.ImageDataFeeder(xd, yd, backend="gpu")
        with pytest.raises(RuntimeError, match="equal fixed x/y crop shapes and PNGs"):
            m.ImageDataFeeder(xd, yd, ".png", (8, 8), (16, 16), backend="native")[[0]]
    monkeypatch.setattr(tnative, "_load_library", lambda: None)
    with pytest.raises(RuntimeError, match="native image loader could not be built"):
        td.ImageDataFeeder(xd, yd, ".png", (8, 8), (8, 8), backend="native")[[0]]
    # "auto" takes the PIL path where the loader did not build.
    _equal(td.ImageDataFeeder(xd, yd, ".png", (8, 8), (8, 8), rng=np.random.default_rng(0))[[1]],
           jd.ImageDataFeeder(xd, yd, ".png", (8, 8), (8, 8), rng=np.random.default_rng(0),
                              backend="pil")[[1]])


def _write_corpus(root, n=3):
    from PIL import Image

    rng = np.random.default_rng(9)
    lines = ["# comment line", ""]
    for i in range(n):
        (root / f"scene{i}").mkdir()
        for name in ("gt", "blur"):
            Image.fromarray((rng.random((20, 24, 3)) * 255).astype(np.uint8)).save(
                root / f"scene{i}" / f"{name}.png")
        lines.append(f"scene{i}/gt.png scene{i}/blur.png")
    (root / "RealBlur_J_train.txt").write_text("\n".join(lines))
    return root / "RealBlur_J_train.txt"


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_pair_list_equals_jax(tmp_path, port_native, backend):
    lst = _write_corpus(tmp_path)
    feeders = [m.ImageDataFeeder.from_pair_list(str(lst), x_shape=(8, 8), y_shape=(8, 8),
                                                rng=np.random.default_rng(0), backend=backend)
               for m in (td, jd)]
    assert feeders[0].x_paths == feeders[1].x_paths and feeders[0].y_paths == feeders[1].y_paths
    assert feeders[0].x_paths[0].endswith("scene0/blur.png")
    _equal(feeders[0][[0, 1]], feeders[1][[0, 1]])
    batches = list(td.DataLoader(feeders[0], batch_size=2))
    assert sum(b[0].shape[0] for b in batches) == 3
    (tmp_path / "bad.txt").write_text("only_one_token\n")
    with pytest.raises(ValueError, match="expected at least 2"):
        td.ImageDataFeeder.from_pair_list(str(tmp_path / "bad.txt"))
    (tmp_path / "empty.txt").write_text("# nothing\n")
    with pytest.warns(UserWarning, match="contains no entries"):
        td.ImageDataFeeder.from_pair_list(str(tmp_path / "empty.txt"))
    feeder = td.ImageDataFeeder.from_pair_list(str(lst), root=str(tmp_path))
    assert feeder.y_paths[0] == str(tmp_path / "scene0" / "gt.png")


# -- the native library ----------------------------------------------------------


def test_native_library_builds_in_its_own_place(port_native):
    """Built by ``make -C native`` into the given directory, keyed by a hash of
    the source, the Makefile and the flags; never the tracked library."""
    lib = tnative.library_path()
    assert lib.parent == port_native and lib.is_file()
    assert lib.name.startswith("libimagefeeder-") and "-march=native" not in tnative.CXXFLAGS
    assert os.path.realpath(tnative._lib._name) == os.path.realpath(lib)
    assert sorted(os.listdir(port_native)) == [lib.name]  # no build left-overs


def test_native_loader_matches_jax(image_dirs, port_native):
    xd, yd = image_dirs
    xs = sorted(glob.glob(os.path.join(xd, "*.png")))
    ys = sorted(glob.glob(os.path.join(yd, "*.png")))
    assert tnative.image_size(ys[0]) == jnative.image_size(ys[0]) == (40, 48)
    for seed in (0, 42, 2**63 + 5):
        _equal(tnative.load_pair_batch(xs, ys, 16, 24, seed),
               jnative.load_pair_batch(xs, ys, 16, 24, seed))
    _, by = tnative.load_pair_batch(xs, ys, 16, 16, seed=42)
    _, by3 = tnative.load_pair_batch(xs, ys, 16, 16, seed=43)
    assert not np.array_equal(by, by3)
    # The whole image: PIL's 8-bit decode, times 1/255 in float32 as the C++ does.
    bx, _ = tnative.load_pair_batch(ys, ys, 40, 48, seed=0)
    from PIL import Image

    for i, path in enumerate(ys):
        with Image.open(path) as im:
            u8 = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(bx[i], u8.astype(np.float32) * np.float32(1 / 255))
        np.testing.assert_allclose(bx[i], td.load_image(path), atol=1e-6)


def test_native_loader_errors_as_jax(image_dirs, port_native):
    _, yd = image_dirs
    ys = sorted(glob.glob(os.path.join(yd, "*.png")))
    for m in (tnative, jnative):
        with pytest.raises(IOError, match="crop larger"):
            m.load_pair_batch(ys, ys, 100, 100, seed=0)
        with pytest.raises(IOError, match="could not open file"):
            m.load_pair_batch(["/nope/a.png"], ["/nope/b.png"], 8, 8, seed=0)
        with pytest.raises(ValueError, match="equal length"):
            m.load_pair_batch(ys, ys[:1], 8, 8, seed=0)


def test_native_unavailable_without_a_compiler(tmp_path, monkeypatch):
    """No ``make``/``g++`` (or no libpng): ``available()`` is False and the
    loader raises, as in JAX; the feeder's "auto" takes PIL."""

    def no_make(*a, **k):
        raise FileNotFoundError("make")

    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    monkeypatch.setattr(subprocess, "run", no_make)
    assert not tnative.available()
    with pytest.raises(RuntimeError, match="native image loader unavailable"):
        tnative.image_size(os.path.join(FIXTURES, "china.png"))
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: (_ for _ in ()).throw(subprocess.CalledProcessError(2, a)))
    monkeypatch.setattr(tnative, "_build_failed", False)
    assert not tnative.available()


# -- dataset synthesis -----------------------------------------------------------


def test_noise_models_equal_jax():
    img = np.random.default_rng(0).random((32, 24, 3)).astype(np.float32)
    for fn, kw in (("add_awgn", {"min_sigma": 5.0, "max_sigma": 30.0}),
                   ("add_poisson_gaussian", {"peak": 60.0, "sigma": 4.0})):
        got = getattr(td, fn)(img, np.random.default_rng(7), **kw)
        want = getattr(jd, fn)(img, np.random.default_rng(7), **kw)
        _equal([got], [want])
        assert got.dtype == np.float32 and got.min() >= 0 and got.max() <= 1
    resid = (td.add_awgn(np.full((64, 64, 3), 0.5, np.float32), np.random.default_rng(1),
                         25, 25) - 0.5) * 255
    assert 15 < resid.std() < 35


def test_generate_dataset_and_splits_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    for split, n in (("train", 3), ("test", 2)):
        (tmp_path / split).mkdir()
        for i in range(n):
            jd.save_image(str(tmp_path / split / f"im{i}.png"),
                          rng.random((12, 14, 3)).astype(np.float32))
    for m, out in ((td, "port"), (jd, "jax")):
        assert m.generate_awgn_dataset(str(tmp_path / "train"), str(tmp_path / out / "one"),
                                       10, 20, seed=3) == 3
        assert m.generate_awgn_splits(str(tmp_path / "train"), str(tmp_path / "test"),
                                      str(tmp_path / out), 10.0, 10.0) == {"train": 3, "test": 2}
    files = sorted(os.path.relpath(p, tmp_path / "port")
                   for p in glob.glob(str(tmp_path / "port" / "**" / "*.png"), recursive=True))
    assert len(files) == 2 * (3 + 3 + 2) and "awgn_10_10/test/x/im0_0.png" in files
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


# -- the loader's multi-process contract -------------------------------------------


class _Pairs:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idxs):
        x = np.stack([np.full((4, 4, 1), i, np.float32) for i in np.asarray(idxs)])
        return x, x


def test_loader_shards_partition_each_batch_as_jax():
    loaders = [
        [m.DataLoader(_Pairs(8), batch_size=4, shuffle=True, rng=np.random.default_rng(7),
                      process_count=2, process_index=i) for i in range(2)]
        for m in (td, jd)
    ]
    for (x0, _), (x1, _), (j0, _), (j1, _) in zip(*loaders[0], *loaders[1]):
        assert x0.shape[0] == x1.shape[0] == 2
        ids = {int(v) for v in np.concatenate([x0, x1]).reshape(4, -1)[:, 0]}
        assert len(ids) == 4
        _equal([x0, x1], [j0, j1])


def test_loader_drop_last_and_rejections_as_jax():
    loader = td.DataLoader(_Pairs(7), batch_size=4, process_count=2, process_index=0)
    assert len(loader) == 1 and sum(1 for _ in loader) == 1
    single = td.DataLoader(_Pairs(7), batch_size=3)
    assert len(single) == 3 and [b[0].shape[0] for b in single] == [3, 3, 1]
    assert len(td.DataLoader(_Pairs(7), batch_size=3, drop_last=True)) == 2
    for m in (td, jd):
        with pytest.raises(ValueError, match="must be divisible by process_count 2"):
            m.DataLoader(_Pairs(8), batch_size=3, process_count=2)
        with pytest.raises(ValueError, match="process_index 2 out of range"):
            m.DataLoader(_Pairs(8), batch_size=4, process_count=2, process_index=2)
