"""The row marches behind the stencil kernels (``csrc/stencil_march.cuh``
for the forward and tile-halo kernels, ``csrc/stencil_bwd.cu`` for the
backward), on the CPU.

A block of the march owns a strip of rows of one plane and reads only its
own rows, the x row above and the (x, ux, uy) rows below.  So the strips,
each computed by the tile kernel's plain twin ``_halo_plain`` from those
rows alone, must rebuild the circular stencil ``_stencil_plain`` (and a
tile's own ``_halo_plain``) bit for bit.  And ``march_geometry``, which
cuts a stack into those strips and column chunks, must cover every row of
every plane and every column once, never let a strip cross a plane, and
give the small tile stacks enough blocks to fill an H100.  The kernel
itself is held against the plain twins on the card by ``chip_smoke.py``.

The backward march reads, for a strip of rows ``r0 .. r1 - 1``, x and gq on
rows ``r0 - 1 .. r1`` and the duals and cotangents on rows ``r0 .. r1``
(one row of vb below the strip), circular in H.  Strips computed from those
rows alone must rebuild ``_bwd_plain``'s xbar, uxbar and uybar bit for bit;
and ``bwd_march_geometry`` must cover every row and column once, keep each
256-column segment of the tau table in one chunk, and keep every stack the
operand checks let through inside the grid.
"""

import os
import sys

import numpy as np
import pytest
import torch

from admm_deconv_tpu_torch.ops.kernels.prox_math import MODES, prox_vjp
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import (
    _BWD_SEGMENT,
    _GRID_Y_MAX,
    _INT32_MAX,
    _MARCH_ROWS,
    _MARCH_ROWS_FWD_FP32,
    _MARCH_VEC,
    _bwd_plain,
    _halo_plain,
    _stencil_plain,
    _tau_operand,
    _vec_ok,
    bwd_march_geometry,
    march_geometry,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402

torch.set_num_threads(2)

H100_SMS = 132
DUALS = [torch.float32, torch.bfloat16]


def _stack(rng, shape, dual):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ux, uy = (torch.from_numpy((0.5 * rng.standard_normal(shape)).astype(np.float32)).to(dual)
              for _ in range(2))
    return x, ux, uy


def _taus(rng, n):
    return [torch.tensor(0.3), torch.from_numpy(rng.uniform(0.1, 0.5, n).astype(np.float32))]


def _by_strips(x, ux, uy, top, bottom, tau, mode, rows):
    """The stencil of a stack of h rows, strip by strip as the march cuts it:
    each strip from its own rows, the x row above (``top`` above row 0) and
    the x, ux, uy rows below (``bottom`` below row h - 1), by
    ``_halo_plain``."""
    h = x.shape[1]
    outs = []
    for r0 in range(0, h, rows):
        r1 = min(r0 + rows, h)
        x_top = top if r0 == 0 else x[:, r0 - 1:r0]
        below = bottom if r1 == h else tuple(a[:, r1:r1 + 1] for a in (x, ux, uy))
        outs.append(_halo_plain(x[:, r0:r1], ux[:, r0:r1], uy[:, r0:r1], x_top, *below,
                                tau, mode))
    return tuple(torch.cat([o[k] for o in outs], dim=1) for k in range(3))


def _jax_state() -> str:
    """Whether the JAX package was imported in this process, and whether a
    JAX backend has run in it."""
    bridge = sys.modules.get("jax._src.xla_bridge")
    backends = sorted(getattr(bridge, "_backends", None) or {})
    return f"jax imported {'jax' in sys.modules}, backends run {backends}"


def _strips_report(args, rows, want, got, evaluations: int = 3) -> str:
    """For a failed comparison of the strips with the circular stencil
    (``args`` = ``(x, ux, uy, top, bottom, tau, mode)``): each side
    evaluated ``evaluations`` times more and how far each moved from its
    first reading; the elements that differ (how many a plane, the first
    few by index, the largest difference) and each side against the
    circular stencil in float64; the alignment mod 64 of every operand's
    and output's data; torch's thread count and CPU capability; and
    whether JAX has run in the process."""
    x, ux, uy, top, bottom, tau, mode = args
    moved = {"circular": [], "strips": []}
    for _ in range(evaluations):
        w2 = _stencil_plain(x, ux, uy, tau, mode)
        g2 = _by_strips(x, ux, uy, top, bottom, tau, mode, rows)
        for side, first, again in (("circular", want, w2), ("strips", got, g2)):
            moved[side].append(max(float((a.double() - b.double()).abs().max())
                                   for a, b in zip(first, again)))
    ref = _stencil_plain(*(a.double() for a in (x, ux, uy, tau)), mode)
    lines = [f"{mode}, tau {'scalar' if tau.ndim == 0 else 'per plane'}; evaluated "
             f"{evaluations} times again, max |change| a time: {moved}"]
    for k, (g, w, r) in enumerate(zip(got, want, ref)):
        diff = g != w
        if not bool(diff.any()):
            continue
        idx = diff.nonzero()[:5].tolist()
        apart = float((g.double() - w.double()).abs().max())
        lines.append(
            f"output {k}: {int(diff.sum())} of {diff.numel()} differ, per plane "
            f"{diff.reshape(diff.shape[0], -1).sum(dim=1).tolist()}, first at (plane, row, "
            f"col) {idx}, max |strips - circular| {apart:.3e}; against float64: circular "
            f"{float((w.double() - r).abs().max()):.3e}, strips "
            f"{float((g.double() - r).abs().max()):.3e}")
    tensors = {"x": x, "ux": ux, "uy": uy, "tau": tau, **{f"circular[{k}]": w
               for k, w in enumerate(want)}, **{f"strips[{k}]": g for k, g in enumerate(got)}}
    lines.append("data_ptr % 64: " + ", ".join(f"{n} {t.data_ptr() % 64}"
                                               for n, t in tensors.items()))
    lines.append(f"torch threads {torch.get_num_threads()}, CPU capability "
                 f"{torch.backends.cpu.get_cpu_capability()}, {_jax_state()}")
    return "\n".join(lines)


@pytest.mark.parametrize("dual", DUALS, ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [1, 3, 16])
@pytest.mark.parametrize("shape", [(3, 37, 101), (2, 1, 64), (2, 24, 128), (6, 8, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_strips_rebuild_the_circular_stencil(rng, shape, rows, dual):
    """Strips of the circular stencil, the wrap rows (h - 1 above row 0, 0
    below row h - 1) as their edge rows, equal it bit for bit.  A failure
    carries ``_strips_report``."""
    x, ux, uy = _stack(rng, shape, dual)
    top = x[:, -1:]
    bottom = (x[:, :1], ux[:, :1], uy[:, :1])
    for tau in _taus(rng, shape[0]):
        for mode in MODES:
            want = _stencil_plain(x, ux, uy, tau, mode)
            got = _by_strips(x, ux, uy, top, bottom, tau, mode, rows)
            if not all(g.dtype == dual and torch.equal(g, w) for g, w in zip(got, want)):
                report = _strips_report((x, ux, uy, top, bottom, tau, mode), rows, want, got)
                pytest.fail(f"{(mode, tau.ndim)}\n{report}")


@pytest.mark.parametrize("dual", DUALS, ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [1, 3, 16])
def test_strips_rebuild_a_tile_with_its_halos(rng, rows, dual):
    """A tile's strips, its neighbours' rows as the outer edge rows, equal
    the tile computed whole; fp32 halo rows beside bf16 duals, as the tiled
    solver hands them."""
    shape = (3, 20, 64)
    n, _, w = shape
    x, ux, uy = _stack(rng, shape, dual)
    top, *bottom = (torch.from_numpy(rng.standard_normal((n, 1, w)).astype(np.float32))
                    for _ in range(4))
    for tau in _taus(rng, n):
        for mode in MODES:
            want = _halo_plain(x, ux, uy, top, *bottom, tau, mode)
            got = _by_strips(x, ux, uy, top, tuple(bottom), tau, mode, rows)
            for g, wnt in zip(got, want):
                assert torch.equal(g, wnt), (mode, tau.ndim)


def _card_stacks():
    return sorted(set(chip_smoke.KERNEL_SHAPES) | set(chip_smoke.HALO_SHAPES)
                  | set(chip_smoke.HALO_TIME_SHAPES) | set(chip_smoke.MISALIGNED_SHAPES))


@pytest.mark.parametrize("rows", [_MARCH_ROWS_FWD_FP32, _MARCH_ROWS])
@pytest.mark.parametrize("shape", _card_stacks(), ids=lambda s: "x".join(map(str, s)))
def test_march_geometry_covers_each_row_and_column_once(shape, rows):
    """Each block's strip (blockIdx.y) lies in one plane, and the strips
    cover every row of every plane once; the threads' four columns cover W
    once (the last thread's tail included), with no warp left idle; the grid
    fits the launch limits and has at least 4 blocks for each SM of an H100
    wherever the stack has that many strip rows."""
    n, h, w = shape
    g = march_geometry(n, h, w, rows)
    assert 1 <= g.rows <= h and g.strips == -(-h // g.rows)
    assert n * g.strips <= _GRID_Y_MAX and g.threads % 32 == 0 and g.threads <= 256
    covered = np.zeros((n, h), dtype=np.int64)
    for y in range(n * g.strips):
        plane, r0 = y // g.strips, (y % g.strips) * g.rows
        assert r0 < h  # no empty strip, and none spills into the next plane
        covered[plane, r0:min(r0 + g.rows, h)] += 1
    assert (covered == 1).all()
    cols = np.zeros(w, dtype=np.int64)
    for t in range(g.chunks * g.threads):
        c = t * _MARCH_VEC
        cols[c:c + min(_MARCH_VEC, max(w - c, 0))] += 1
    assert (cols == 1).all()
    assert g.chunks * g.threads - -(-w // _MARCH_VEC) < 32
    blocks = g.chunks * n * g.strips
    assert blocks >= min(4 * H100_SMS, g.chunks * n * h)


def test_march_geometry_fills_the_small_tile_stacks():
    """The 4-card tiles, the smallest stacks that carry real work, get at
    least 4 blocks for each of the H100's SMs."""
    for shape in [(12, 270, 1920), (6, 540, 1920), (3, 540, 3840)]:
        for rows in (_MARCH_ROWS_FWD_FP32, _MARCH_ROWS):
            g = march_geometry(*shape, rows)
            assert g.chunks * shape[0] * g.strips >= 4 * H100_SMS, (shape, g)


def test_march_geometry_keeps_a_huge_stack_in_the_grid():
    """A stack with more strip rows than the grid's second axis takes taller
    strips; one with more planes than that axis is refused."""
    g = march_geometry(40000, 64, 64)
    assert 40000 * g.strips <= _GRID_Y_MAX and g.rows * g.strips >= 64
    with pytest.raises(ValueError, match="grid"):
        march_geometry(_GRID_Y_MAX + 1, 1, 64)


def test_vector_access_only_where_every_row_is_aligned():
    """The march's 16-byte (fp32) and 8-byte (bf16) accesses only where the
    width is a multiple of 4 and every array and halo row is aligned."""
    a = torch.zeros(2, 3, 8)
    b = torch.zeros(2, 3, 8, dtype=torch.bfloat16)
    assert _vec_ok(8, a, b)
    assert not _vec_ok(6, torch.zeros(2, 3, 6))
    assert not _vec_ok(8, a, torch.zeros(49)[1:].view(2, 3, 8))
    assert not _vec_ok(8, a, torch.zeros(49, dtype=torch.bfloat16)[1:].view(2, 3, 8))
    assert not _vec_ok(8, a, halo_stride=6)
    assert chip_smoke.misaligned(a).data_ptr() % 16 != 0


def test_tau_goes_to_the_kernel_without_a_copy():
    """A scalar tau is passed with plane stride 0 and a per-plane one with
    its own stride: no per-call tensor of n copies."""
    t = torch.tensor(0.25)
    got, stride = _tau_operand(t)
    assert stride == 0 and got.data_ptr() == t.data_ptr()
    v = torch.arange(12, dtype=torch.float32)[::3]
    got, stride = _tau_operand(v)
    assert stride == 3 and got.data_ptr() == v.data_ptr()


def _bwd_strip(x, ux, uy, tau, gq, gux, guy, mode, r0, r1):
    """Rows ``r0 .. r1 - 1`` of the backward's (xbar, uxbar, uybar), from
    only the rows the march reads for that strip: x and gq on rows ``r0 - 1
    .. r1``, the duals and cotangents on rows ``r0 .. r1`` (circular in H),
    with vb on rows ``r0 .. r1``; ``_bwd_plain``'s expressions."""
    h = x.shape[1]
    f = x.dtype

    def rows(a, lo, hi):
        return a[:, [r % h for r in range(lo, hi)]].to(f)

    t = tau if tau.ndim == 0 else tau[:, None, None]
    xs, gs = rows(x, r0 - 1, r1 + 1), rows(gq, r0 - 1, r1 + 1)
    xr, gr = xs[:, 1:], gs[:, 1:]
    vx = (xr - torch.roll(xr, 1, dims=-1)) + rows(ux, r0, r1 + 1)
    vy = (xr - xs[:, :-1]) + rows(uy, r0, r1 + 1)
    wbx, wby = gr - torch.roll(gr, 1, dims=-1), gr - gs[:, :-1]
    gx, gy = rows(gux, r0, r1 + 1), rows(guy, r0, r1 + 1)
    pvx, pvy, _ = prox_vjp(mode, vx, vy, t, 2.0 * wbx - gx, 2.0 * wby - gy)
    vbx = gx - wbx + pvx
    vby = gy - wby + pvy
    top = vbx[:, :-1]
    xbar = (top - torch.roll(top, -1, dims=-1)) + (vby[:, :-1] - vby[:, 1:])
    return xbar, top.to(ux.dtype), vby[:, :-1].to(ux.dtype)


@pytest.mark.parametrize("dual", DUALS, ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [1, 3, 16])
@pytest.mark.parametrize("shape", [(3, 37, 101), (2, 1, 64), (30, 112, 112), (6, 8, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_strips_rebuild_the_plain_backward(rng, shape, rows, dual):
    """Strips of the backward, each from only the rows its march reads (x
    and gq one row above, vb one row below), equal ``_bwd_plain``'s xbar,
    uxbar and uybar bit for bit, in every mode and for either tau."""
    x, ux, uy = _stack(rng, shape, dual)
    gq, gux, guy = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dual)
                    for _ in range(3))
    h = shape[1]
    for tau in _taus(rng, shape[0]):
        for mode in MODES:
            args = (x, ux, uy, tau, gq, gux, guy, mode)
            want = _bwd_plain(*args)[:3]
            strips = [_bwd_strip(*args, r0, min(r0 + rows, h)) for r0 in range(0, h, rows)]
            for k, w in enumerate(want):
                got = torch.cat([s[k] for s in strips], dim=1)
                assert got.dtype == w.dtype and torch.equal(got, w), (mode, tau.ndim, k)


def _bwd_card_stacks():
    return sorted(set(chip_smoke.BWD_SHAPES) | set(chip_smoke.MISALIGNED_SHAPES)
                  | set(chip_smoke.FLAGSHIP_STACKS) | {(2, 24, 300), (1, 4, 130)})


@pytest.mark.parametrize("cols,max_warps", [(None, None), (1, 8), (4, 2), (4, 8)])
@pytest.mark.parametrize("rows", [1, 2, 16])
@pytest.mark.parametrize("shape", _bwd_card_stacks(), ids=lambda s: "x".join(map(str, s)))
def test_bwd_march_geometry_covers_each_row_and_column_once(shape, rows, cols, max_warps):
    """Each block's strip (blockIdx.x) lies in one plane, and the strips
    cover every row of every plane once; the threads' columns cover W once,
    and every thread of a chunk lies in the chunk's 256-column segment of
    the tau table (a chunk narrower than a segment only where it holds the
    whole row); one column a thread by default only where a block holds
    the whole row; the grid, its blocks and their shared memory fit the
    launch limits, with at least a block for each SM of an H100 wherever
    the stack has that many strip rows."""
    n, h, w = shape
    g = bwd_march_geometry(n, h, w, rows, max_warps, cols)
    assert g.cols == (cols or (1 if w <= 1024 else 4))
    chunk = 32 * g.chunk_warps
    chunks = g.threads // chunk
    assert chunk * g.cols == _BWD_SEGMENT or (chunk * g.cols >= w and w <= _BWD_SEGMENT)
    assert 1 <= g.rows <= min(rows, h) and g.strips == -(-h // g.rows)
    assert n * g.strips <= _INT32_MAX and g.col_blocks <= _GRID_Y_MAX
    assert g.threads % chunk == 0 and g.threads <= (1024 if g.cols == 1 else 256)
    assert g.col_blocks * chunks == -(-w // _BWD_SEGMENT)
    if cols is None and g.cols == 1:
        assert g.col_blocks == 1
    assert (2 * g.threads // 32 + chunks * g.rows * 8) * 4 <= 48 * 1024
    covered = np.zeros((n, h), dtype=np.int64)
    for y in range(n * g.strips):
        plane, r0 = y // g.strips, (y % g.strips) * g.rows
        assert r0 < h
        covered[plane, r0:min(r0 + g.rows, h)] += 1
    assert (covered == 1).all()
    cols_seen = np.zeros(w, dtype=np.int64)
    for t in range(g.col_blocks * g.threads):
        c = t * g.cols
        if c < w:
            assert t // chunk == c // _BWD_SEGMENT
        cols_seen[c:c + min(g.cols, max(w - c, 0))] += 1
    assert (cols_seen == 1).all()
    blocks = g.col_blocks * n * g.strips
    assert blocks >= min(H100_SMS, g.col_blocks * n * h, g.col_blocks * n * -(-h // rows))


def test_bwd_march_geometry_keeps_a_huge_stack_in_the_grid():
    """Planes and strips share the grid's first axis, so a stack with more
    planes than the forward's grid takes (up to the operand checks' 2^31 - 1
    rows) still fits; a row of more than 65535 blocks is refused."""
    for shape in [(40000, 64, 64), (_GRID_Y_MAX + 1, 1, 64), (_INT32_MAX, 1, 4),
                  (1, _INT32_MAX, 4)]:
        g = bwd_march_geometry(*shape)
        assert shape[0] * g.strips <= _INT32_MAX and g.rows * g.strips >= shape[1]
    with pytest.raises(ValueError, match="grid"):
        bwd_march_geometry(1, 1, (_GRID_Y_MAX + 1) * _BWD_SEGMENT, max_warps=2)
