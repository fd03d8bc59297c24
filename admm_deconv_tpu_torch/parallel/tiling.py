"""H-tiled ADMM deconvolution over a mesh of ranks (exact), on ``torch.distributed``.

Counterpart of ``admm_deconv_tpu/parallel/tiling.py``'s
``tiled_tv_deconvolve``, ``tiled_composite_tv_deconvolve`` and
``tiled_tv_deconvolve_anderson``.  Each image's
H axis is split over the mesh's ``tile`` axis and, with ``data_axis_name``,
the folded batch*channel planes over a second axis (a 2-D data x tile
mesh).  Each iteration runs distributed:

* **x-update**: an exact distributed rFFT2 by transposition.  A local rFFT
  along the unsplit W axis, one ``all_to_all`` that re-shards from H-tiles
  to groups of frequency columns, a local FFT along H, the closed-form solve
  against column-sliced cached spectra, then the inverse path (a second
  ``all_to_all``).
* **D / D^T**: a tile's neighbour rows arrive by an all-gather over the
  tile group; the tile ring is circular, as the operators are.  The fast
  loops run the whole stencil section as kernel Q2-4
  (:func:`~admm_deconv_tpu_torch.ops.kernels.stencil_kernels.fused_admm_stencil_halo`),
  its four halo rows in one gather.
* **residual norms**: per image, all-reduced over the tile group, so
  stopping and rho adaptation are shared by every tile.  The loop's count
  of unfinished images is all-reduced over the data group and read on the
  host once per check block, so every rank takes the same number of trips.

Calling contract: every rank passes the same global ``y`` (the JAX
package's global array); every rank gets back the whole ``x``, from one
all-gather after the loop; diagnostics are per image and the same on every
rank; a returned state is global ``(B*C, H, W)``, the layout of the JAX
package's tiled state.  A one-rank mesh runs the same collectives, each a
copy to itself.

Every ``fft_mode`` name computes the exact ``torch.fft`` path: the JAX
package's fold modes are TPU matmul DFTs and are not ported.  The names are
checked as the JAX package checks them.  Not differentiable: the
collectives carry no gradient, the solvers run under ``no_grad``, and an
input that requires a gradient raises, as ``jax.grad`` of the JAX package's
tiled solvers does.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from admm_deconv_tpu_torch.ops import prox as prox_lib
from admm_deconv_tpu_torch.ops.composite import _l1_box
from admm_deconv_tpu_torch.ops.fft import laplacian_spectrum, psf_to_otf
from admm_deconv_tpu_torch.ops.kernels.stencil_kernels import fused_admm_stencil_halo
from admm_deconv_tpu_torch.ops.solver import (
    ADMMDiagnostics,
    ADMMState,
    _AndersonMixer,
    _as_dtype,
    _check_anderson_args,
    _check_modes,
    _fold,
    _fold_param,
    _inference_only,
    _kernel_mode,
    _make_prox_step,
    _normalize_input,
    _refuse_grad,
    _unfold,
)
from admm_deconv_tpu_torch.parallel.distributed import all_gather_cat
from admm_deconv_tpu_torch.parallel.mesh import axis_size
from admm_deconv_tpu_torch.utils.arrays import as_tensor
from admm_deconv_tpu_torch.utils.profiling import trace_annotation

# The JAX tiled solver's fft_mode names ("auto" resolves to "xla").
_TILED_FFT_MODES = ("xla", "fold", "fold1", "fold_precise")
# Residual balancing: rho grows or shrinks by TAU_SCALE when one residual
# exceeds MU times the other (the JAX tiled solver's fixed values).
_MU, _TAU_SCALE = 10.0, 2.0


class _Tiles:
    """This rank's place on the mesh, and the tile-axis collectives.

    ``t``/``idx``/``group``: the tile axis's size, this rank's index on it
    and its process group; ``d``/``d_idx``/``d_group`` the same for the data
    axis (1, 0, None without one).
    """

    def __init__(self, mesh: DeviceMesh, axis_name: str, data_axis_name: str | None):
        self.t = axis_size(mesh, axis_name)
        if mesh.get_coordinate() is None:
            raise ValueError("this rank is not in the mesh")
        self.idx = mesh.get_local_rank(axis_name)
        self.group = mesh.get_group(axis_name)
        if data_axis_name is None:
            self.d, self.d_idx, self.d_group = 1, 0, None
        else:
            self.d = axis_size(mesh, data_axis_name)
            self.d_idx = mesh.get_local_rank(data_axis_name)
            self.d_group = mesh.get_group(data_axis_name)
        self.prev = (self.idx - 1) % self.t
        self.next = (self.idx + 1) % self.t

    def gather(self, a: torch.Tensor, group=None, size: int | None = None) -> torch.Tensor:
        """Every rank's ``a`` on a new leading axis ``(size, *a.shape)``, in
        axis order (the tile group by default)."""
        if group is None:
            group, size = self.group, self.t
        out = a.new_empty((size * a.shape[0], *a.shape[1:]))
        all_gather_cat(out, a.contiguous(), group=group)
        return out.view(size, *a.shape)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send[j]`` goes to tile rank j; returns ``recv`` with ``recv[i]``
        from tile rank i.  Complex tensors travel as their real pairs."""
        recv = torch.empty_like(send)
        dist.all_to_all_single(
            torch.view_as_real(recv) if recv.is_complex() else recv,
            torch.view_as_real(send) if send.is_complex() else send,
            group=self.group,
        )
        return recv

    # -- the stencils across the tile ring ---------------------------------

    def roll_p1_h(self, x):
        """Global circular roll(+1) along the split H axis (row i-1)."""
        above = self.gather(x[:, -1:])[self.prev]
        return torch.cat([above, x[:, :-1]], dim=1)

    def roll_m1_h(self, x):
        """Global circular roll(-1) along the split H axis (row i+1)."""
        below = self.gather(x[:, :1])[self.next]
        return torch.cat([x[:, 1:], below], dim=1)

    def grad2d(self, x):
        return x - torch.roll(x, 1, dims=-1), x - self.roll_p1_h(x)

    def grad2d_adjoint(self, zx, zy):
        return (zx - torch.roll(zx, -1, dims=-1)) + (zy - self.roll_m1_h(zy))

    def halo_exchange(self, x, ux, uy):
        """Kernel Q2-4's neighbour rows: the previous tile's last x row and
        the next tile's first (x, ux, uy) rows, as views into one fp32
        ``(N, 4, W)`` slab per rank that rides one all-gather (bf16 duals
        widen exactly)."""
        slab = torch.stack([x[:, -1], x[:, 0], ux[:, 0].float(), uy[:, 0].float()], dim=1)
        rows = self.gather(slab)
        prev, nxt = rows[self.prev], rows[self.next]
        return prev[:, 0:1], nxt[:, 1:2], nxt[:, 2:3], nxt[:, 3:4]

    # -- the distributed transform -----------------------------------------

    def rfft2(self, q, wp):
        """H-tiled ``(N, Ht, W)`` real -> column-split ``(N, H, Wp/T)`` complex."""
        q = q.to(torch.float32)  # cuFFT and pocketfft take no bf16
        qf = torch.fft.rfft(q, dim=-1)
        if wp != qf.shape[-1]:
            qf = F.pad(qf, (0, wp - qf.shape[-1]))
        n, ht, _ = qf.shape
        # Re-shard: column group j goes to tile rank j, H rows come back in
        # rank order.  all_to_all_single splits dim 0 only, so the groups
        # move to the front first.
        send = qf.unflatten(-1, (self.t, wp // self.t)).permute(2, 0, 1, 3).contiguous()
        cols = self.all_to_all(send).permute(1, 0, 2, 3).reshape(n, self.t * ht, -1)
        return torch.fft.fft(cols, dim=-2)

    def irfft2(self, xhat_cols, w, wf):
        """Inverse of :meth:`rfft2`: back to H-tiled real ``(N, Ht, W)``."""
        cols = torch.fft.ifft(xhat_cols, dim=-2)
        n, h, per = cols.shape
        send = cols.unflatten(1, (self.t, h // self.t)).permute(1, 0, 2, 3).contiguous()
        qf = self.all_to_all(send).permute(1, 2, 0, 3).reshape(n, h // self.t, self.t * per)
        # The padded columns may hold inf/NaN (1/0 of the padded spectra):
        # they go before the W transform.
        return torch.fft.irfft(qf[..., :wf], n=w, dim=-1)

    def col_slice(self, arr, wp):
        """This rank's group of frequency columns of a full-width array,
        the tail columns zero-padded."""
        arr = F.pad(arr, (0, wp - arr.shape[-1]))
        per = wp // self.t
        return arr[..., self.idx * per:(self.idx + 1) * per]

    # -- whole planes back on every rank -----------------------------------

    def gather_planes(self, a):
        """Local ``(Nl, Ht, W)`` -> global ``(N, H, W)`` on every rank."""
        nl, ht, w = a.shape
        full = self.gather(a).permute(1, 0, 2, 3).reshape(nl, self.t * ht, w)
        return self.gather_images(full)

    def gather_images(self, a):
        """Per-image values of this data shard -> all images, every rank."""
        if self.d_group is None:
            return a
        return self.gather(a, self.d_group, self.d).flatten(0, 1)


def _x_update(tiles, y_tile, psf, h, w, wp, x_bounds):
    """The tile's precompute (column-split cached spectra ``B`` and the
    denominator terms) and the distributed closed-form x-update: returns
    ``(c_of, x_from_q)`` with ``c_of(rho, rho2)`` the column-split
    ``1/(|Sigma|^2 + rho |Lambda|^2 + rho2)`` and ``x_from_q(q, rho, c)``
    the image from the spatial rhs term ``q`` (clipped to ``x_bounds``)."""
    dtype, device = y_tile.dtype, y_tile.device
    wf = w // 2 + 1
    lap_cols = tiles.col_slice(laplacian_spectrum((h, w), dtype=dtype, device=device), wp)
    y_hat = tiles.rfft2(y_tile, wp)
    if psf is None:
        denom_h = torch.ones((), dtype=dtype, device=device)
        b_cols = y_hat
    else:
        otf_cols = tiles.col_slice(psf_to_otf(psf, (h, w)), wp)
        denom_h = torch.abs(otf_cols) ** 2
        b_cols = torch.conj(otf_cols) * y_hat

    def c_of(rho, rho2=0.0):
        return 1.0 / (denom_h + rho * lap_cols + rho2)

    def x_from_q(q, rho, c_cols):
        x = tiles.irfft2(c_cols * (b_cols + rho * tiles.rfft2(q, wp)), w, wf)
        if x_bounds is not None:
            x = torch.clamp(x, x_bounds[0], x_bounds[1])
        return x

    return c_of, x_from_q


def _tiled_solve(tiles, y_tile, psf, lam, rho, state0, h, w, iters, prox, x_bounds,
                 adapt_rho, early_stop, eps_abs, eps_rel, alpha, mode, fast, check_every,
                 fast_mid, sdt):
    """The per-tile loops.  Returns the local ``x`` on the fast path, else
    ``(x, r_norm, s_norm, iterations, rho, state)`` with local planes."""
    wp = -(-(w // 2 + 1) // tiles.t) * tiles.t  # frequency columns, padded to T
    c_of, x_from_q = _x_update(tiles, y_tile, psf, h, w, wp, x_bounds)
    nl = y_tile.shape[0]
    lam_l, rho_l = lam[:, None, None], rho[:, None, None]
    narrow = sdt is not None and sdt != y_tile.dtype

    if fast:
        # The q-carry loop: (q, ux, uy) carried, the stencil section one
        # kernel pass per iteration on the tile and its halo rows.
        c_cols, tau_vec = c_of(rho_l), lam / rho
        q = tiles.grad2d_adjoint(state0.zx - state0.ux, state0.zy - state0.uy)
        ux, uy = state0.ux, state0.uy
        if narrow:
            q, ux, uy = q.to(sdt), ux.to(sdt), uy.to(sdt)
        for _ in range(iters - 1):
            x = x_from_q(q, rho_l, c_cols)
            q, ux, uy = fused_admm_stencil_halo(
                x, ux, uy, *tiles.halo_exchange(x, ux, uy), tau_vec, mode=mode
            )
        return x_from_q(q, rho_l, c_cols)

    # The full-state iterations keep the plain prox composition, as the JAX
    # tiled solver does.
    prox_step = _make_prox_step(prox, "xla")
    sqrt_dim = torch.sqrt(torch.tensor(2.0 * h * w, dtype=y_tile.dtype, device=y_tile.device))

    def one_iter(state, rho_c, c_cols):
        q = tiles.grad2d_adjoint(state.zx - state.ux, state.zy - state.uy)
        x = x_from_q(q, rho_c, c_cols)
        dxx, dxy = tiles.grad2d(x)
        if alpha != 1.0:
            # Over-relaxation (Boyd sec. 3.4.3): blend D x with the previous z.
            rxx = alpha * dxx + (1.0 - alpha) * state.zx
            rxy = alpha * dxy + (1.0 - alpha) * state.zy
        else:
            rxx, rxy = dxx, dxy
        zx, zy, ux, uy = prox_step(rxx, rxy, state.ux, state.uy, lam_l / rho_c)
        return ADMMState(x, zx, zy, ux, uy), dxx, dxy

    def residuals(state, zpx, zpy, dxx, dxy, rho_c):
        """Per-image primal/dual residual and feasibility norms: the five
        sums ride one all-reduce over the tile group."""
        _, zx, zy, ux, uy = state
        dz = tiles.grad2d_adjoint(zx - zpx, zy - zpy)
        dual = tiles.grad2d_adjoint(ux, uy)
        sums = torch.stack([
            torch.sum((dxx - zx) ** 2 + (dxy - zy) ** 2, dim=(-2, -1)),
            torch.sum(dz * dz, dim=(-2, -1)),
            torch.sum(dxx * dxx + dxy * dxy, dim=(-2, -1)),
            torch.sum(zx * zx + zy * zy, dim=(-2, -1)),
            torch.sum(dual * dual, dim=(-2, -1)),
        ])  # (5, Nl)
        dist.all_reduce(sums, group=tiles.group)
        rho_v = rho_c[:, 0, 0]
        r_norm = torch.sqrt(sums[0])
        s_norm = rho_v * torch.sqrt(sums[1])
        eps_pri = sqrt_dim * eps_abs + eps_rel * torch.maximum(torch.sqrt(sums[2]),
                                                               torch.sqrt(sums[3]))
        eps_dual = sqrt_dim * eps_abs + eps_rel * rho_v * torch.sqrt(sums[4])
        return r_norm, s_norm, (r_norm <= eps_pri) & (s_norm <= eps_dual)

    state = state0
    if not early_stop and not adapt_rho:
        # Fixed iterations, residuals once at the end.
        c_cols = c_of(rho_l)
        for _ in range(iters - 1):
            state = one_iter(state, rho_l, c_cols)[0]
        zpx, zpy = state.zx, state.zy
        state, dxx, dxy = one_iter(state, rho_l, c_cols)
        r_norm, s_norm, _ = residuals(state, zpx, zpy, dxx, dxy, rho_l)
        return state.x, r_norm, s_norm, iters, rho, state

    def unfinished(done):
        """Images not done, over the data group too: every rank reads the
        same count, so all take the same trips (a collective in the body
        would hang otherwise)."""
        count = torch.sum(~done)
        if tiles.d_group is not None:
            dist.all_reduce(count, group=tiles.d_group)
        return int(count)

    rho_c = rho_l.clone()
    done = torch.zeros(nl, dtype=torch.bool, device=y_tile.device)
    it = 0
    while it < iters and unfinished(done) > 0:
        c_cols = c_of(rho_c)
        if fast_mid:
            # check_every - 2 q-carry iterations through the kernel (rho is
            # fixed inside a block), then the check iteration's first half.
            tau_vec = (lam_l / rho_c)[:, 0, 0]
            q = tiles.grad2d_adjoint(state.zx - state.ux, state.zy - state.uy)
            ux, uy = state.ux, state.uy
            if narrow:
                q, ux, uy = q.to(sdt), ux.to(sdt), uy.to(sdt)
            for _ in range(check_every - 2):
                x = x_from_q(q, rho_c, c_cols)
                q, ux, uy = fused_admm_stencil_halo(
                    x, ux, uy, *tiles.halo_exchange(x, ux, uy), tau_vec, mode=mode
                )
            x = x_from_q(q, rho_c, c_cols)
            dxx, dxy = tiles.grad2d(x)
            ux, uy = ux.to(y_tile.dtype), uy.to(y_tile.dtype)
            state = ADMMState(x, *prox_step(dxx, dxy, ux, uy, lam_l / rho_c))
        else:
            for _ in range(check_every - 1):
                state = one_iter(state, rho_c, c_cols)[0]
        zpx, zpy = state.zx, state.zy
        state, dxx, dxy = one_iter(state, rho_c, c_cols)
        r_norm, s_norm, done = residuals(state, zpx, zpy, dxx, dxy, rho_c)
        if not early_stop:
            done = torch.zeros_like(done)
        if adapt_rho:
            grow = r_norm > _MU * s_norm
            shrink = s_norm > _MU * r_norm
            factor = torch.where(grow, _TAU_SCALE, torch.where(shrink, 1.0 / _TAU_SCALE, 1.0))
            factor = torch.where(done, 1.0, factor).to(rho_c.dtype)[:, None, None]
            rho_c = rho_c * factor
            # Rescaling rho rescales the scaled dual u = (1/rho) dual.
            state = state._replace(ux=state.ux / factor, uy=state.uy / factor)
        it += check_every
    return state.x, r_norm, s_norm, it, rho_c[:, 0, 0], state


def _setup(y, psf, mesh, axis_name, data_axis_name):
    """Common set-up: the mesh position, ``y`` on the mesh's device in
    ``(B,H,W,C)``, its planes ``(N, H, W)``, the PSF, and the checks."""
    tiles = _Tiles(mesh, axis_name, data_axis_name)
    if isinstance(y, torch.Tensor):
        if y.device.type != mesh.device_type:
            raise ValueError(
                f"y lies on {y.device.type} and the mesh on {mesh.device_type}: "
                f"move y to the mesh's device"
            )
    else:
        # A numpy array goes to this rank's device of the mesh, as float32.
        device = torch.device("cuda", torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
        y = as_tensor(y, device)
    y4, orig_shape = _normalize_input(y)
    b, h, w, c = y4.shape
    if h % tiles.t != 0:
        raise ValueError(f"H={h} must divide by tile axis size {tiles.t}")
    if w % 2 != 0:
        raise ValueError(f"W={w} must be even")
    n = b * c
    if n % tiles.d != 0:
        raise ValueError(f"batch*channels={n} must divide by data axis size {tiles.d}")
    y_f = _fold(y4)
    if psf is not None:
        psf = torch.as_tensor(psf, dtype=y_f.dtype, device=y_f.device)
    return tiles, y_f, psf, orig_shape, (b, h, w, c)


def _local(tiles, a, ht):
    """This rank's tile of global ``(N, H, W)`` planes."""
    nl = a.shape[0] // tiles.d
    return a[tiles.d_idx * nl:(tiles.d_idx + 1) * nl,
             tiles.idx * ht:(tiles.idx + 1) * ht].contiguous()


def _image_param(tiles, p, b, c, like):
    """A scalar / ``(B,)`` / ``(B, C)`` parameter as this data shard's
    per-plane ``(Nl,)`` vector."""
    n = b * c
    nl = n // tiles.d
    full = _fold_param(p, b, c, like.dtype, like.device).reshape(-1).expand(n)
    return full[tiles.d_idx * nl:(tiles.d_idx + 1) * nl]


def _check_fft_mode(fft_mode, prox_impl):
    prox_impl = _check_modes(fft_mode, prox_impl)
    fft_mode = "xla" if fft_mode == "auto" else fft_mode
    if fft_mode not in _TILED_FFT_MODES:
        raise ValueError(
            f"tiled solver fft_mode must be xla/fold/fold1/fold_precise, got {fft_mode!r}"
        )
    return fft_mode, prox_impl


@_inference_only
def tiled_tv_deconvolve(
    y,
    psf=None,
    lam=0.1,
    rho=1.0,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    adapt_rho: bool = False,
    early_stop: bool = False,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    check_every: int = 1,
    mesh: DeviceMesh | None = None,
    axis_name: str = "tile",
    data_axis_name: str | None = None,
    fft_mode: str = "auto",
    prox_impl: str = "auto",
    alpha: float = 1.0,
    init_state: ADMMState | None = None,
    return_diagnostics: bool = False,
    return_state: bool = False,
    state_dtype: str | torch.dtype | None = None,
):
    """ADMM TV deconvolution with each image's H axis split over ``mesh``.

    Every rank of the mesh calls it with the same arguments.

    Args:
      y: global NHWC batch ``(B, H, W, C)`` (or ``(H, W)`` / ``(H, W, C)``),
        float32, on the mesh's device type (a numpy array goes to it).  ``H``
        must divide by the tile-axis size; ``W`` must be even.
      psf, lam, rho, iters, prox, x_bounds, alpha: as
        :func:`~admm_deconv_tpu_torch.ops.solver.tv_deconvolve`; ``lam`` and
        ``rho`` scalar, per-image ``(B,)`` or per-channel ``(B, C)``.
      adapt_rho: per-image residual-balanced rho, shared by the tiles.
      early_stop: stop on the per-image residuals (``iters`` becomes the
        most), read on the host once per check block.
      check_every: with ``early_stop``/``adapt_rho``, residuals, stopping and
        adaptation every k-th iteration (``iters`` must divide evenly); with
        a kernel request the ``k - 2`` mid-block iterations run the q-carry
        loop through kernel Q2-4.
      mesh: a mesh from :func:`~admm_deconv_tpu_torch.parallel.make_mesh`
        holding ``axis_name`` (and ``data_axis_name``); required.
      data_axis_name: a second axis splitting the ``B*C`` planes.
      fft_mode: "auto", "xla", "fold", "fold1" or "fold_precise"; all
        compute the exact ``torch.fft`` path.  "fold1" with ``adapt_rho``
        raises, as in JAX.
      prox_impl: "pallas" (and "auto") take kernel Q2-4 for a named prox:
        the q-carry fast loop when no diagnostics, state, stopping or
        adaptation is asked for and ``alpha=1``, else the fast mid-loop of
        ``check_every > 1`` blocks; "xla" the plain composition throughout.
      init_state: global warm-start :class:`ADMMState` ``(B*C, H, W)``.
      return_diagnostics / return_state: per-image diagnostics, the final
        global state.
      state_dtype: bf16 storage of the fast loops' ``(q, ux, uy)``; needs
        the fast loop or the fast mid-loop.

    Returns the whole ``x`` (input shape) on every rank, followed by
    diagnostics and/or state when asked.
    """
    fft_mode, prox_impl = _check_fft_mode(fft_mode, prox_impl)
    if fft_mode == "fold1" and adapt_rho:
        raise ValueError(
            "tiled fft_mode='fold1' hoists x_B out of the loop, which requires rho "
            "fixed for the whole tiled solve; use 'fold' with adapt_rho (or the "
            "single-chip tv_deconvolve_adaptive, which supports fold1 explicitly)"
        )
    if mesh is None:
        raise ValueError("tiled_tv_deconvolve requires a mesh")
    tiles, y_f, psf, orig_shape, (b, h, w, c) = _setup(y, psf, mesh, axis_name, data_axis_name)
    if iters < 1:
        raise ValueError("iters must be >= 1")
    dtype, device = y_f.dtype, y_f.device
    nl, ht = b * c // tiles.d, h // tiles.t
    if init_state is None:
        zeros = torch.zeros((nl, ht, w), dtype=dtype, device=device)
        state0 = ADMMState(zeros, zeros, zeros, zeros, zeros)
    else:
        state0 = ADMMState(*(_local(tiles, a, ht) for a in init_state))

    mode = _kernel_mode(prox, prox_impl)
    fast = (mode is not None and not early_stop and not adapt_rho and not return_diagnostics
            and not return_state and alpha == 1.0)
    uses_while = early_stop or adapt_rho
    if check_every < 1 or (uses_while and (iters < check_every or iters % check_every != 0)):
        raise ValueError(
            f"check_every ({check_every}) must be >= 1 and divide "
            f"iters ({iters}), with iters >= check_every"
        )
    fast_mid = uses_while and check_every > 1 and alpha == 1.0 and mode is not None
    sdt = _as_dtype(state_dtype)
    if sdt is not None and sdt != dtype and not (fast or fast_mid):
        raise ValueError(
            "state_dtype requires the fast q-carry path (fixed iterations) "
            "or the check_every fast mid-loop (early_stop/adapt_rho with "
            "check_every > 1), with prox_impl='pallas' and a named prox"
        )
    result = _tiled_solve(
        tiles, _local(tiles, y_f, ht), psf, _image_param(tiles, lam, b, c, y_f),
        _image_param(tiles, rho, b, c, y_f), state0, h, w, iters, prox, x_bounds, adapt_rho,
        early_stop, eps_abs, eps_rel, alpha, mode, fast, check_every, fast_mid, sdt,
    )
    if fast:
        return _unfold(tiles.gather_planes(result), b, c).reshape(orig_shape)
    x, r_norm, s_norm, iterations, rho_fin, state = result
    out = (_unfold(tiles.gather_planes(x), b, c).reshape(orig_shape),)
    if return_diagnostics:
        out += (ADMMDiagnostics(
            r_norm=tiles.gather_images(r_norm),
            s_norm=tiles.gather_images(s_norm),
            iterations=torch.tensor(iterations, device=device),
            rho=tiles.gather_images(rho_fin),
        ),)
    if return_state:
        out += (ADMMState(*(tiles.gather_planes(a) for a in state)),)
    return out if len(out) > 1 else out[0]


@_inference_only
def tiled_composite_tv_deconvolve(
    y,
    psf=None,
    lam_tv=0.01,
    lam_l1=0.0,
    rho1=0.1,
    rho2=0.1,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    mesh: DeviceMesh | None = None,
    axis_name: str = "tile",
    data_axis_name: str | None = None,
    fft_mode: str = "auto",
    prox_impl: str = "auto",
):
    """Composite-prior (TV + L1 + box) ADMM with the H axis tile-split.

    The distributed twin of
    :func:`~admm_deconv_tpu_torch.ops.composite.composite_tv_deconvolve` in
    q-carry form: the TV split runs kernel Q2-4 (``prox_impl`` "pallas" or
    "auto" with a named prox) or the plain tiled stencils, the identity split
    ``clip(soft(x + u2))`` is elementwise and needs no halo, and the
    x-update's denominator carries ``rho2``.  Same arguments and calling
    contract as :func:`tiled_tv_deconvolve`; the penalties are fixed.

    Returns the feasible ``z2`` iterate (input shape) on every rank.
    """
    fft_mode, prox_impl = _check_fft_mode(fft_mode, prox_impl)
    if mesh is None:
        raise ValueError("tiled_composite_tv_deconvolve requires a mesh")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    tiles, y_f, psf, orig_shape, (b, h, w, c) = _setup(y, psf, mesh, axis_name, data_axis_name)
    nl, ht = b * c // tiles.d, h // tiles.t
    lam_tv, lam_l1, rho1, rho2 = (_image_param(tiles, p, b, c, y_f)
                                  for p in (lam_tv, lam_l1, rho1, rho2))
    rho1_l, rho2_l = rho1[:, None, None], rho2[:, None, None]
    tau_tv, tau_l1 = (lam_tv / rho1)[:, None, None], (lam_l1 / rho2)[:, None, None]
    ratio = rho2_l / rho1_l
    wp = -(-(w // 2 + 1) // tiles.t) * tiles.t
    # The box rides the z2 prox (exact), not the x-update.
    c_of, x_from_q = _x_update(tiles, _local(tiles, y_f, ht), psf, h, w, wp, None)
    c_cols = c_of(rho1_l, rho2_l)

    mode = _kernel_mode(prox, prox_impl)
    if mode is not None:
        tau_vec = lam_tv / rho1

        def tv_section(x, u1x, u1y):
            return fused_admm_stencil_halo(
                x, u1x, u1y, *tiles.halo_exchange(x, u1x, u1y), tau_vec, mode=mode
            )
    else:
        prox_fn = prox_lib.resolve(prox)

        def tv_section(x, u1x, u1y):
            dxx, dxy = tiles.grad2d(x)
            z1x, z1y, u1x, u1y = prox_lib.prox_dual_step(dxx, dxy, u1x, u1y, tau_tv, prox_fn)
            return tiles.grad2d_adjoint(z1x - u1x, z1y - u1y), u1x, u1y

    q = u1x = u1y = u2 = torch.zeros((nl, ht, w), dtype=y_f.dtype, device=y_f.device)
    for _ in range(iters - 1):
        x = x_from_q(q, rho1_l, c_cols)
        q_tv, u1x, u1y = tv_section(x, u1x, u1y)
        v2 = x + u2
        z2 = _l1_box(v2, tau_l1, x_bounds)
        u2 = v2 - z2
        q = q_tv + ratio * (z2 - u2)
    x = x_from_q(q, rho1_l, c_cols)
    z2 = _l1_box(x + u2, tau_l1, x_bounds)
    return _unfold(tiles.gather_planes(z2), b, c).reshape(orig_shape)


@torch.no_grad()
def _tiled_anderson_solve(tiles, y_tile, psf, lam, rho, h, w, iters, prox, x_bounds, m, aa_reg,
                          safeguard_factor, early_stop, eps_abs, eps_rel, aa_interval, mode):
    """The per-tile Anderson loop: returns the local ``x``, the per-image
    ``r_norm`` and fixed-point residual, and the iterations run."""
    wp = -(-(w // 2 + 1) // tiles.t) * tiles.t
    c_of, x_from_q = _x_update(tiles, y_tile, psf, h, w, wp, x_bounds)
    nl, ht = y_tile.shape[:2]
    dtype, device = y_tile.dtype, y_tile.device
    lam_l, rho_l = lam[:, None, None], rho[:, None, None]
    tau, tau_vec = lam_l / rho_l, lam / rho
    c_cols = c_of(rho_l)
    # The full-state steps keep the plain prox composition, as the JAX tiled
    # solver does; the kernel serves the leading steps of a block.
    prox_step = _make_prox_step(prox, "xla")
    use_fast_inner = aa_interval > 2 and mode is not None
    d_loc = 4 * ht * w  # per-image LOCAL state size: the history is tile-split

    def one_step(zx, zy, ux, uy):
        x = x_from_q(tiles.grad2d_adjoint(zx - ux, zy - uy), rho_l, c_cols)
        dxx, dxy = tiles.grad2d(x)
        return (*prox_step(dxx, dxy, ux, uy, tau), dxx, dxy)

    def g_map(s):
        """``G = T^aa_interval`` on the tile: ``(G(s), this tile's share of
        r_norm^2, the z pair before the last step)``."""
        zx, zy, ux, uy = s.unbind(1)
        if use_fast_inner:
            q = tiles.grad2d_adjoint(zx - ux, zy - uy)
            for _ in range(aa_interval - 2):
                x = x_from_q(q, rho_l, c_cols)
                q, ux, uy = fused_admm_stencil_halo(
                    x, ux, uy, *tiles.halo_exchange(x, ux, uy), tau_vec, mode=mode
                )
            dxx, dxy = tiles.grad2d(x_from_q(q, rho_l, c_cols))
            zx, zy, ux, uy = prox_step(dxx, dxy, ux, uy, tau)
        else:
            for _ in range(aa_interval - 1):
                zx, zy, ux, uy = one_step(zx, zy, ux, uy)[:4]
        zpx, zpy = zx, zy
        zx, zy, ux, uy, dxx, dxy = one_step(zx, zy, ux, uy)
        r2 = torch.sum((dxx - zx) ** 2 + (dxy - zy) ** 2, dim=(-2, -1))
        return torch.stack([zx, zy, ux, uy], dim=1), r2, zpx, zpy

    def tile_sum(a):
        dist.all_reduce(a, group=tiles.group)

    mixer = _AndersonMixer(nl, d_loc, m, aa_reg, safeguard_factor, dtype, device,
                           reduce=tile_sum, chunks=ht)
    s = torch.zeros((nl, 4, ht, w), dtype=dtype, device=device)
    sqrt_dim = torch.sqrt(torch.tensor(2.0 * h * w, dtype=dtype, device=device))
    outer_cap = (iters - 1) // aa_interval
    k = 0
    while k < outer_cap:
        with trace_annotation("admm/aa_map"):
            t, r2, zpx, zpy = g_map(s)
        s_next, fp_res = mixer.mix(k, s.reshape(nl, d_loc), t.reshape(nl, d_loc))
        s = s_next.reshape(nl, 4, ht, w)
        k += 1
        if early_stop:
            # The four residual sums ride one all-reduce over the tile
            # group; the unfinished count one over the data group.
            tzx, tzy, tux, tuy = t.unbind(1)
            dz = tiles.grad2d_adjoint(tzx - zpx, tzy - zpy)
            dual = tiles.grad2d_adjoint(tux, tuy)
            sums = torch.stack([
                r2,
                torch.sum(dz * dz, dim=(-2, -1)),
                torch.sum(tzx ** 2 + tzy ** 2, dim=(-2, -1)),
                torch.sum(dual * dual, dim=(-2, -1)),
            ])
            tile_sum(sums)
            r_norm = torch.sqrt(sums[0])
            s_norm = rho * torch.sqrt(sums[1])
            eps_pri = sqrt_dim * eps_abs + eps_rel * torch.sqrt(sums[2])
            eps_dual = sqrt_dim * eps_abs + eps_rel * rho * torch.sqrt(sums[3])
            count = torch.sum(~((r_norm <= eps_pri) & (s_norm <= eps_dual)))
            if tiles.d_group is not None:
                dist.all_reduce(count, group=tiles.d_group)
            if int(count) == 0:  # the loop's one host read
                break
    if not early_stop:
        # Nothing in the loop reads r_norm: its sum is reduced once, here.
        tile_sum(r2)
        r_norm = torch.sqrt(r2)
    zx, zy, ux, uy = s.unbind(1)
    x = x_from_q(tiles.grad2d_adjoint(zx - ux, zy - uy), rho_l, c_cols)
    return x, r_norm, fp_res, k * aa_interval + 1 if early_stop else iters


def tiled_tv_deconvolve_anderson(
    y,
    psf=None,
    lam=0.1,
    rho=1.0,
    iters: int = 100,
    prox: str | Callable = "aniso",
    x_bounds: tuple[float, float] | None = None,
    m: int = 5,
    aa_reg: float = 1e-10,
    safeguard_factor: float = 1e6,
    early_stop: bool = False,
    eps_abs: float = 1e-4,
    eps_rel: float = 1e-3,
    aa_interval: int = 1,
    mesh: DeviceMesh | None = None,
    axis_name: str = "tile",
    data_axis_name: str | None = None,
    fft_mode: str = "auto",
    prox_impl: str = "auto",
):
    """Anderson-accelerated ADMM with each image's H axis split over ``mesh``.

    The distributed twin of
    :func:`~admm_deconv_tpu_torch.ops.solver.tv_deconvolve_anderson` (the
    same windowed type-II extrapolation, per-image mixing and decay
    safeguard): the fixed-point state, both ``(m, N, 4*Ht*W)`` difference
    rings and the snapshots live tile-local, which divides Anderson's
    dominant memory cost by the tile count, while the per-image Gram row,
    rhs and squared residual are summed over the tile group in one
    all-reduce per outer step, so every tile applies the same mixing
    coefficients and takes the same safeguard decision.

    Same arguments and calling contract as :func:`tiled_tv_deconvolve`;
    ``rho`` is fixed for the whole solve.  ``aa_interval=k > 1``
    extrapolates ``G = T^k``; with ``prox_impl`` "pallas"/"auto", a named
    prox and ``k > 2`` the leading ``k - 2`` steps of each block run the
    q-carry loop through kernel Q2-4.  The full-state steps use the plain
    prox composition.  Under ``early_stop`` the count of unfinished images
    is summed over the data group and read on the host once per outer step.

    Returns the whole ``x`` (input shape) and ``ADMMDiagnostics``
    (``s_norm`` = the fixed-point residual) on every rank.
    """
    fft_mode, prox_impl = _check_fft_mode(fft_mode, prox_impl)
    if mesh is None:
        raise ValueError("tiled_tv_deconvolve_anderson requires a mesh")
    _check_anderson_args("tiled_tv_deconvolve_anderson", m, iters, aa_interval)
    _refuse_grad("tiled_tv_deconvolve_anderson", y, psf, lam, rho)
    tiles, y_f, psf, orig_shape, (b, h, w, c) = _setup(y, psf, mesh, axis_name, data_axis_name)
    lam_v, rho_v = (_image_param(tiles, p, b, c, y_f) for p in (lam, rho))
    x, r_norm, fp_res, iterations = _tiled_anderson_solve(
        tiles, _local(tiles, y_f, h // tiles.t), psf, lam_v, rho_v, h, w, iters, prox,
        x_bounds, m, aa_reg, safeguard_factor, early_stop, eps_abs, eps_rel, aa_interval,
        _kernel_mode(prox, prox_impl),
    )
    diags = ADMMDiagnostics(
        r_norm=tiles.gather_images(r_norm),
        s_norm=tiles.gather_images(fp_res),
        iterations=torch.tensor(iterations, device=y_f.device),
        rho=tiles.gather_images(rho_v),
    )
    return _unfold(tiles.gather_planes(x), b, c).reshape(orig_shape), diags
