"""Model zoo: the reference's restoration networks.

Counterpart of ``admm_deconv_tpu/models/zoo.py``, with the same structure,
channel bookkeeping and child names as its flax modules (so a flax
parameter tree loads by name, ``utils/params_io.py``).  flax infers each
layer's input channels from the first call; here they are worked out at
construction from ``in_features``, the input's channel count (3, RGB).

* :class:`Autoencoder` — 6 down blocks (23x23..9x9 kernels) and the nested
  up/down residual recursion; 160 output channels.
* :class:`DenoiserBank` — 5 kernel-less ADMM TV denoisers at fixed rho in
  {0.002, 0.02, 0.2, 2, 4}, trainable lam, relu1, channel-concat.
* :class:`AdmmDenoiser` — the flagship: Parallel(autoencoder, denoiser
  bank) -> up/down head -> skip -> up/down head -> relu1.
* :class:`MultistageUpDownscale` and :class:`DeconvBank` — the two other
  assemblies, with the JAX package's fixes of the reference's bugs.
"""

from __future__ import annotations

import torch
from torch import nn

from admm_deconv_tpu_torch.layers.deconv import (
    _RHO_FLOOR,
    ADMMDeconv,
    ADMMDeconvF2,
    ADMMDeconvF3,
    _floor,
    _glorot_scalar_,
)
from admm_deconv_tpu_torch.models.blocks import (
    Chain,
    DownBlock,
    Parallel,
    SkipConnection,
    UpBlock,
    UpDownBlock,
    UpDownResidualBlock,
    chcat,
    relu1,
    relu6,
)
from admm_deconv_tpu_torch.ops.solver import tv_deconvolve


def _relu(x: torch.Tensor) -> torch.Tensor:
    return _floor(x, 0.0)


class Autoencoder(nn.Module):
    """Nested up/down residual conv autoencoder.

    Kernels 23/21/17/15/11/9, features in->16->16->32->32->64->64 down;
    each level wraps the deeper levels in an :class:`UpDownResidualBlock`,
    so the output concatenates the last up branch (128 features) with a
    32-feature residual: 160 channels.
    """

    KERS = [(23, 23), (21, 21), (17, 17), (15, 15), (11, 11), (9, 9)]
    UP_FEATS = [16, 64, 64, 64, 64, 128]
    POOL_DOWN = [(3, 3), (3, 3), (3, 3), (5, 5), (5, 5), (7, 7)]
    POOL_UP = [(3, 3), (3, 3), (3, 3), (5, 5), (7, 7), (3, 3)]
    # Residual-branch kernels per level, innermost first; 32 features each.
    RES_KERS = [(3, 3), (5, 5), (9, 9), (7, 7), (5, 5), (3, 3)]

    def __init__(self, in_features: int = 3):
        super().__init__()
        down_feats = [(in_features, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64)]
        down = [
            DownBlock(self.KERS[i], down_feats[i][1], self.POOL_DOWN[i],
                      in_features=down_feats[i][0])
            for i in range(6)
        ]
        # Up block i follows the level-(i-1) residual block (or, innermost,
        # the last down block): 32 residual features beside the up branch.
        up_in = [down_feats[5][1]] + [f + 32 for f in self.UP_FEATS[:5]]
        up = [
            UpBlock(self.KERS[5 - i], self.UP_FEATS[i], self.POOL_UP[i], in_features=up_in[i])
            for i in range(6)
        ]
        for i, blk in enumerate(down):
            setattr(self, f"DownBlock_{i}", blk)
        for i, blk in enumerate(up):
            setattr(self, f"UpBlock_{i}", blk)

        # Innermost residual wraps [down_6, up_1]; each outer level wraps
        # [down_k, inner, up_j].
        block = None
        for lvl in range(6):
            inner = [down[5], up[0]] if block is None else [down[5 - lvl], block, up[lvl]]
            block = UpDownResidualBlock(
                inner, self.RES_KERS[lvl], self.RES_KERS[lvl], 32, 32,
                in_features=down_feats[5 - lvl][0], inner_features=self.UP_FEATS[lvl],
            )
            setattr(self, f"UpDownResidualBlock_{lvl}", block)
        self.out_features = block.out_features

    def forward(self, x):
        return self.UpDownResidualBlock_5(x)


class DenoiserBank(nn.Module):
    """Bank of 5 pure-TV ADMM denoisers at different fixed rho, channel-concat.

    ``fused=True`` (default) runs all 5 branches as one batched solve: the
    input is tiled 5x along the batch axis (branch-major) with per-image
    lam and rho, so one loop replaces five and every stencil launch covers
    all 5B images.  The same as the per-branch composition (each plane is
    an independent deconvolution).  Trainable lam (|glorot| init), fixed rho.
    """

    RHOS = (0.002, 0.02, 0.2, 2.0, 4.0)

    def __init__(self, iso: bool = True, iters: int = 50, fused: bool = True,
                 fft_mode: str = "auto", prox_impl: str = "auto",
                 state_dtype: str | None = None, in_features: int = 3):
        super().__init__()
        self.iso = iso
        self.iters = iters
        self.fused = fused
        self.fft_mode = fft_mode
        self.prox_impl = prox_impl
        self.state_dtype = state_dtype
        self.out_features = len(self.RHOS) * in_features
        if fused:
            self.lam = nn.Parameter(torch.empty(len(self.RHOS)))
            self.reset_parameters_from(None)
        else:
            for i, rho in enumerate(self.RHOS):
                setattr(self, f"ADMMDeconv_{i}", ADMMDeconvF2(
                    (), iters, rho, relu1, iso=iso, fft_mode=fft_mode,
                    prox_impl=prox_impl, state_dtype=state_dtype,
                ))

    def reset_parameters_from(self, generator: torch.Generator | None) -> None:
        if self.fused:
            _glorot_scalar_(self.lam, generator)

    def forward(self, x):
        n_br = len(self.RHOS)
        if not self.fused:
            return chcat(*[getattr(self, f"ADMMDeconv_{i}")(x) for i in range(n_br)])
        lam = _floor(self.lam, 0.0)
        rho = _floor(torch.tensor(self.RHOS, dtype=x.dtype, device=x.device), _RHO_FLOOR)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        b = x.shape[0]
        out = tv_deconvolve(
            torch.cat([x] * n_br, dim=0),  # branch-major (5B, H, W, C)
            psf=None,
            lam=lam.repeat_interleave(b),
            rho=rho.repeat_interleave(b),
            iters=self.iters,
            prox="iso" if self.iso else "aniso",
            fft_mode=self.fft_mode,
            prox_impl=self.prox_impl,
            state_dtype=self.state_dtype,
        )
        out = relu1(out)
        h, w, c = out.shape[1:]
        # (5B,H,W,C) -> (B,H,W,5C), branch-major channels: the concat of the
        # per-branch outputs.
        out = out.reshape(n_br, b, h, w, c).movedim(0, 3).reshape(b, h, w, n_br * c)
        return out[0] if squeeze else out


class AdmmDenoiser(nn.Module):
    """The flagship restoration model.

    Parallel(chcat, autoencoder[160ch], denoiser bank[15ch]) -> 175ch ->
    UpDownBlock(5x5, 175=>32=>32) -> skip-concat input (35ch) ->
    UpDownBlock(5x5, 35=>32=>3) -> relu1.
    """

    def __init__(self, iso: bool = True, denoiser_iters: int = 50, fft_mode: str = "auto",
                 prox_impl: str = "auto", state_dtype: str | None = None,
                 in_features: int = 3):
        super().__init__()
        self.Autoencoder_0 = Autoencoder(in_features)
        self.DenoiserBank_0 = DenoiserBank(
            iso=iso, iters=denoiser_iters, fft_mode=fft_mode, prox_impl=prox_impl,
            state_dtype=state_dtype, in_features=in_features,
        )
        mid = self.Autoencoder_0.out_features + self.DenoiserBank_0.out_features
        self.UpDownBlock_0 = UpDownBlock((5, 5), (5, 5), 32, 32, in_features=mid)
        self.UpDownBlock_1 = UpDownBlock((5, 5), (5, 5), 32, 3, in_features=32 + in_features)
        auto_denoise = Parallel((self.Autoencoder_0, self.DenoiserBank_0))
        self.net = Chain((
            SkipConnection(Chain((auto_denoise, self.UpDownBlock_0))),
            self.UpDownBlock_1,
            relu1,
        ))

    def forward(self, x):
        return self.net(x)


class MultistageUpDownscale(nn.Module):
    """ADMM front-end + multi-stage up/down conv refinement; each block uses
    matching kernels (size-preserving), the JAX package's fix of the
    reference's mismatched skip shapes."""

    def __init__(self, iso: bool = True, fft_mode: str = "auto", prox_impl: str = "auto",
                 in_features: int = 3):
        super().__init__()
        self.ADMMDeconv_0 = ADMMDeconv(
            kernel_shape=(10, 10), iters=50, activation=_relu, iso=iso,
            fft_mode=fft_mode, prox_impl=prox_impl,
        )
        ks = [(9, 9), (7, 7), (5, 5), (3, 3)]
        specs = [  # (kernel, up, down, in)
            (ks[0], 32, 32, in_features), (ks[1], 32, 64, 32), (ks[2], 64, 64, 64),
            (ks[3], 64, 64, 64), (ks[3], 64, 32, 64), (ks[3], 32, 32, 64),
        ]
        for i, (k, up, down, cin) in enumerate(specs):
            setattr(self, f"UpDownBlock_{i}", UpDownBlock(k, k, up, down, in_features=cin))
        ud = [getattr(self, f"UpDownBlock_{i}") for i in range(6)]
        skip_34 = SkipConnection(Chain((ud[2], ud[3])), merge=torch.add)
        skip_2345 = SkipConnection(Chain((ud[1], skip_34, ud[4])))
        self.net = Chain((self.ADMMDeconv_0, ud[0], skip_2345, ud[5]))

    def forward(self, x):
        return self.net(x)


class DeconvBank(nn.Module):
    """Three-scale learned deconvolution bank: three ADMMDeconvF3 layers in
    parallel, channel-concat."""

    def __init__(self, iso: bool = False, iters: int = 50, fft_mode: str = "auto",
                 prox_impl: str = "auto"):
        super().__init__()
        cfgs = [((7, 7), 0.004, 0.02, iso), ((10, 10), 0.04, 0.04, iso),
                ((15, 15), 0.4, 0.06, not iso)]
        for i, (k, lam, rho, branch_iso) in enumerate(cfgs):
            setattr(self, f"ADMMDeconv_{i}", ADMMDeconvF3(
                k, iters, lam, rho, relu6, iso=branch_iso, fft_mode=fft_mode,
                prox_impl=prox_impl,
            ))

    def forward(self, x):
        return chcat(*[getattr(self, f"ADMMDeconv_{i}")(x) for i in range(3)])


def build_model(name: str, cfg: dict | None = None) -> nn.Module:
    """Config-driven model factory (``use_iso``, ``fft_mode``, ``prox_impl``
    and ``state_dtype`` from a training config dict)."""
    cfg = cfg or {}
    iso = bool(cfg.get("use_iso", True))
    fft_mode = str(cfg.get("fft_mode", "auto"))
    prox_impl = str(cfg.get("prox_impl", "auto"))
    sdt = cfg.get("state_dtype")
    models = {
        "admm_denoiser": lambda: AdmmDenoiser(iso=iso, fft_mode=fft_mode,
                                              prox_impl=prox_impl, state_dtype=sdt),
        "autoencoder": lambda: Autoencoder(),
        "denoiser_bank": lambda: DenoiserBank(iso=iso, fft_mode=fft_mode,
                                              prox_impl=prox_impl, state_dtype=sdt),
        "multistage": lambda: MultistageUpDownscale(iso=iso, fft_mode=fft_mode,
                                                    prox_impl=prox_impl),
        "deconv_bank": lambda: DeconvBank(iso=not iso, fft_mode=fft_mode,
                                          prox_impl=prox_impl),
    }
    try:
        return models[name]()
    except KeyError:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(models)}") from None
