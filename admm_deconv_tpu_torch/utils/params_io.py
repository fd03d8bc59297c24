"""Parameters of the JAX package's flax models, carried into the port's modules.

The port's modules name their children as flax names its scopes
(``Autoencoder_0/DownBlock_0/Conv_0``), so a flax parameter tree maps onto a
module by name.  Only the layouts differ:

* ``Conv`` kernels are HWIO ``(kh, kw, in, out)``; ``nn.Conv2d`` takes OIHW.
* ``ConvTranspose`` kernels are ``(kh, kw, in, out)`` too, and flax's
  default ``transpose_kernel=False`` does not flip them: its VALID
  transposed convolution correlates the zero-padded input with the kernel
  as stored.  ``nn.ConvTranspose2d`` is the adjoint of a correlation, which
  correlates with the kernel flipped in both spatial axes.  So the kernel
  goes to ``(in, out, kh, kw)`` with both spatial axes flipped.
* Everything else (biases, ``lam``/``rho`` of shape ``(1,)`` or ``(5,)``,
  the ADMM layer's PSF ``weight`` ``(kh, kw, 1, 1)``) is stored in the
  port as flax stores it.

The tree holds numpy arrays (``jax.device_get`` of the flax params); this
module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def conv_kernel_from_flax(conv: nn.Module, kernel) -> torch.Tensor:
    """A flax ``(kh, kw, in, out)`` kernel in ``conv``'s weight layout."""
    k = torch.as_tensor(np.array(kernel))
    if isinstance(conv, nn.ConvTranspose2d):
        return k.permute(2, 3, 0, 1).flip(2, 3)
    if isinstance(conv, nn.Conv2d):
        return k.permute(3, 2, 0, 1)
    raise TypeError(f"not a convolution: {type(conv).__name__}")


def load_flax_params(module: nn.Module, params) -> nn.Module:
    """Copy a flax parameter tree (``{"params": {...}}`` or its inner dict,
    leaves as numpy arrays) into ``module``'s parameters, in place.

    Every leaf must land on a parameter of the same shape, and every
    parameter of ``module`` must be given; otherwise it raises.
    """
    if isinstance(params, Mapping) and set(params) == {"params"}:
        params = params["params"]
    loaded: set[int] = set()
    _load(module, params, "", loaded)
    missing = [n for n, p in module.named_parameters() if id(p) not in loaded]
    if missing:
        raise ValueError(f"no flax value for parameters {missing}")
    return module


def _load(module: nn.Module, tree: Mapping, path: str, loaded: set[int]) -> None:
    for key, value in tree.items():
        where = f"{path}/{key}" if path else key
        if isinstance(value, Mapping):
            child = module._modules.get(key)
            if child is None:
                raise ValueError(f"{type(module).__name__} has no submodule for {where}")
            _load(child, value, where, loaded)
            continue
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            name = {"kernel": "weight", "bias": "bias"}.get(key)
            src = (conv_kernel_from_flax(module, value) if key == "kernel"
                   else torch.as_tensor(np.array(value)))
        else:
            name, src = key, torch.as_tensor(np.array(value))
        param = module._parameters.get(name) if name else None
        if param is None:
            raise ValueError(f"{type(module).__name__} has no parameter for {where}")
        if tuple(param.shape) != tuple(src.shape):
            raise ValueError(
                f"{where}: flax shape {tuple(np.shape(value))} does not fit "
                f"parameter of shape {tuple(param.shape)}"
            )
        with torch.no_grad():
            param.copy_(src)
        loaded.add(id(param))
