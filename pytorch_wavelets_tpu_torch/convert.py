"""Carry parameters across from the JAX package.

The DTCWT has no learned weights: its parameters are its filter taps.
:func:`filters_from_jax` turns a tap dict of the JAX package's
``dtcwt_fwd_filters()`` / ``dtcwt_inv_filters()`` (name -> tuple of floats,
correlation order) into the buffers of :class:`DTCWTForward` /
:class:`DTCWTInverse`, a state dict for ``load_state_dict``.  It takes
plain numbers and imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["filters_from_jax"]

_FWD = ("h0o", "h1o", "h0a", "h0b", "h1a", "h1b")
_INV = ("g0o", "g1o", "g0a", "g0b", "g1a", "g1b")


def filters_from_jax(d) -> dict:
    """JAX tap dict -> the port's filter buffers (float64, 1-D)."""
    names = _FWD if set(d) == set(_FWD) else _INV
    if set(d) != set(names):
        raise ValueError(f"expected the keys {_FWD} or {_INV}, got "
                         f"{sorted(d)}")
    return {k: torch.as_tensor(np.asarray(d[k], dtype=np.float64).ravel())
            for k in names}
