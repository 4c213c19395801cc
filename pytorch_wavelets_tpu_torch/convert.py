"""Carry parameters across from the JAX package.

The DTCWT and the scattering layers have no learned weights: their
parameters are their filter taps.  :func:`filters_from_jax` turns a tap
set of the JAX package (name -> tuple of floats, correlation order, as a
dict or as the (name, taps) pairs of a module's ``_filters``): those of
``dtcwt_fwd_filters()`` / ``dtcwt_inv_filters()`` and of ``ScatLayer`` /
``ScatLayerj2``, into the buffers of :class:`DTCWTForward` /
:class:`DTCWTInverse` / :class:`ScatLayer` / :class:`ScatLayerj2`, a
state dict for ``load_state_dict``.  :func:`dwt_filters_from_jax` does
the same for the DWT modules, whose ``_filters`` is a tuple of
pywt-ordered taps, :func:`swt_filters_from_jax` for the SWT modules, and
:func:`alt_filters_from_jax` for the Selesnick DTCWT modules
(``DTCWTForward2`` / ``DTCWTInverse2``, whose ``_l1`` / ``_q`` are 8-tuples
of taps).  All take plain numbers and import nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["filters_from_jax", "dwt_filters_from_jax",
           "swt_filters_from_jax", "alt_filters_from_jax"]

# DTCWTForward and ScatLayerj2 hold the same names; ScatLayer the first
# two; with the bandpass-diagonal filters (biort="near_sym_b_bp") ScatLayer
# adds h2o and ScatLayerj2 h2o, h2a, h2b
_FWD = ("h0o", "h1o", "h0a", "h0b", "h1a", "h1b")
_INV = ("g0o", "g1o", "g0a", "g0b", "g1a", "g1b")
_SCAT1 = ("h0o", "h1o")
_SCAT1_BP = ("h0o", "h1o", "h2o")
_SCAT2_BP = ("h0o", "h1o", "h2o", "h0a", "h0b", "h1a", "h1b", "h2a", "h2b")
_KEY_SETS = (_FWD, _INV, _SCAT1, _SCAT1_BP, _SCAT2_BP)


def filters_from_jax(d) -> dict:
    """JAX tap set -> the port's filter buffers (float64, 1-D)."""
    d = dict(d)
    names = next((n for n in _KEY_SETS if set(d) == set(n)), None)
    if names is None:
        raise ValueError(f"expected one of the key sets {_KEY_SETS}, got "
                         f"{sorted(d)}")
    return {k: torch.as_tensor(np.asarray(d[k], dtype=np.float64).ravel())
            for k in names}


_DWT_NAMES = {(4, False): ("h0_col", "h1_col", "h0_row", "h1_row"),
              (4, True): ("g0_col", "g1_col", "g0_row", "g1_row"),
              (2, False): ("h0", "h1"),
              (2, True): ("g0", "g1")}


def dwt_filters_from_jax(filters, synthesis=False) -> dict:
    """A JAX DWT module's ``_filters`` -> the port's filter buffers
    (float64, 1-D), a state dict for ``load_state_dict``.

    ``filters`` is the 4-tuple of :class:`DWTForward` / :class:`DWTInverse`
    or the 2-tuple of :class:`DWT1DForward` / :class:`DWT1DInverse`, of
    pywt-ordered dec taps, or rec taps with ``synthesis`` (the inverse
    modules')."""
    filters = tuple(filters)
    names = _DWT_NAMES.get((len(filters), bool(synthesis)))
    if names is None:
        raise ValueError(f"expected a 2- or 4-tuple of tap vectors, got "
                         f"{len(filters)}")
    return {k: torch.as_tensor(np.asarray(f, dtype=np.float64).ravel())
            for k, f in zip(names, filters)}


def swt_filters_from_jax(filters) -> dict:
    """A JAX :class:`SWTForward` or :class:`SWTInverse`'s ``_filters`` -> the
    port module's filter buffers (float64, 1-D), a state dict for
    ``load_state_dict``.  Both modules hold the 4-tuple of pywt-ordered
    *dec* taps (the inverse merges by least squares against the analysis
    operator), so this is not ``dwt_filters_from_jax(..., synthesis=True)``
    for the inverse."""
    filters = tuple(filters)
    if len(filters) != 4:
        raise ValueError(f"expected the 4-tuple of an SWT module, got "
                         f"{len(filters)} tap vectors")
    return dwt_filters_from_jax(filters)


def alt_filters_from_jax(l1, q) -> dict:
    """A JAX :class:`DTCWTForward2` or :class:`DTCWTInverse2`'s ``_l1`` and
    ``_q`` (the level-1 and q-shift banks, each an 8-tuple of taps in the
    order h0a, h0b, g0a, g0b, h1a, h1b, g1a, g1b) -> the port module's
    filter buffers ``l1_<name>`` / ``q_<name>`` (float64, 1-D), a state
    dict for ``load_state_dict``.  Both modules hold both banks."""
    from pytorch_wavelets_tpu_torch.transforms.dtcwt_alt import BANK
    out = {}
    for prefix, bank in (("l1", tuple(l1)), ("q", tuple(q))):
        if len(bank) != len(BANK):
            raise ValueError(f"expected an 8-tuple of tap vectors for "
                             f"{prefix}, got {len(bank)}")
        for name, taps in zip(BANK, bank):
            out[f"{prefix}_{name}"] = torch.as_tensor(
                np.asarray(taps, dtype=np.float64).ravel())
    return out
