"""DTCWT biorthogonal (level-1) and quarter-shift (level>=2) filter banks.

Numpy copy of ``pytorch_wavelets_tpu/filters/dtcwt_coeffs.py``: the same
Kingsbury coefficient arrays, vendored as ``data/dtcwt_coeffs.npz`` (a
byte-identical copy), so this package never imports the JAX one.  Arrays
are float64 column vectors of shape (L, 1).
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["biort", "qshift", "level1"]

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data",
                          "dtcwt_coeffs.npz")
_COEFF_CACHE: dict = {}


def _bank():
    if "bank" not in _COEFF_CACHE:
        _COEFF_CACHE["bank"] = dict(np.load(_DATA_PATH))
    return _COEFF_CACHE["bank"]


def _load(name: str, varnames):
    bank = _bank()
    try:
        return tuple(bank[f"{name}/{k}"] for k in varnames)
    except KeyError:
        available = sorted({k.split("/")[0] for k in bank})
        raise ValueError(
            f"Wavelet '{name}' does not define ({', '.join(varnames)}) "
            f"coefficients. Available banks: {available}") from None


def level1(name: str, compact: bool = False):
    """Level-1 biorthogonal filters by name (reference:
    dtcwt/coeffs.py:41-77).

    With ``compact=True`` returns (h0o, g0o, h1o, g1o) — plus (h2o, g2o) for
    'near_sym_b_bp'.  Otherwise returns the 8-tuple a/b tree filters used by
    the 4-DWT formulation.
    """
    if compact:
        if name == "near_sym_b_bp":
            return _load(name, ("h0o", "g0o", "h1o", "g1o", "h2o", "g2o"))
        return _load(name, ("h0o", "g0o", "h1o", "g1o"))
    return _load(name, ("h0a", "h0b", "g0a", "g0b", "h1a", "h1b",
                        "g1a", "g1b"))


def biort(name: str):
    """Compact level-1 filters (reference: dtcwt/coeffs.py:34-38)."""
    return level1(name, compact=True)


def qshift(name: str):
    """Level>=2 quarter-shift filters by name (reference:
    dtcwt/coeffs.py:80-116)."""
    if name == "qshift_b_bp":
        return _load(name, ("h0a", "h0b", "g0a", "g0b", "h1a", "h1b",
                            "g1a", "g1b", "h2a", "h2b", "g2a", "g2b"))
    return _load(name, ("h0a", "h0b", "g0a", "g0b", "h1a", "h1b",
                        "g1a", "g1b"))
