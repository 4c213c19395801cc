"""Host-side index math shared by every transform family.

Numpy copy of ``pytorch_wavelets_tpu/utils/__init__.py``, kept here so
this package never imports the JAX one.  Boundary handling is derived on
the host with numpy.  :func:`reflect` is the half-sample symmetric
extension primitive the reference builds its symmetric padding on
(reference: ``pytorch_wavelets/utils.py:146-163``).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "reflect",
    "symm_pad_1d",
    "mode_to_int",
    "int_to_mode",
    "MODES",
    "dwt_coeff_len",
    "drawedge",
    "drawcirc",
    "stacked_2d_matrix_vector_prod",
    "stacked_2d_vector_matrix_prod",
    "stacked_2d_matrix_matrix_prod",
]

# String <-> int codec for padding modes (reference: dwt/lowlevel.py:274-309).
MODES = ("zero", "symmetric", "periodization", "constant", "reflect",
         "replicate", "periodic")
_MODE_TO_INT = {
    "zero": 0,
    "symmetric": 1,
    "per": 2,
    "periodization": 2,
    "constant": 3,
    "reflect": 4,
    "replicate": 5,
    "periodic": 6,
}


def mode_to_int(mode: str) -> int:
    try:
        return _MODE_TO_INT[mode]
    except KeyError:
        raise ValueError(f"Unknown pad type: {mode}") from None


def int_to_mode(mode: int) -> str:
    if not 0 <= mode <= 6:
        raise ValueError(f"Unknown pad type: {mode}")
    return MODES[mode]


def reflect(x, minx, maxx):
    """Fold indices ``x`` into [minx, maxx] by reflection about the bounds.

    Formulated as a triangle wave of period ``2 * (maxx - minx)``: shift to
    the bound, wrap into one period, and mirror the descending half.  With
    integer ``x`` and half-integer bounds (``k - 0.5``) this yields
    half-sample symmetric extension — edge samples repeated — which is the
    behaviour the reference's symmetric padding is built on (reference:
    pytorch_wavelets/utils.py:146-163; same contract, independent
    derivation).
    """
    x = np.asanyarray(x)
    period = 2.0 * (maxx - minx)
    phase = np.mod(x - minx, period)           # true mod: negatives fold up
    tri = (period / 2.0) - np.abs(phase - period / 2.0)
    return (tri + minx).astype(x.dtype)


def symm_pad_1d(l: int, m: int) -> np.ndarray:
    """Gather indices for half-sample symmetric padding by ``m`` on both
    ends of a length-``l`` axis (reference contract:
    pytorch_wavelets/utils.py:166-174)."""
    return reflect(np.arange(-m, l + m, dtype="int32"), -0.5, l - 0.5)


def _raised_cosine(plane: np.ndarray) -> np.ndarray:
    """Half-raised-cosine step: 0 below -w/2, 1 above +w/2, sinusoidal
    between.  ``plane`` is pre-scaled so the transition spans [-pi/2, pi/2]."""
    return 0.5 + 0.5 * np.sin(np.clip(plane, -np.pi / 2, np.pi / 2))


def drawedge(theta: float, r, w: float, N: int) -> np.ndarray:
    """N x N test image of a 0->1 intensity edge at ``theta`` degrees to the
    horizontal, passing through the ij-coordinate ``r``, with a raised-cosine
    transition ``w`` pels wide.

    Kingsbury-toolbox test pattern (reference contract:
    pytorch_wavelets/utils.py:45-74).  Derivation here: the reference's
    gradient-plane construction algebraically reduces to the signed distance
    along the inward edge normal ``-(cos theta, sin theta)`` measured from
    ``r``; we evaluate that closed form directly.
    """
    th = np.deg2rad(theta)
    r = np.asarray(r, dtype=np.float64)
    w = max(float(w), 1.0)
    ii = np.arange(N, dtype=np.float64)[:, None] - r[0]   # row offsets
    jj = np.arange(N, dtype=np.float64)[None, :] - r[1]   # col offsets
    plane = -np.cos(th) * ii - np.sin(th) * jj
    return _raised_cosine(plane * (np.pi / w))


def drawcirc(r: float, w: float, du: float, dv: float, N: int) -> np.ndarray:
    """N x N test image of a filled disc of radius ``r`` pels centred
    ``(du, dv)`` from the image centre, with a cosine-shaped edge of width
    ``w`` (10%..90% points).

    Kingsbury-toolbox test pattern (reference contract:
    pytorch_wavelets/utils.py:76-101): a Gaussian bump of scale ``r`` is
    thresholded at its value one radius out (exp(-1/2)) and squashed through
    the same raised-cosine step as :func:`drawedge`.  Note the reference's
    convention: ``du`` offsets columns and ``dv`` offsets rows.
    """
    w = max(float(w), 1.0)
    c = (N + 1) / 2.0
    rows = (np.arange(N, dtype=np.float64)[:, None] - c - dv) / r
    cols = (np.arange(N, dtype=np.float64)[None, :] - c - du) / r
    bump = np.exp(-0.5 * (rows**2 + cols**2)) - np.exp(-0.5)
    return _raised_cosine(bump * (3.0 * r / w))


def stacked_2d_matrix_vector_prod(mats: np.ndarray, vecs: np.ndarray):
    """Batched ``mats[i,j] @ vecs[i,j]`` over leading axes: (..., N, M) x
    (..., M) -> (..., N).  (Reference contract: utils.py:190-202.)"""
    return np.einsum("...nm,...m->...n", mats, vecs)


def stacked_2d_vector_matrix_prod(vecs: np.ndarray, mats: np.ndarray):
    """Batched ``mats[i,j].T @ vecs[i,j]`` over leading axes: (..., N) x
    (..., N, M) -> (..., M) — i.e. the vector multiplies from the left.
    (Reference contract: utils.py:205-221, sans the reshape detour.)"""
    return np.einsum("...n,...nm->...m", vecs, mats)


def stacked_2d_matrix_matrix_prod(mats1: np.ndarray, mats2: np.ndarray):
    """Batched ``mats1[i,j] @ mats2[i,j]`` over leading axes: (..., N, M) x
    (..., M, R) -> (..., N, R).  (Reference contract: utils.py:224-235.)"""
    return np.einsum("...nm,...mr->...nr", mats1, mats2)


def dwt_coeff_len(data_len: int, filt_len: int, mode: str) -> int:
    """Output length of one DWT level; re-implements ``pywt.dwt_coeff_len``
    without the pywt dependency (reference relies on it at
    dwt/lowlevel.py:153)."""
    if data_len < 1:
        raise ValueError("Value of data_len must be greater than zero.")
    if filt_len < 1:
        raise ValueError("Value of filt_len must be greater than zero.")
    if mode in ("per", "periodization"):
        return (data_len + 1) // 2
    return (data_len + filt_len - 1) // 2
