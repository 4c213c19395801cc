"""pywt-free discrete wavelet filter coefficient construction.

Numpy copy of ``pytorch_wavelets_tpu/filters/dwt_coeffs.py`` (the same
constructions, so the tables are bit-equal), kept here so this package
never imports the JAX one.

The reference resolves wavelet names through ``pywt.Wavelet``
(reference: pytorch_wavelets/dwt/transform2d.py:22-25).  pywt is not a
dependency of this package, so the classic filter families are constructed
from first principles in float64 numpy on the host:

* Daubechies (``dbN``) / Haar: minimum-phase spectral factorization of the
  maximally-flat halfband polynomial.
* Symlets (``symN``): same magnitude response, root subset chosen to
  minimise phase non-linearity (least-asymmetric).
* Coiflets (``coifN``): Newton iteration on the defining vanishing-moment
  system, seeded from the standard published filters.
* Biorthogonal splines (``biorNr.Nd`` for Nr in 1..3) and the 9/7 pair
  (``bior4.4``) via the CDF construction; ``rbioX.Y`` swaps the roles.

Sign/ordering conventions match pywt exactly:
``dec_lo = rec_lo[::-1]`` (orthogonal), ``dec_hi[k] = (-1)^(k+1) rec_lo[k]``,
``rec_hi[k] = (-1)^k dec_lo[k]``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from math import comb
from typing import Sequence

import numpy as np

__all__ = ["Wavelet", "wavelet", "wavelist", "qmf_from_lowpass"]


# --------------------------------------------------------------------------
# Laurent polynomial helpers (coeff array + exponent offset of first entry)
# --------------------------------------------------------------------------

def _poly_mul(a, b):
    return np.convolve(a, b)


def _binomial_lowpass(order: int) -> np.ndarray:
    """((1+z)/2)^order as a coefficient array."""
    c = np.array([comb(order, k) for k in range(order + 1)], dtype=np.float64)
    return c / (2.0 ** order)


def _pk_poly(K: int) -> np.ndarray:
    """P_K(y) = sum_{k<K} C(K-1+k, k) y^k — the maximally flat halfband
    remainder used by both the Daubechies and CDF constructions."""
    return np.array([comb(K - 1 + k, k) for k in range(K)], dtype=np.float64)


def _pk_in_z(K: int) -> np.ndarray:
    """P_K evaluated at y = (2 - z - z^-1)/4, returned as the coefficient
    array of a symmetric Laurent polynomial of degree K-1 in both directions
    (length 2K-1, centred)."""
    # y = -(1/4) z^{-1} (z - 1)^2
    acc = np.zeros(2 * K - 1)
    centre = K - 1
    p = _pk_poly(K)
    for k in range(K):
        # y^k has coefficients (-1/4)^k * (z-1)^{2k}, centred at 0
        f = np.array([1.0])
        base = np.array([1.0, -1.0])
        for _ in range(2 * k):
            f = _poly_mul(f, base)
        f = f * ((-0.25) ** k)
        acc[centre - k: centre + k + 1] += p[k] * f
    return acc


# --------------------------------------------------------------------------
# Orthogonal families
# --------------------------------------------------------------------------

def _db_roots(N: int):
    """Roots (in z) of the P_N remainder, paired as (inside, outside) the
    unit circle, grouped so real coefficients can be maintained."""
    y_roots = np.roots(_pk_poly(N)[::-1]) if N > 1 else np.array([])
    groups = []  # each entry: (inside_roots, outside_roots) closed under conj
    seen = np.zeros(len(y_roots), dtype=bool)
    for i, y in enumerate(y_roots):
        if seen[i]:
            continue
        seen[i] = True
        ys = [y]
        if abs(y.imag) > 1e-12:
            # find the conjugate partner
            j = int(np.argmin(np.abs(y_roots - np.conj(y)) + seen * 1e9))
            seen[j] = True
            ys.append(y_roots[j])
        inside, outside = [], []
        for yy in ys:
            # z^2 - (2 - 4y) z + 1 = 0
            b = 2.0 - 4.0 * yy
            disc = np.sqrt(b * b - 4.0 + 0j)
            z1, z2 = (b + disc) / 2.0, (b - disc) / 2.0
            if abs(z1) > abs(z2):
                z1, z2 = z2, z1
            inside.append(z1)
            outside.append(z2)
        groups.append((inside, outside))
    return groups


def _filter_from_roots(N: int, chosen_roots) -> np.ndarray:
    """Build the length-2N scaling filter with N zeros at z=-1 plus the
    chosen remainder roots, normalised to sum sqrt(2)."""
    h = np.array([1.0 + 0j])
    for _ in range(N):
        h = _poly_mul(h, np.array([1.0, 1.0]))
    for z in chosen_roots:
        h = _poly_mul(h, np.array([1.0, -z]))
    h = np.real(h)
    h = h * (np.sqrt(2.0) / h.sum())
    return h


def _daubechies(N: int) -> np.ndarray:
    """Minimum-phase Daubechies scaling filter (pywt's rec_lo ordering)."""
    if N == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    groups = _db_roots(N)
    chosen = [z for inside, _ in groups for z in inside]
    return _filter_from_roots(N, chosen)


def _phase_nonlinearity(h: np.ndarray) -> float:
    n = 1024
    w = np.linspace(1e-3, np.pi - 1e-3, n)
    H = np.polyval(h[::-1], np.exp(-1j * w))
    phase = np.unwrap(np.angle(H))
    # remove the best-fit linear component
    A = np.vstack([w, np.ones_like(w)]).T
    resid = phase - A @ np.linalg.lstsq(A, phase, rcond=None)[0]
    return float(np.sum(resid ** 2))


def _symlet(N: int) -> np.ndarray:
    """Least-asymmetric Daubechies: enumerate inside/outside choices per
    conjugate root group, keep the phase-flattest real filter."""
    if N < 4:
        return _daubechies(N)
    groups = _db_roots(N)
    best, best_cost = None, np.inf
    for mask in range(1 << len(groups)):
        chosen = []
        for gi, (inside, outside) in enumerate(groups):
            chosen.extend(inside if (mask >> gi) & 1 == 0 else outside)
        h = _filter_from_roots(N, chosen)
        cost = _phase_nonlinearity(h)
        if cost < best_cost - 1e-9:
            best_cost, best = cost, h
    # pywt orients symlets so the larger taps sit late; match by energy split
    if np.sum(best[: len(best) // 2] ** 2) > np.sum(best[len(best) // 2:] ** 2):
        best = best[::-1]
    return best


# --------------------------------------------------------------------------
# Coiflets — Newton refinement of the vanishing-moment system
# --------------------------------------------------------------------------

_COIF_SEEDS = {
    # Standard published coif1..coif3 (rec_lo, pywt ordering), ~6 decimals;
    # refined to double precision below by Gauss-Newton iteration.
    1: [-0.015655728, -0.072732620, 0.384864847, 0.852572020, 0.337897662,
        -0.072732620],
    2: [-0.000720549, -0.001823209, 0.005611435, 0.023680172, -0.059434419,
        -0.076488599, 0.417005184, 0.812723635, 0.386110067, -0.067372555,
        -0.041464937, 0.016387336],
    3: [-0.000003460, -0.000007098, 0.000466217, 0.000971412, -0.005164619,
        -0.011449953, 0.044365222, 0.074346501, -0.086288911, -0.135011020,
        0.447900766, 0.743891430, 0.394153948, -0.062035964, -0.065771911,
        0.041289209, 0.009860988, -0.008972468],
}


def _coiflet(N: int) -> np.ndarray:
    """Refine a published coiflet seed to double precision via Gauss-Newton
    on orthonormality + wavelet/scaling vanishing-moment equations."""
    if N not in _COIF_SEEDS:
        raise ValueError(
            f"coif{N} is not available in pytorch_wavelets_tpu "
            "(coif1..coif3 are supported)")
    h = np.array(_COIF_SEEDS[N], dtype=np.float64)
    L = len(h)
    n = np.arange(L, dtype=np.float64)
    sgn = (-1.0) ** n

    for _outer in range(4):
        # centre of mass of the scaling moments, re-estimated each round
        tau = float(np.sum(n * h) / np.sum(h))

        def eqs(hh):
            out = [np.sum(hh) - np.sqrt(2.0)]
            for k in range(L // 2):
                v = np.sum(hh[: L - 2 * k] * hh[2 * k:] if k else hh * hh)
                out.append(v - (1.0 if k == 0 else 0.0))
            for p in range(2 * N):          # wavelet moments
                out.append(np.sum(sgn * ((n - tau) ** p) * hh))
            for p in range(1, 2 * N):       # scaling moments about tau
                out.append(np.sum(((n - tau) ** p) * hh))
            return np.array(out)

        for _ in range(50):
            f = eqs(h)
            J = np.zeros((len(f), L))
            eps = 1e-8
            for i in range(L):
                hp = h.copy()
                hp[i] += eps
                J[:, i] = (eqs(hp) - f) / eps
            step, *_ = np.linalg.lstsq(J, -f, rcond=None)
            h = h + step
            if np.max(np.abs(step)) < 1e-14:
                break
    return h


# --------------------------------------------------------------------------
# Biorthogonal spline (CDF) families
# --------------------------------------------------------------------------

def _bior_natural(nr: int, nd: int):
    """Natural (unpadded) CDF spline filter pair (dec_lo, rec_lo)."""
    K = (nr + nd) // 2
    # synthesis lowpass: B-spline binomial of order nr
    rec = _binomial_lowpass(nr) * np.sqrt(2.0)
    # analysis lowpass: ((1+z)/2)^nd * P_K(y(z)), centred
    dec = _poly_mul(_binomial_lowpass(nd), _pk_in_z(K)) * np.sqrt(2.0)
    # strip numerically-zero edge taps that the Laurent centring introduced
    nz = np.nonzero(np.abs(dec) > 1e-14)[0]
    dec = dec[nz[0]: nz[-1] + 1]
    return dec, rec


def _bior44_natural():
    """CDF 9/7 pair (pywt's bior4.4) via root-split of P_4."""
    K = 4
    y_roots = np.roots(_pk_poly(K)[::-1])
    real_roots = [y for y in y_roots if abs(y.imag) < 1e-10]
    cplx_roots = [y for y in y_roots if y.imag > 1e-10]
    assert len(real_roots) == 1 and len(cplx_roots) == 1

    def y_factor_in_z(roots):
        """prod (y(z) - y_k) as centred symmetric Laurent coefficients."""
        acc = np.array([1.0 + 0j])
        for yk in roots:
            # y(z) - yk = -(1/4) z^{-1} (z^2 - (2 - 4 yk) z + 1)
            f = -(0.25) * np.array([1.0, -(2.0 - 4.0 * yk), 1.0])
            acc = _poly_mul(acc, f)
        return np.real(acc)

    dec_extra = y_factor_in_z([cplx_roots[0], np.conj(cplx_roots[0])])
    rec_extra = y_factor_in_z(real_roots)
    dec = _poly_mul(_binomial_lowpass(4), dec_extra)
    rec = _poly_mul(_binomial_lowpass(4), rec_extra)
    dec = dec * (np.sqrt(2.0) / dec.sum())
    rec = rec * (np.sqrt(2.0) / rec.sum())
    return dec, rec


def _bior_padded(nr: int, nd: int):
    """Zero-pad the natural pair to pywt's equal even length + alignment."""
    if (nr, nd) == (4, 4):
        dec, rec = _bior44_natural()
    elif nr in (1, 2, 3):
        dec, rec = _bior_natural(nr, nd)
    else:
        raise ValueError(f"bior{nr}.{nd} is not supported")
    n = max(len(dec), len(rec))
    if n % 2 == 1:
        n += 1
    ld, lr = len(dec), len(rec)
    if ld % 2 == 1:  # odd natural lengths (nr even): dec centre at n/2
        dec = np.concatenate([np.zeros(n - ld), dec])
        front = n // 2 - 1 - (lr - 1) // 2
        rec = np.concatenate([np.zeros(front), rec,
                              np.zeros(n - lr - front)])
    else:  # even natural lengths: symmetric padding
        fd = (n - ld) // 2
        dec = np.concatenate([np.zeros(fd), dec, np.zeros(n - ld - fd)])
        fr = (n - lr) // 2
        rec = np.concatenate([np.zeros(fr), rec, np.zeros(n - lr - fr)])
    return dec, rec


# --------------------------------------------------------------------------
# Wavelet object + name resolution
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Wavelet:
    """Filter quartet with pywt-compatible attribute names."""
    name: str
    dec_lo: np.ndarray = field(repr=False)
    dec_hi: np.ndarray = field(repr=False)
    rec_lo: np.ndarray = field(repr=False)
    rec_hi: np.ndarray = field(repr=False)

    @property
    def dec_len(self) -> int:
        return len(self.dec_lo)

    @property
    def rec_len(self) -> int:
        return len(self.rec_lo)


def qmf_from_lowpass(dec_lo: Sequence[float], rec_lo: Sequence[float]):
    """Derive the highpass pair from the two lowpass filters using pywt's
    sign conventions (validated against pywt's db/bior tables)."""
    dec_lo = np.asarray(dec_lo, dtype=np.float64)
    rec_lo = np.asarray(rec_lo, dtype=np.float64)
    k = np.arange(len(rec_lo))
    dec_hi = ((-1.0) ** (k + 1)) * rec_lo
    k = np.arange(len(dec_lo))
    rec_hi = ((-1.0) ** k) * dec_lo
    return dec_hi, rec_hi


def _orthogonal(name: str, h: np.ndarray) -> Wavelet:
    rec_lo = np.asarray(h, dtype=np.float64)
    dec_lo = rec_lo[::-1].copy()
    dec_hi, rec_hi = qmf_from_lowpass(dec_lo, rec_lo)
    return Wavelet(name, dec_lo, dec_hi, rec_lo, rec_hi)


def _dmey(N: int = 4096) -> np.ndarray:
    """62-tap FIR approximation of the Meyer scaling filter ('dmey').

    Standard construction: sample the closed-form Meyer lowpass
    H(w) = sqrt(2) * cos(pi/2 * nu(3|w|/pi - 1)) (nu the degree-7
    auxiliary polynomial) on an N-point grid, inverse DFT to the
    zero-phase impulse response, and keep the 62 central taps.  The
    result is grid-converged (identical at N=1024 and N=4096) and
    matches the canonical dmey center taps (0.7437504, 0.4440947,
    -0.0350483, ...); like every 62-tap Meyer truncation it is only
    near-orthogonal (PR error ~1e-6 — same caveat pywt/MATLAB document
    for their dmey)."""
    k = np.arange(N)
    w = 2 * np.pi * k / N
    wf = np.abs(np.mod(w + np.pi, 2 * np.pi) - np.pi)  # fold to [0, pi]
    x = np.clip(3 * wf / np.pi - 1, 0.0, 1.0)
    nu = x ** 4 * (35 - 84 * x + 70 * x ** 2 - 20 * x ** 3)
    H = np.where(wf <= np.pi / 3, np.sqrt(2.0),
                 np.where(wf <= 2 * np.pi / 3,
                          np.sqrt(2.0) * np.cos(np.pi / 2 * nu), 0.0))
    h = np.fft.fftshift(np.fft.ifft(H).real)
    c = N // 2
    return np.ascontiguousarray(h[c - 31:c + 31], dtype=np.float64)


def _biorthogonal(name: str, dec_lo: np.ndarray, rec_lo: np.ndarray) -> Wavelet:
    dec_hi, rec_hi = qmf_from_lowpass(dec_lo, rec_lo)
    return Wavelet(name, np.asarray(dec_lo), dec_hi, np.asarray(rec_lo),
                   rec_hi)


_CACHE: dict = {}


def wavelet(name) -> Wavelet:
    """Resolve a wavelet by pywt-style name ('db4', 'sym8', 'bior2.4', ...).

    Also accepts an existing :class:`Wavelet` (returned unchanged)."""
    if isinstance(name, Wavelet):
        return name
    key = str(name).lower()
    if key in _CACHE:
        return _CACHE[key]
    if key == "haar":
        wav = _orthogonal("haar", _daubechies(1))
    elif m := re.fullmatch(r"db(\d+)", key):
        N = int(m.group(1))
        if not 1 <= N <= 38:
            raise ValueError(f"db{N} out of supported range 1..38")
        wav = _orthogonal(key, _daubechies(N))
    elif m := re.fullmatch(r"sym(\d+)", key):
        N = int(m.group(1))
        if not 2 <= N <= 20:
            raise ValueError(f"sym{N} out of supported range 2..20")
        wav = _orthogonal(key, _symlet(N))
    elif m := re.fullmatch(r"coif(\d+)", key):
        wav = _orthogonal(key, _coiflet(int(m.group(1))))
    elif key == "dmey":
        wav = _orthogonal(key, _dmey())
    elif m := re.fullmatch(r"bior(\d)\.(\d)", key):
        dec, rec = _bior_padded(int(m.group(1)), int(m.group(2)))
        wav = _biorthogonal(key, dec, rec)
    elif m := re.fullmatch(r"rbio(\d)\.(\d)", key):
        dec, rec = _bior_padded(int(m.group(1)), int(m.group(2)))
        # reverse biorthogonal: swap analysis/synthesis roles
        wav = _biorthogonal(key, rec[::-1].copy(), dec[::-1].copy())
    else:
        raise ValueError(f"Unknown wavelet name: {name}")
    _CACHE[key] = wav
    return wav


def wavelist():
    names = ["haar", "dmey"]
    names += [f"db{i}" for i in range(1, 39)]
    names += [f"sym{i}" for i in range(2, 21)]
    names += [f"coif{i}" for i in range(1, 4)]
    names += ["bior1.1", "bior1.3", "bior1.5", "bior2.2", "bior2.4",
              "bior2.6", "bior2.8", "bior3.1", "bior3.3", "bior3.5",
              "bior3.7", "bior3.9", "bior4.4"]
    names += [n.replace("bior", "rbio") for n in names if n.startswith("bior")]
    return names
