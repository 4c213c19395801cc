"""Alternative DTCWT formulation as 4 parallel critically-sampled DWTs
(Selesnick's complex dual-tree construction); port of
``pytorch_wavelets_tpu/transforms/dtcwt_alt.py``.

Reference semantics: pytorch_wavelets/dtcwt/lowlevel2.py:17-154 (module
formulation) and :444-575 (functional cplxdual2D/icplxdual2D).  Each of the
four (col-tree, row-tree) combinations runs an ordinary separable DWT
through the port's ``dwt2d`` / ``idwt2d`` (K6/K7 on CUDA, with the
reference's backwards, as the JAX package's custom VJPs); the +/-
butterflies of corresponding subbands give the 6 oriented complex bands,
as PyTorch elementwise operations (XLA fusions in the JAX package, not a
kernel).  The quad analysis runs the four trees' splits on K6
(:func:`quad_afb2d`) or as one 16-PSF filtering on K14
(:func:`quad_afb2d_nonsep`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from pytorch_wavelets_tpu_torch.filters import level1 as _level1
from pytorch_wavelets_tpu_torch.filters import qshift as _qshift
from pytorch_wavelets_tpu_torch.models._base import _TapsModule
from pytorch_wavelets_tpu_torch.ops.afb_sfb import as_taps
from pytorch_wavelets_tpu_torch.ops.nonsep import (
    NonsepAFB, SeparableAFB, outer_filters,
)
from pytorch_wavelets_tpu_torch.transforms.dwt import dwt2d, idwt2d

__all__ = ["cplxdual2d", "icplxdual2d", "DTCWTForward2",
           "DTCWTInverse2", "quad_afb2d", "quad_afb2d_nonsep",
           "prep_filt_quad_afb2d_nonsep"]

_SQRT2 = math.sqrt(2.0)
# the 8 filters of a tree bank, in the order of level1() / qshift()
BANK = ("h0a", "h0b", "g0a", "g0b", "h1a", "h1b", "g1a", "g1b")


def _pm(a, b):
    return (a + b) / _SQRT2, (a - b) / _SQRT2


def _tree_filters_dec(bank):
    """8-tuple (h0a, h0b, g0a, g0b, h1a, h1b, g1a, g1b) -> 2x2 grid of
    4-tuple dec filter specs indexed [col_tree][row_tree]."""
    h0a, h0b, _, _, h1a, h1b, _, _ = bank
    return ((
        (h0a, h1a, h0a, h1a), (h0a, h1a, h0b, h1b)),
        ((h0b, h1b, h0a, h1a), (h0b, h1b, h0b, h1b)))


def _tree_filters_rec(bank):
    _, _, g0a, g0b, _, _, g1a, g1b = bank
    return ((
        (g0a, g1a, g0a, g1a), (g0a, g1a, g0b, g1b)),
        ((g0b, g1b, g0a, g1a), (g0b, g1b, g0b, g1b)))


def _combine_orientations(w, mag=None):
    """w: [2][2] of (N, C, 3, H, W) band stacks ordered (LH, HL, HH).
    Returns the 6-orientation complex stack (N, 6, C, H, W, 2)
    (orientation wiring: reference lowlevel2.py:69-80), or with ``mag``
    the magnitudes sqrt(re^2 + im^2 + mag) - sqrt(mag), (N, 6, C, H, W)."""
    deg75r, deg105i = _pm(w[0][0][:, :, 1], w[1][1][:, :, 1])
    deg105r, deg75i = _pm(w[0][1][:, :, 1], w[1][0][:, :, 1])
    deg15r, deg165i = _pm(w[0][0][:, :, 0], w[1][1][:, :, 0])
    deg165r, deg15i = _pm(w[0][1][:, :, 0], w[1][0][:, :, 0])
    deg135r, deg45i = _pm(w[0][0][:, :, 2], w[1][1][:, :, 2])
    deg45r, deg135i = _pm(w[0][1][:, :, 2], w[1][0][:, :, 2])
    yhr = torch.stack([deg15r, deg45r, deg75r, deg105r, deg135r, deg165r],
                      dim=1)
    yhi = torch.stack([deg15i, deg45i, deg75i, deg105i, deg135i, deg165i],
                      dim=1)
    if mag is not None:
        return torch.sqrt(yhr ** 2 + yhi ** 2 + mag) - math.sqrt(mag)
    return torch.stack([yhr, yhi], dim=-1)


def _split_orientations(yh):
    """Inverse of :func:`_combine_orientations`: 6-orientation complex stack
    -> [2][2] of (N, C, 3, H, W) band stacks.

    (The reference's counterpart, lowlevel2.py:120-136 / :541-557, crosses
    the 45/135-degree channels relative to its own forward wiring; the
    JAX package fixes that, so split(combine(w)) == w exactly, and so
    does the port.)"""
    w = [[[None] * 3 for _ in range(2)] for _ in range(2)]
    w[0][0][1], w[1][1][1] = _pm(yh[:, 2, ..., 0], yh[:, 3, ..., 1])
    w[0][1][1], w[1][0][1] = _pm(yh[:, 3, ..., 0], yh[:, 2, ..., 1])
    w[0][0][0], w[1][1][0] = _pm(yh[:, 0, ..., 0], yh[:, 5, ..., 1])
    w[0][1][0], w[1][0][0] = _pm(yh[:, 5, ..., 0], yh[:, 0, ..., 1])
    w[0][0][2], w[1][1][2] = _pm(yh[:, 4, ..., 0], yh[:, 1, ..., 1])
    w[0][1][2], w[1][0][2] = _pm(yh[:, 1, ..., 0], yh[:, 4, ..., 1])
    return [[torch.stack(w[m][n], dim=2) for n in range(2)]
            for m in range(2)]


def _cplxdual_fwd(x, J, l1, q, mode, mag, m_is_row_tree):
    """Shared 4-tree analysis.  ``m_is_row_tree`` selects between the two
    (mutually transposed) tree-index conventions the reference uses:
    DTCWTForward2 runs tree m along W (lowlevel2.py:31-34), while
    cplxdual2D runs tree m along H (lowlevel2.py:470-477)."""
    x = x / 2.0
    dec1 = _tree_filters_dec(l1)
    dec2 = _tree_filters_dec(q)

    w = [[[None] * 2 for _ in range(2)] for _ in range(J)]
    lows = [[None] * 2 for _ in range(2)]
    for m in range(2):
        for n in range(2):
            f1 = dec1[m][n] if m_is_row_tree else dec1[n][m]
            f2 = dec2[m][n] if m_is_row_tree else dec2[n][m]
            ll, bands1 = dwt2d(x, f1, J=1, mode=mode)
            w[0][m][n] = bands1[0]
            if J > 1:
                ll, bands = dwt2d(ll, f2, J=J - 1, mode=mode)
                for j in range(1, J):
                    w[j][m][n] = bands[j - 1]
            lows[m][n] = ll
    bias = 0.01 if mag else None
    yh = [_combine_orientations(w[j], mag=bias) for j in range(J)]
    return lows, yh


def _bank(spec, resolve):
    return resolve(spec) if isinstance(spec, str) else spec


def cplxdual2d(x, J=3, level1="farras", qshift="qshift_a",
               mode="periodization", mag=False):
    """Complex dual-tree 2-D DTCWT via 4 DWT pyramids.

    Returns (lows, yh): lows is a [2][2] grid of per-tree lowpasses, yh a
    finest-first list of (N, 6, C, H, W, 2) complex bands (or magnitudes
    (N, 6, C, H, W) when ``mag``) — reference lowlevel2.py:444-520.
    """
    return _cplxdual_fwd(x, J, _bank(level1, _level1), _bank(qshift, _qshift),
                         mode, mag, m_is_row_tree=False)


def _cplxdual_inv(yl, yh, l1, q, mode, m_is_row_tree):
    rec1 = _tree_filters_rec(l1)
    rec2 = _tree_filters_rec(q)
    J = len(yh)
    w = [_split_orientations(yh[j]) for j in range(J)]

    y = None
    for m in range(2):
        for n in range(2):
            f1 = rec1[m][n] if m_is_row_tree else rec1[n][m]
            f2 = rec2[m][n] if m_is_row_tree else rec2[n][m]
            lo = yl[m][n]
            if J > 1:
                lo = idwt2d((lo, [w[j][m][n] for j in range(1, J)]), f2,
                            mode=mode)
            lo = idwt2d((lo, [w[0][m][n]]), f1, mode=mode)
            y = lo if y is None else y + lo
    return y / 2.0


def icplxdual2d(yl, yh, level1="farras", qshift="qshift_a",
                mode="periodization"):
    """Inverse of :func:`cplxdual2d`.

    (The reference's icplxdual2D is dead code, lowlevel2.py:564-565; this
    is the JAX package's working equivalent, validated by perfect
    reconstruction.)"""
    return _cplxdual_inv(yl, yh, _bank(level1, _level1),
                         _bank(qshift, _qshift), mode, m_is_row_tree=False)


def _alt_filters(biort, qshift):
    """The level-1 and q-shift banks as the modules' buffers:
    ``l1_<name>`` and ``q_<name>`` for each name of :data:`BANK`."""
    out = {}
    for prefix, bank in (("l1", _bank(biort, _level1)),
                         ("q", _bank(qshift, _qshift))):
        for name, taps in zip(BANK, bank):
            out[f"{prefix}_{name}"] = tuple(float(v) for v in as_taps(taps))
    return out


class _AltModule(_TapsModule):
    def __init__(self, biort, qshift, mode, mesh, device):
        super().__init__(_alt_filters(biort, qshift), device, mesh, None)
        self.biort = biort if isinstance(biort, str) else "custom"
        self.qshift = qshift if isinstance(qshift, str) else "custom"
        self.mode = mode

    def _banks(self):
        return tuple(tuple(np.asarray(self._filters[f"{p}_{n}"])
                           for n in BANK) for p in ("l1", "q"))


class DTCWTForward2(_AltModule):
    """DTCWT as 4 parallel DWTs (reference DTCWTForward2,
    lowlevel2.py:17-82).  Call: x -> (lows [2][2], yh list of
    (N, 6, C, H, W, 2)).

    Holds both banks' 8 filters as float64 buffers on ``device``: 'cuda'
    (default; raises without CUDA), where the four pyramids and their
    backward run K6/K7, or 'cpu' for the plain PyTorch path.  ``mesh``: a
    ``DeviceMesh`` (``parallel.make_mesh``): batch data parallelism, as
    the JAX package's ``_gspmd_apply`` (the form has no sharded plan):
    the batch over 'data', each rank running the transform on its own
    chunk (``parallel/sharded.py:sharded_batch_apply``), every output a
    DTensor sharded on 'data'."""

    def __init__(self, biort="farras", qshift="qshift_a", J=3,
                 mode="symmetric", mesh=None, device="cuda"):
        super().__init__(biort, qshift, mode, mesh, device)
        self.J = J

    def forward(self, x):
        self._check_device(x)
        l1, q = self._banks()

        def run(z):
            return _cplxdual_fwd(z, self.J, l1, q, self.mode, mag=False,
                                 m_is_row_tree=True)
        if self.mesh is not None:
            # imported here: parallel.sharded imports the transforms
            from pytorch_wavelets_tpu_torch.parallel.sharded import (
                sharded_batch_apply,
            )
            return sharded_batch_apply(run, x, self.mesh, "DTCWTForward2")
        return run(x)


class DTCWTInverse2(_AltModule):
    """Inverse of :class:`DTCWTForward2` (reference DTCWTInverse2,
    lowlevel2.py:85-154).  Call: (lows [2][2], yh) -> x.  ``device`` and
    ``mesh`` as for :class:`DTCWTForward2`."""

    def __init__(self, biort="farras", qshift="qshift_a", mode="symmetric",
                 mesh=None, device="cuda"):
        super().__init__(biort, qshift, mode, mesh, device)

    def forward(self, coeffs):
        yl, yh = coeffs
        self._check_device(*(t for row in yl for t in row), *yh)
        l1, q = self._banks()

        def run(cs):
            return _cplxdual_inv(*cs, l1, q, self.mode, m_is_row_tree=True)
        if self.mesh is not None:
            from pytorch_wavelets_tpu_torch.parallel.sharded import (
                sharded_batch_apply,
            )
            return sharded_batch_apply(run, (yl, yh), self.mesh,
                                       "DTCWTInverse2")
        return run((yl, yh))


_QUAD_TREES = [("a", "a"), ("a", "b"), ("b", "a"), ("b", "b")]


def _quad_taps(h0a, h1a, h0b, h1b):
    return {"a": (as_taps(h0a), as_taps(h1a)),
            "b": (as_taps(h0b), as_taps(h1b))}


def quad_afb2d(x, h0a, h1a, h0b, h1b, mode="zero"):
    """Single-level 4-tree ("quad") analysis (reference experiment:
    dtcwt/lowlevel2.py:259-372, fed by prep_filt_quad_afb2d:208-256).

    Runs the four (col-tree, row-tree) DWT combinations — (a,a), (a,b),
    (b,a), (b,b) — on x/2 and butterflies the bandpasses into 6 oriented
    complex subbands.  Returns (yl, yh):
      yl (N, C, H, W): the four tree lowpasses interleaved back into a
        double-size quad image (reference :364-370),
      yh (N, 6, C, H', W', 2): orientations 15..165 degrees.

    On CUDA each tree is two K6 launches; the gradient is one launch of
    K14's adjoint with the 16 PSFs of :func:`prep_filt_quad_afb2d_nonsep`
    on the separable split's plan, the exact transpose
    (:class:`~pytorch_wavelets_tpu_torch.ops.nonsep.SeparableAFB`).
    """
    taps = {k: tuple(np.ascontiguousarray(h[::-1]) for h in v)
            for k, v in _quad_taps(h0a, h1a, h0b, h1b).items()}
    trees = tuple(taps[c] + taps[r] for c, r in _QUAD_TREES)
    f = prep_filt_quad_afb2d_nonsep(h0a, h1a, h0b, h1b)
    y = SeparableAFB.apply(x / 2, trees, f, mode)
    return _quad_epilogue([y[:, :, 4 * i:4 * i + 4] for i in range(4)])


def _quad_epilogue(ys):
    """Shared tail of the quad analysis: per-tree (N, C, 4, H', W') band
    stacks -> (yl quad-interleaved, yh 6-orientation complex)."""
    # band order (LL, LH, HL, HH) with LH = row-lo/col-hi; the reference's
    # quad band order is (ll, col-lo.row-hi, col-hi.row-lo, hh)
    ll = [y[:, :, 0] for y in ys]
    b1 = [y[:, :, 2] for y in ys]     # col-lo, row-hi == HL
    b2 = [y[:, :, 1] for y in ys]     # col-hi, row-lo == LH
    b3 = [y[:, :, 3] for y in ys]

    # butterfly wiring (reference :354-362)
    deg75r, deg105i = _pm(b1[0], b1[3])
    deg105r, deg75i = _pm(b1[1], b1[2])
    deg15r, deg165i = _pm(b2[0], b2[3])
    deg165r, deg15i = _pm(b2[1], b2[2])
    deg135r, deg45i = _pm(b3[0], b3[3])
    deg45r, deg135i = _pm(b3[1], b3[2])
    yhr = torch.stack([deg15r, deg45r, deg75r, deg105r, deg135r, deg165r],
                      dim=1)
    yhi = torch.stack([deg15i, deg45i, deg75i, deg105i, deg135i, deg165i],
                      dim=1)
    yh = torch.stack([yhr, yhi], dim=-1)

    # interleave the 4 tree lowpasses into a double-size quad image
    # (reference :364-370): even output rows/cols come from tree d/b
    N, C, Hp, Wp = ll[0].shape
    rowa = torch.stack([ll[1], ll[0]], dim=-1).reshape(N, C, Hp, Wp * 2)
    rowb = torch.stack([ll[3], ll[2]], dim=-1).reshape(N, C, Hp, Wp * 2)
    yl = torch.stack([rowb, rowa], dim=-2).reshape(N, C, Hp * 2, Wp * 2)
    return yl, yh


def prep_filt_quad_afb2d_nonsep(h0a, h1a, h0b, h1b):
    """(16, Ly, Lx) mirrored outer-product PSF stack for the single-conv
    quad analysis: 4 bands (LL, LH, HL, HH) per tree, trees ordered
    (a,a), (a,b), (b,a), (b,b) — reference: dtcwt/lowlevel2.py:157-206
    (its stack is band-major; this one is tree-major to match the
    separable path's per-tree epilogue)."""
    taps = _quad_taps(h0a, h1a, h0b, h1b)
    stacks = []
    for col_t, row_t in _QUAD_TREES:
        h0c, h1c = taps[col_t]
        h0r, h1r = taps[row_t]
        stacks.append(outer_filters(h0c, h1c, h0r, h1r)[:, ::-1, ::-1])
    return np.ascontiguousarray(np.concatenate(stacks, axis=0))


def quad_afb2d_nonsep(x, h0a, h1a, h0b, h1b, mode="zero"):
    """Non-separable single-filtering variant of :func:`quad_afb2d`
    (reference: dtcwt/lowlevel2.py:374-441): all 16 tree/band filterings
    run as ONE strided 2-D filtering over outer-product PSFs (K14 with
    K = 16 on CUDA; backward its adjoint), then the same butterfly +
    quad-interleave epilogue."""
    f = prep_filt_quad_afb2d_nonsep(h0a, h1a, h0b, h1b)
    y = NonsepAFB.apply(x / 2, f, mode)          # (N, C, 16, H', W')
    return _quad_epilogue([y[:, :, 4 * t:4 * (t + 1)] for t in range(4)])
