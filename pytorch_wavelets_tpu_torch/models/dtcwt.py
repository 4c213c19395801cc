"""DTCWT modules (port of ``pytorch_wavelets_tpu/models/dtcwt.py``;
reference: pytorch_wavelets/dtcwt/transform2d.py)."""
from __future__ import annotations

from pytorch_wavelets_tpu_torch.models._base import (
    _TapsModule, batch_chunked, canon_dtype, cast_bands, resolve_chunk,
    upcast_bands, warn_chunk_dropped,
)
from pytorch_wavelets_tpu_torch.parallel.sharded import (
    sharded_dtcwt2d, sharded_idtcwt2d,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (
    dtcwt2d, dtcwt_fwd_filters, dtcwt_inv_filters, idtcwt2d,
)

__all__ = ["DTCWTForward", "DTCWTInverse"]


def _batch_leading(m):
    """Every coefficient of module ``m``'s layout keeps the batch on axis
    0 (chunking needs it; o_dim or ri_dim 0 breaks it)."""
    return m.o_dim % 6 != 0 and m.ri_dim % 6 != 0


class DTCWTForward(_TapsModule):
    """2-D dual-tree complex wavelet forward transform (reference
    DTCWTForward, dtcwt/transform2d.py:20-147).

    Args:
        biort: level-1 filter name ('antonini', 'legall', 'near_sym_a',
            'near_sym_b') or a (h0o, h1o) tuple of arrays.
        qshift: level>=2 filter name ('qshift_06', 'qshift_a', 'qshift_b',
            'qshift_c', 'qshift_d') or a (h0a, h0b, h1a, h1b) tuple.
        J: number of levels.
        skip_hps: bool or per-level list — skip bandpass computation.
        include_scale: bool or per-level list — also return lowpasses.
        o_dim / ri_dim: where orientations and real/imag land.
        mode: boundary mode for level 1 ('symmetric' forced at J>=2).
        coeff_dtype: optional storage dtype for the bandpass pyramid
            (e.g. 'bfloat16'); the transform computes in fp32 and only
            the returned yh is narrowed.  DTCWTInverse upcasts.
        batch_chunk: run the transform over leading-axis chunks of
            this many images, one after another, and concatenate
            (models/_base.py:batch_chunked; a layout that does not keep
            the batch on axis 0 runs unchunked, with a warning).  None
            (the JAX package's auto default) and False/0 are off: the
            JAX thresholds are TPU v5e measurements.
        device: 'cuda' (default; raises without CUDA) or 'cpu' for the
            plain PyTorch path.  Inputs must be on this device.
        mesh: a ``DeviceMesh`` (``parallel.make_mesh``): the transform
            runs sharded on it (``parallel/sharded.py:sharded_dtcwt2d``),
            the batch over 'data', W over 'spatial' (H over 'spatial_h'),
            and returns DTensors; ``batch_chunk`` is then dropped with a
            warning.
    Call: x (N, C, H, W) -> (yl, yh); yh[j] has shape
    (N, C, 6, H_j, W_j, 2) for the default dims.  Skipped levels give None.
    On CUDA the transform and its backward run the hand-written kernels
    (ops/fused_dtcwt.py), and so do second-order gradients (backward
    through ``torch.autograd.grad(..., create_graph=True)``).
    """

    _SHARDED = True

    def __init__(self, biort="near_sym_a", qshift="qshift_a", J=3,
                 skip_hps=False, include_scale=False, o_dim=2, ri_dim=-1,
                 mode="symmetric", mesh=None, coeff_dtype=None,
                 batch_chunk=None, device="cuda"):
        if o_dim % 6 == ri_dim % 6:
            raise ValueError("Orientations and real/imaginary parts must be "
                             "in different dimensions.")
        super().__init__(dtcwt_fwd_filters(biort, qshift), device, mesh,
                         batch_chunk)
        self.biort = biort if isinstance(biort, str) else "custom"
        self.qshift = qshift if isinstance(qshift, str) else "custom"
        self.J = J
        self.skip_hps = skip_hps
        self.include_scale = include_scale
        self.o_dim = o_dim
        self.ri_dim = ri_dim
        self.mode = mode
        self.coeff_dtype = canon_dtype(coeff_dtype)

    def _single(self, x):
        yl, yh = dtcwt2d(x, self._filters, J=self.J, skip_hps=self.skip_hps,
                         include_scale=self.include_scale, o_dim=self.o_dim,
                         ri_dim=self.ri_dim, mode=self.mode)
        if self.coeff_dtype is not None and yh is not None:  # J=0: yh None
            yh = cast_bands(yh, self.coeff_dtype)
        return yl, yh

    def forward(self, x):
        self._check_device(x)
        if self.mesh is not None:
            if self.batch_chunk:
                warn_chunk_dropped("DTCWTForward",
                                   "mesh= sharded path does not chunk")
            yl, yh = sharded_dtcwt2d(
                x, self.mesh, self._filters, J=self.J, mode=self.mode,
                skip_hps=self.skip_hps, include_scale=self.include_scale,
                o_dim=self.o_dim, ri_dim=self.ri_dim)
            if self.coeff_dtype is not None:
                yh = cast_bands(yh, self.coeff_dtype)
            return yl, yh
        chunk = resolve_chunk(self.batch_chunk, x.shape[0],
                              x.shape[-2] * x.shape[-1], x.numel())
        if chunk and _batch_leading(self):
            return batch_chunked(self._single, x, chunk)
        if self.batch_chunk and not _batch_leading(self):
            warn_chunk_dropped("DTCWTForward",
                               "o_dim/ri_dim layout is not batch-leading")
        return self._single(x)


class DTCWTInverse(_TapsModule):
    """2-D DTCWT inverse (reference DTCWTInverse,
    dtcwt/transform2d.py:150-254).

    Call: (yl, yh) -> x.  None entries (lowpass or any bandpass) are
    treated as zeros.  ``device``, ``mesh`` and ``batch_chunk`` as for
    :class:`DTCWTForward` (the chunks upcast their own bands; with
    ``mesh`` the coefficients are DTensors or full tensors, the lowpass
    and every level's bands present:
    ``parallel/sharded.py:sharded_idtcwt2d``)."""

    _SHARDED = True

    def __init__(self, biort="near_sym_a", qshift="qshift_a", o_dim=2,
                 ri_dim=-1, mode="symmetric", mesh=None, batch_chunk=None,
                 device="cuda"):
        super().__init__(dtcwt_inv_filters(biort, qshift), device, mesh,
                         batch_chunk)
        self.biort = biort if isinstance(biort, str) else "custom"
        self.qshift = qshift if isinstance(qshift, str) else "custom"
        self.o_dim = o_dim
        self.ri_dim = ri_dim
        self.mode = mode

    def _single(self, coeffs):
        yl, yh = coeffs
        if yh is not None:
            yh = upcast_bands(yh, yl)
        return idtcwt2d((yl, yh), self._filters, o_dim=self.o_dim,
                        ri_dim=self.ri_dim, mode=self.mode)

    def forward(self, coeffs):
        yl, yh = coeffs
        self._check_device(yl, *(yh or ()))
        if self.mesh is not None:
            if self.batch_chunk:
                warn_chunk_dropped("DTCWTInverse",
                                   "mesh= sharded path does not chunk")
            if yh is not None:
                yh = upcast_bands(yh, yl)
            return sharded_idtcwt2d((yl, yh), self.mesh, self._filters,
                                    mode=self.mode, o_dim=self.o_dim,
                                    ri_dim=self.ri_dim)
        chunk = resolve_chunk(self.batch_chunk, 0, 0, 0)
        if chunk and _batch_leading(self):
            return batch_chunked(self._single, coeffs, chunk)
        if self.batch_chunk and not _batch_leading(self):
            warn_chunk_dropped("DTCWTInverse",
                               "o_dim/ri_dim layout is not batch-leading")
        return self._single(coeffs)
