"""Scattering layer modules (port of ``pytorch_wavelets_tpu/models/
scatternet.py``; reference: pytorch_wavelets/scatternet/layers.py)."""
from __future__ import annotations

from pytorch_wavelets_tpu_torch.filters import biort as _biort
from pytorch_wavelets_tpu_torch.filters import qshift as _qshift
from pytorch_wavelets_tpu_torch.models._base import (
    _TapsModule, batch_chunked, resolve_scat_chunk, warn_chunk_dropped,
)
from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import prep_taps
from pytorch_wavelets_tpu_torch.parallel.sharded_scat import (
    sharded_scat_j1, sharded_scat_j2,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import _tup
from pytorch_wavelets_tpu_torch.transforms.scatternet import (
    scat_layer_j1, scat_layer_j2,
)

__all__ = ["ScatLayer", "ScatLayerj2"]


def _filters(pairs):
    return {name: _tup(prep_taps(taps)) for name, taps in pairs}


class ScatLayer(_TapsModule):
    """One order of DTCWT scattering at a single scale (reference ScatLayer,
    scatternet/layers.py:11-79).

    Call: x (N, C, H, W) -> (N, 7C, H/2, W/2) with the first C channels the
    lowpass and the next 6C the oriented magnitudes (or (N, 9, ...) when
    combine_colour).  Differentiable: on CUDA the forward and backward run
    the hand-written kernels (the composed pyramid K1-K3, or with
    ``biort="near_sym_b_bp"`` the bandpass-diagonal per-level path
    K8/K10, K2/K3 and the pool K11; the magnitudes K4/K5).

    Second-order gradients run them too, the magnitude's through K18.

    ``device``: 'cuda' (default; raises without CUDA) or 'cpu' for the
    plain PyTorch path.  ``batch_chunk``: run the layer over leading-axis
    chunks of this many images, one after another, and concatenate
    (models/_base.py:batch_chunked); None and False/0 are off.
    ``mesh``: a ``DeviceMesh`` (``parallel.make_mesh``): the layer runs
    sharded on it (``parallel/sharded_scat.py:sharded_scat_j1``), the
    batch over 'data', W over 'spatial' (H over 'spatial_h'), and returns
    a DTensor (the bandpass-diagonal filters on the stencil halo route,
    ``parallel/sharded_conv.py``); ``batch_chunk`` is then dropped with a
    warning.
    """


    def __init__(self, biort="near_sym_a", mode="symmetric", magbias=1e-2,
                 combine_colour=False, mesh=None, batch_chunk=None,
                 device="cuda"):
        self.bandpass_diag = biort == "near_sym_b_bp"
        if self.bandpass_diag:
            h0o, _, h1o, _, h2o, _ = _biort(biort)
            pairs = (("h0o", h0o), ("h1o", h1o), ("h2o", h2o))
        else:
            h0o, _, h1o, _ = _biort(biort)
            pairs = (("h0o", h0o), ("h1o", h1o))
        super().__init__(_filters(pairs), device, mesh, batch_chunk)
        self.biort = biort
        self.mode = mode
        self.magbias = magbias
        self.combine_colour = combine_colour

    def forward(self, x):
        self._check_device(x)
        if self.mesh is not None:
            if self.batch_chunk:
                warn_chunk_dropped("ScatLayer",
                                   "mesh= sharded path does not chunk")
            return sharded_scat_j1(x, self.mesh, self._filters,
                                   mode=self.mode, magbias=self.magbias,
                                   combine_colour=self.combine_colour,
                                   bandpass_diag=self.bandpass_diag)
        return batch_chunked(
            lambda z: scat_layer_j1(z, self._filters, mode=self.mode,
                                    magbias=self.magbias,
                                    combine_colour=self.combine_colour,
                                    bandpass_diag=self.bandpass_diag),
            x, self.batch_chunk)


class ScatLayerj2(_TapsModule):
    """Two-scale second-order DTCWT scattering (reference ScatLayerj2,
    scatternet/layers.py:82-172).

    Call: x (N, C, H, W) -> (N, 49C, H/4, W/4) (or (N, 51, ...) when
    combine_colour).  ``device``, ``mesh`` and ``batch_chunk`` as for
    :class:`ScatLayer` (the sharded layer is
    ``parallel/sharded_scat.py:sharded_scat_j2``; H and W must be
    multiples of 8 there): None, the JAX package's auto default, is off
    here (its thresholds, models/_base.py ``_SCAT_*`` there, are TPU v5e
    measurements).
    """


    def __init__(self, biort="near_sym_a", qshift="qshift_a",
                 mode="symmetric", magbias=1e-2, combine_colour=False,
                 mesh=None, batch_chunk=None, device="cuda"):
        self.bandpass_diag = biort == "near_sym_b_bp"
        if self.bandpass_diag:
            if qshift != "qshift_b_bp":
                raise ValueError("near_sym_b_bp biort requires "
                                 "qshift_b_bp qshift filters")
            h0o, _, h1o, _, h2o, _ = _biort(biort)
            (h0a, h0b, _, _, h1a, h1b, _, _,
             h2a, h2b, _, _) = _qshift(qshift)
            pairs = (("h0o", h0o), ("h1o", h1o), ("h2o", h2o),
                     ("h0a", h0a), ("h0b", h0b), ("h1a", h1a), ("h1b", h1b),
                     ("h2a", h2a), ("h2b", h2b))
        else:
            h0o, _, h1o, _ = _biort(biort)
            h0a, h0b, _, _, h1a, h1b, _, _ = _qshift(qshift)
            pairs = (("h0o", h0o), ("h1o", h1o), ("h0a", h0a),
                     ("h0b", h0b), ("h1a", h1a), ("h1b", h1b))
        super().__init__(_filters(pairs), device, mesh, batch_chunk)
        self.biort = biort
        self.qshift = qshift
        self.mode = mode
        self.magbias = magbias
        self.combine_colour = combine_colour

    def forward(self, x):
        self._check_device(x)
        if self.mesh is not None:
            if self.batch_chunk:
                warn_chunk_dropped("ScatLayerj2",
                                   "mesh= sharded path does not chunk")
            return sharded_scat_j2(x, self.mesh, self._filters,
                                   mode=self.mode, magbias=self.magbias,
                                   combine_colour=self.combine_colour,
                                   bandpass_diag=self.bandpass_diag)
        chunk = resolve_scat_chunk(self.batch_chunk, x.shape[0],
                                   x[0].numel())
        return batch_chunked(
            lambda z: scat_layer_j2(z, self._filters, mode=self.mode,
                                    magbias=self.magbias,
                                    combine_colour=self.combine_colour,
                                    bandpass_diag=self.bandpass_diag),
            x, chunk)
