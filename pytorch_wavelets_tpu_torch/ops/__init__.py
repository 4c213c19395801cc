"""Filterbanks, operator products and the hand-written CUDA kernels that
run them.

The public filterbanks are the JAX package's ``ops`` names.  ``KERNELS``
lists every kernel wrapper; each keeps an integer ``launches`` count of
the times it launched its CUDA kernel (a CPU tensor takes the plain
PyTorch version and counts nothing).  K17 has one wrapper, and one count,
per entry and mode (``apply_col_tf32`` ... ``apply_row_bf16``), and K6,
K7, K12 and K16 have a second wrapper each for the sharded conv route's
windows (``afb1d_window`` / ``sfb1d_window`` / ``afb1d_atrous_window`` /
``sfb1d_atrous_window``), counted apart;
``apply_col`` / ``apply_row`` count K1's fp32 launches only.  K1's and
K17's wrappers also count their launches by instantiation (``copies``,
:func:`copy_counts`): the copy width their staging took, and for K1's
column entry its narrow 64-column tile.  K2's to K16's count theirs in
``instantiations``
(:func:`instantiation_counts`): K6's to K10's, K12's and K16's axis and
vector width (K6's and K7's per-output ``long_fold`` too), K14's and
K15's tiles (K14's PSF count), their adjoints' and K15's forward's edge
bands, K12's and K16's adjoints' edge bands, K2's, K3's, K4's, K5's,
K18's, K11's and K19's vector or strided access, K13's walk.
"""
from pytorch_wavelets_tpu_torch.ops.afb_sfb import (  # noqa: F401
    afb1d, sfb1d, afb1d_atrous, sfb1d_atrous, afb2d, sfb2d,
    afb2d_atrous, sfb2d_atrous, afb2d_nonsep, sfb2d_nonsep,
    afb1d_atrous_adjoint, afb1d_atrous_corr, afb1d_corr, sfb1d_atrous_adjoint,
    sfb1d_atrous_conv, sfb1d_conv, afb1d_window, sfb1d_window,
    afb1d_atrous_window, sfb1d_atrous_window,
)
from pytorch_wavelets_tpu_torch.ops.banded import (  # noqa: F401
    K17_WRAPPERS, apply_col, apply_row, set_operator_matmul,
)
from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import (  # noqa: F401
    dtcwt_dfilt, dtcwt_filt, dtcwt_ifilt,
)
from pytorch_wavelets_tpu_torch.ops.halo import (  # noqa: F401
    halo_assemble, halo_fold, halo_pack,
)
from pytorch_wavelets_tpu_torch.ops.iswt_merge import (  # noqa: F401
    spec_merge, spec_split,
)
from pytorch_wavelets_tpu_torch.ops.nonsep import (  # noqa: F401
    nonsep_afb, nonsep_afb_adjoint, nonsep_sfb, nonsep_sfb_adjoint,
)
from pytorch_wavelets_tpu_torch.ops.pool import (  # noqa: F401
    avg_pool2_bwd, avg_pool2_fwd,
)
from pytorch_wavelets_tpu_torch.ops.quad import (  # noqa: F401
    c2q_unpack, q2c_pack,
)
from pytorch_wavelets_tpu_torch.ops.scat_mag import (  # noqa: F401
    scat_mag_bwd, scat_mag_bwd2, scat_mag_fwd,
)

KERNELS = (apply_row, apply_col, q2c_pack, c2q_unpack, scat_mag_fwd,
           scat_mag_bwd, scat_mag_bwd2, afb1d_corr, sfb1d_conv, dtcwt_filt, dtcwt_dfilt,
           dtcwt_ifilt, avg_pool2_fwd, avg_pool2_bwd, afb1d_atrous_corr,
           afb1d_atrous_adjoint, spec_merge, spec_split, nonsep_afb,
           nonsep_afb_adjoint, nonsep_sfb, nonsep_sfb_adjoint,
           sfb1d_atrous_conv, sfb1d_atrous_adjoint, halo_pack,
           halo_assemble, halo_fold, afb1d_window, sfb1d_window,
           afb1d_atrous_window, sfb1d_atrous_window, *K17_WRAPPERS)


PRODUCT_KERNELS = (apply_row, apply_col, *K17_WRAPPERS)
STENCIL_VARIANT_KERNELS = (afb1d_corr, sfb1d_conv, dtcwt_filt, dtcwt_dfilt,
                           dtcwt_ifilt, afb1d_atrous_corr,
                           afb1d_atrous_adjoint, nonsep_afb,
                           nonsep_afb_adjoint, nonsep_sfb, nonsep_sfb_adjoint,
                           sfb1d_atrous_conv, sfb1d_atrous_adjoint,
                           scat_mag_fwd, scat_mag_bwd, scat_mag_bwd2,
                           q2c_pack, c2q_unpack,
                           avg_pool2_fwd, avg_pool2_bwd, spec_merge,
                           spec_split, halo_pack, halo_assemble, halo_fold,
                           afb1d_window, sfb1d_window, afb1d_atrous_window,
                           sfb1d_atrous_window)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in PRODUCT_KERNELS:
        k.copies = dict.fromkeys(k.copies, 0)
    for k in STENCIL_VARIANT_KERNELS:
        k.instantiations = dict.fromkeys(k.instantiations, 0)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def copy_counts() -> dict:
    """K1's and K17's launches by instantiation: {wrapper name:
    {"async16": n, "async4": n[, "load2": n][, "async16_narrow": n]}}
    (16- or 4-byte cp.async, plain 2-byte loads; ``async16_narrow``: K1's
    column entry in 64-column tiles)."""
    return {k.__name__: dict(k.copies) for k in PRODUCT_KERNELS}


def instantiation_counts() -> dict:
    """K4's to K10's, K12's and K14's to K16's launches by instantiation:
    {wrapper name: {name: n}}: K8's ``col_float4`` / ``col_scalar`` /
    ``row_async16`` / ``row_async4``; K6's, K7's, K9's, K10's, K12's and
    K16's ``col_float4`` / ``col_scalar`` / ``row_run`` / ``row_gather``,
    K6's and K7's ``long_fold`` (their per-output kernel, where
    'periodization' folds a filter longer than the axis or a tail longer
    than the output), and ``band`` where K12's or K16's
    adjoint adds its edge band's pad images; K14's forward ``k4`` /
    ``k16`` with its tile in output positions (``"k16 16x8"``), its
    adjoint ``poly k4`` / ``poly k16`` with its tile in pixels, ``band``
    (the gather adding the edge band's pad images) and ``gather`` (the
    whole plane, on the separable split's single fold); K15's forward
    ``poly`` with its tile in positions and ``band`` (the wrap-add's
    second positions), its adjoint ``staged`` with its tile; K4's, K5's
    and K18's ``vector`` (16-byte loads of plane-contiguous bands) /
    ``strided`` (any view through its strides); K2's ``vector`` (16-byte
    stores of the default band layout) / ``strided``, K3's ``vector``
    (16-byte loads of it) / ``strided``; K11's forward's and adjoint's
    ``vector`` (16-byte loads of rows at unit stride; 16-byte stores) /
    ``strided``; K13's ``stream``
    (16-byte pairs along the spectra's unit-stride axis) / ``strided``;
    K19's three entries' ``vector`` (16-byte stores and runs along W of
    tiles and windows at unit stride along W) / ``strided``."""
    return {k.__name__: dict(k.instantiations)
            for k in STENCIL_VARIANT_KERNELS}
