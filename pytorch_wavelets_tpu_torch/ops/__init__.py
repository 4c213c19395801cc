"""Filterbanks, operator products and the hand-written CUDA kernels that
run them.

The public filterbanks are the JAX package's ``ops`` names.  ``KERNELS``
lists every kernel wrapper; each keeps an integer ``launches`` count of
the times it launched its CUDA kernel (a CPU tensor takes the plain
PyTorch version and counts nothing).
"""
from pytorch_wavelets_tpu_torch.ops.afb_sfb import (  # noqa: F401
    afb1d, sfb1d, afb1d_atrous, sfb1d_atrous, afb2d, sfb2d,
    afb2d_atrous, sfb2d_atrous, afb2d_nonsep, sfb2d_nonsep,
    afb1d_atrous_adjoint, afb1d_atrous_corr, afb1d_corr, sfb1d_atrous_adjoint,
    sfb1d_atrous_conv, sfb1d_conv,
)
from pytorch_wavelets_tpu_torch.ops.banded import (  # noqa: F401
    apply_col, apply_row, set_operator_matmul,
)
from pytorch_wavelets_tpu_torch.ops.dtcwt_fb import (  # noqa: F401
    dtcwt_dfilt, dtcwt_filt, dtcwt_ifilt,
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
    scat_mag_bwd, scat_mag_fwd,
)

KERNELS = (apply_row, apply_col, q2c_pack, c2q_unpack, scat_mag_fwd,
           scat_mag_bwd, afb1d_corr, sfb1d_conv, dtcwt_filt, dtcwt_dfilt,
           dtcwt_ifilt, avg_pool2_fwd, avg_pool2_bwd, afb1d_atrous_corr,
           afb1d_atrous_adjoint, spec_merge, spec_split, nonsep_afb,
           nonsep_afb_adjoint, nonsep_sfb, nonsep_sfb_adjoint,
           sfb1d_atrous_conv, sfb1d_atrous_adjoint)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
