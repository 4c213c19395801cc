"""Functional DWT, SWT, DTCWT and scattering transforms, and the
Selesnick DTCWT (``dtcwt_alt``)."""
from pytorch_wavelets_tpu_torch.transforms.dwt import (  # noqa: F401
    dwt2d, idwt2d, dwt1d, idwt1d, swt2d, iswt2d, dec_filters, rec_filters,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (  # noqa: F401
    dtcwt2d, idtcwt2d, dtcwt_fwd_filters, dtcwt_inv_filters,
)
from pytorch_wavelets_tpu_torch.transforms.scatternet import (  # noqa: F401
    scat_layer_j1, scat_layer_j2,
)
from pytorch_wavelets_tpu_torch.transforms.dtcwt_alt import (  # noqa: F401
    cplxdual2d, icplxdual2d, DTCWTForward2, DTCWTInverse2,
)
