"""Functional DTCWT transforms (composed whole-transform path)."""
from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (  # noqa: F401
    dtcwt2d, idtcwt2d, dtcwt_fwd_filters, dtcwt_inv_filters,
)
