"""pytorch_wavelets_tpu_torch — the PyTorch/CUDA port of pytorch_wavelets_tpu.

A second package beside the JAX one (which stays the reference).  It
ports the DWT (``DWTForward`` / ``DWTInverse`` / ``DWT1DForward`` /
``DWT1DInverse``), the SWT with its exact inverse (``SWTForward`` /
``SWTInverse``), the DTCWT (``DTCWTForward`` / ``DTCWTInverse``) and the
scattering layers on it (``ScatLayer`` / ``ScatLayerj2``), forward and
backward, run on an NVIDIA
Hopper GPU through hand-written CUDA kernels (``csrc/``), or on the CPU
through their plain PyTorch versions with ``device="cpu"``.  Imports
neither JAX nor the JAX package.
"""
from pytorch_wavelets_tpu_torch._version import __version__  # noqa: F401
from pytorch_wavelets_tpu_torch.ops.precision import (  # noqa: F401
    set_matmul_precision, get_matmul_precision, matmul_precision,
)
from pytorch_wavelets_tpu_torch.models import (  # noqa: F401
    DWTForward, DWTInverse, DWT1DForward, DWT1DInverse, SWTForward,
    SWTInverse, DTCWTForward, DTCWTInverse, ScatLayer, ScatLayerj2,
)
from pytorch_wavelets_tpu_torch.models._base import (  # noqa: F401
    batch_chunked,
)

# Aliases matching the reference (reference __init__.py:27-36)
DWT = DWTForward
IDWT = DWTInverse
DWT2D = DWT
IDWT2D = IDWT
DWT1D = DWT1DForward
IDWT1D = DWT1DInverse
DTCWT = DTCWTForward
IDTCWT = DTCWTInverse

__all__ = [
    "DWTForward", "DWTInverse", "DWT1DForward", "DWT1DInverse",
    "SWTForward", "SWTInverse", "DTCWTForward", "DTCWTInverse",
    "ScatLayer", "ScatLayerj2",
    "DWT", "IDWT", "DWT2D", "IDWT2D", "DWT1D", "IDWT1D",
    "DTCWT", "IDTCWT",
    "set_matmul_precision", "get_matmul_precision", "matmul_precision",
    "batch_chunked", "__version__",
]
