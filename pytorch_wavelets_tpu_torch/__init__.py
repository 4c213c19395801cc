"""pytorch_wavelets_tpu_torch — the PyTorch/CUDA port of pytorch_wavelets_tpu.

A second package beside the JAX one (which stays the reference).  It
ports the DTCWT's composed whole-transform path and the scattering layers
on it: ``DTCWTForward`` / ``DTCWTInverse`` and ``ScatLayer`` /
``ScatLayerj2``, forward and backward, run on an NVIDIA Hopper GPU through
hand-written CUDA kernels (``csrc/``), or on the CPU through their plain
PyTorch versions with ``device="cpu"``.  Imports neither JAX nor the JAX
package.
"""
from pytorch_wavelets_tpu_torch._version import __version__  # noqa: F401
from pytorch_wavelets_tpu_torch.ops.precision import (  # noqa: F401
    set_matmul_precision, get_matmul_precision, matmul_precision,
)
from pytorch_wavelets_tpu_torch.models import (  # noqa: F401
    DTCWTForward, DTCWTInverse, ScatLayer, ScatLayerj2,
)

DTCWT = DTCWTForward
IDTCWT = DTCWTInverse

__all__ = [
    "DTCWTForward", "DTCWTInverse", "DTCWT", "IDTCWT", "ScatLayer",
    "ScatLayerj2",
    "set_matmul_precision", "get_matmul_precision", "matmul_precision",
    "__version__",
]
