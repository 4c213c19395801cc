"""The distribution layer on ``torch.distributed``: device meshes, the
ring halo exchange (kernel K19), sharded operator applies on K1, the
sharded DTCWT, DWT, 1-D DWT, SWT and scattering layers, and batch data
parallelism for the Selesnick DTCWT (port of
``pytorch_wavelets_tpu/parallel``).  Where the JAX package falls to
GSPMD, the port runs one of its own routes (``LAST_PATH``): 'perlevel'
on zero-embedded storage, the ISWT's dense least-squares merge
('matmul', gathered per axis) or the stencil halo route ('conv',
``parallel/sharded_conv.py``)."""
from pytorch_wavelets_tpu_torch.parallel.mesh import (  # noqa: F401
    data_placements, initialize_multihost, make_mesh, placements,
    spatial_placements,
)
from pytorch_wavelets_tpu_torch.parallel.halo import (  # noqa: F401
    EXCHANGES, STAGED_BYTES, halo_exchange_1d, reset_exchanges,
    reset_staged_bytes,
)
from pytorch_wavelets_tpu_torch.parallel.sharded import (  # noqa: F401
    LAST_PATH, sharded_batch_apply, sharded_dtcwt2d, sharded_idtcwt2d,
)
from pytorch_wavelets_tpu_torch.parallel.sharded_dwt import (  # noqa: F401
    sharded_dwt1d, sharded_dwt2d, sharded_idwt1d, sharded_idwt2d,
    sharded_iswt2d, sharded_swt2d,
)
from pytorch_wavelets_tpu_torch.parallel.sharded_scat import (  # noqa: F401
    sharded_scat_j1, sharded_scat_j2,
)

__all__ = ["make_mesh", "data_placements", "spatial_placements",
           "placements", "initialize_multihost", "halo_exchange_1d",
           "STAGED_BYTES", "reset_staged_bytes", "EXCHANGES",
           "reset_exchanges", "sharded_dwt2d", "sharded_idwt2d",
           "sharded_dwt1d", "sharded_idwt1d", "sharded_swt2d",
           "sharded_iswt2d", "sharded_dtcwt2d", "sharded_idtcwt2d",
           "sharded_scat_j1", "sharded_scat_j2", "sharded_batch_apply",
           "LAST_PATH"]
