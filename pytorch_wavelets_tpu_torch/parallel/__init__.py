"""The distribution layer on ``torch.distributed``: device meshes, the
ring halo exchange (kernel K19), sharded operator applies on K1 and the
sharded DTCWT (port of ``pytorch_wavelets_tpu/parallel``; the other
sharded transforms are not ported yet, ``ROADMAP.md`` A5b-A5f)."""
from pytorch_wavelets_tpu_torch.parallel.mesh import (  # noqa: F401
    data_placements, initialize_multihost, make_mesh, placements,
    spatial_placements,
)
from pytorch_wavelets_tpu_torch.parallel.halo import (  # noqa: F401
    STAGED_BYTES, halo_exchange_1d, reset_staged_bytes,
)
from pytorch_wavelets_tpu_torch.parallel.sharded import (  # noqa: F401
    LAST_PATH, sharded_dtcwt2d, sharded_idtcwt2d,
)

__all__ = ["make_mesh", "data_placements", "spatial_placements",
           "placements", "initialize_multihost", "halo_exchange_1d",
           "STAGED_BYTES", "reset_staged_bytes", "sharded_dtcwt2d",
           "sharded_idtcwt2d", "LAST_PATH"]
