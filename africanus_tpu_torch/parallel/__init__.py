from africanus_tpu_torch.parallel.mesh import (
    make_mesh,
    row_sharding,
    replicated,
    shard_rows,
    pad_rows,
)
from africanus_tpu_torch.parallel.predict import (
    sharded_im_to_vis,
    sharded_vis_to_im,
    sharded_rime_predict,
)
from africanus_tpu_torch.parallel.imaging import (
    sharded_degrid, sharded_dirty, sharded_pp_degridder, sharded_pp_gridder,
    sharded_residual, sharded_psf,
)
from africanus_tpu_torch.parallel.calibration import (
    sharded_gauss_newton,
    sharded_residual_vis,
)
from africanus_tpu_torch.parallel.chunked import stream_rows
from africanus_tpu_torch.parallel.averaging import (
    sharded_bda, ShardedBdaOutput, sharded_time_and_channel, ShardedTcOutput,
)

__all__ = [
    "stream_rows",
    "sharded_bda",
    "ShardedBdaOutput",
    "sharded_time_and_channel",
    "ShardedTcOutput",
    "sharded_degrid",
    "sharded_residual",
    "make_mesh",
    "row_sharding",
    "replicated",
    "shard_rows",
    "pad_rows",
    "sharded_im_to_vis",
    "sharded_vis_to_im",
    "sharded_rime_predict",
    "sharded_dirty",
    "sharded_psf",
    "sharded_pp_gridder",
    "sharded_pp_degridder",
    "sharded_residual_vis",
    "sharded_gauss_newton",
]
