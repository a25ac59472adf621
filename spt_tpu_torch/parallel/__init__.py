"""Multi-device scaling: pixel-band sharding over a torch.distributed mesh."""

from spt_tpu_torch.parallel.sharding import (make_mesh, shard_pixels,
                                             sharded_frame_step,
                                             sharded_frame_step_dyn)

__all__ = ["make_mesh", "shard_pixels", "sharded_frame_step",
           "sharded_frame_step_dyn"]
