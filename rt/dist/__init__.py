from rt.dist.sharding import (gather_image, image_sharding, make_mesh,
                              multihost_init, replicated_sharding,
                              shard_scene, shard_state, sharded_render_frame)
from rt.dist.bands import (sharded_band_frames, sharded_band_render_frames,
                           sharded_band_step)

__all__ = [
    "make_mesh", "image_sharding", "replicated_sharding", "shard_state",
    "shard_scene", "sharded_render_frame", "gather_image", "multihost_init",
    "sharded_band_render_frames", "sharded_band_step", "sharded_band_frames",
]
