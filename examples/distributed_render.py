"""Multi-device progressive rendering demo.

Shards the image by rows across every visible device (the GPUs of the
host; set ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` with
``JAX_PLATFORMS=cpu`` to try the mechanism on CPU, where the kernel part
needs ``--interpret``), keeps the accumulator sharded across frames (zero
per-frame collectives), and gathers once at the end for the PPM writes
(into the temporary directory).

    python examples/distributed_render.py
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/distributed_render.py --interpret
"""

import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from rt.dist import (gather_image, make_mesh, shard_scene, shard_state,
                     sharded_render_frame)
from rt.render.ppm import write_ppm
from rt.render.renderer import init_state
from rt.scene import scenes


def main():
    devices = jax.devices()
    n = len(devices)
    print(f"{n} device(s): {devices[0].platform}")

    sd = scenes.test_scene_metal(256, 64 * max(1, n))  # rows divisible by n
    sd = dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=4))

    mesh = make_mesh(devices)
    step = sharded_render_frame(mesh)
    scene = shard_scene(sd.scene, mesh)
    camera = shard_scene(sd.camera, mesh)
    state = shard_state(init_state(sd.config), mesh)

    for i in range(8):
        state = step(scene, camera, state, np.uint32(1000 + 10 * i),
                     sd.config)
    print("image sharding:", state.image.sharding)
    img = gather_image(state)
    out = os.path.join(tempfile.gettempdir(), "distributed.ppm")
    write_ppm(out, img)

    # ---- the kernel path under the same DP sharding ----------------------
    # shard_map runs the triangle kernel on each device's row band — zero
    # per-frame collectives (rt/dist/bands.py).
    from rt.dist.bands import sharded_band_frames

    tsd = scenes.scene_cube(256, 8 * n)
    tcfg = dataclasses.replace(tsd.config, bounces=3, backend="pallas",
                               interpret="--interpret" in sys.argv)
    frames = sharded_band_frames(mesh)
    wstate = shard_state(init_state(tcfg), mesh)
    wstate = frames(shard_scene(tsd.scene, mesh),
                    shard_scene(tsd.camera, mesh),
                    wstate, np.uint32(1000), np.uint32(10), tcfg, 4)
    print("kernel image sharding:", wstate.image.sharding)
    write_ppm(out.replace(".ppm", "_kernel.ppm"), gather_image(wstate))
    print(f"wrote {out} ({img.shape[1]}x{img.shape[0]}, "
          f"{int(state.frame_count)} frames)")


if __name__ == "__main__":
    main()
