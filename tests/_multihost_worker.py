"""Worker for the 2-process multi-host test (tests/test_multihost.py).

Each process joins a 2-process jax.distributed group (DCN-style coordination
over localhost) with 4 virtual CPU devices, renders 2 progressive frames of
a row-sharded 64x32 scene over the GLOBAL 8-device mesh, and asserts its
addressable row shards are BITWISE equal to a locally computed single-device
reference render — cross-process parity of the framework's DP axis
(SURVEY.md §5 "distributed communication backend").

Run:  python tests/_multihost_worker.py <port> <process_id>
"""

import dataclasses
import os
import sys
from functools import partial

port, pid = sys.argv[1], int(sys.argv[2])

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from rt.dist.sharding import multihost_init  # noqa: E402

multihost_init(f"localhost:{port}", 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()
assert len(jax.local_devices()) == 4, jax.local_devices()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rt.dist import sharding as sh  # noqa: E402
from rt.render.renderer import RenderState, init_state, render_frame  # noqa: E402
from rt.scene import scenes  # noqa: E402

sd = scenes.test_scene_metal(64, 32)          # H=32 = 8 devices x 4 rows
cfg = dataclasses.replace(sd.config, bounces=3)
mesh = sh.make_mesh()                         # global 8-device mesh (2 hosts)
img_s = sh.image_sharding(mesh)
rep_s = sh.replicated_sharding(mesh)

# Scene/camera enter as jit closure constants — replicated on every process
# without host->global-device transfers (both ranks build identical scenes).


@partial(jax.jit, out_shardings=RenderState(image=img_s, frame_count=rep_s))
def mk_state():
    return init_state(cfg)


@partial(jax.jit,
         out_shardings=RenderState(image=img_s, frame_count=rep_s))
def step(state, time):
    return render_frame(sd.scene, sd.camera, state, time, cfg)


state = mk_state()
for i in range(2):
    state = step(state, jnp.uint32(1000 + 10 * i))

# local single-device reference (the bit-exact oracle path)
ref = init_state(cfg)
for i in range(2):
    ref = render_frame(sd.scene, sd.camera, ref, jnp.uint32(1000 + 10 * i),
                       cfg)
ref_img = np.asarray(ref.image)

shards = state.image.addressable_shards
assert len(shards) == 4, len(shards)
for shard in shards:
    np.testing.assert_array_equal(np.asarray(shard.data),
                                  ref_img[shard.index])

assert int(state.frame_count.addressable_shards[0].data) == 2
print(f"rank {pid} OK ({len(shards)} row shards bitwise-equal)", flush=True)

# the kernel render path across the 2-process global mesh: each process
# shard_maps the triangle kernel (interpret mode) over its local row bands
# and the addressable shards must equal the local unsharded kernel render
# bitwise — the multi-process form of tests/test_dist_wave.py.
from rt.dist.bands import sharded_band_render_frames  # noqa: E402
from rt.kernels.dispatch import render_color as kernel_color  # noqa: E402

tsd = scenes.scene_cube(128, 64)
tcfg = dataclasses.replace(tsd.config, bounces=2, backend="pallas",
                           interpret=True)
times = jnp.asarray([1000], jnp.uint32)


@jax.jit
def wave_colors():
    return sharded_band_render_frames(tsd.scene, tsd.camera, tcfg, times,
                                      mesh)


colors = wave_colors()
ref_colors = np.asarray(kernel_color(tsd.scene, tsd.camera, tcfg,
                                     times[0], interpret=True))[None]
wshards = colors.addressable_shards
assert len(wshards) == 4, len(wshards)
for shard in wshards:
    np.testing.assert_array_equal(np.asarray(shard.data),
                                  ref_colors[shard.index])
print(f"rank {pid} wave OK ({len(wshards)} row shards bitwise-equal)",
      flush=True)

# scaling-measurement mechanism over the process group (rt/dist/scaling.py:
# measure_multihost) — numbers are not meaningful on shared host cores, but
# the collective harness itself must run and agree across ranks
from rt.dist.scaling import measure_multihost  # noqa: E402

rays = measure_multihost(dataclasses.replace(sd, config=cfg), frames=2,
                         warmup=1)
print(f"rank {pid} scaling mechanism OK ({rays:.3e} rays/s global)",
      flush=True)
