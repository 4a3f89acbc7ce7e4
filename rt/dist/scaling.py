"""Scaling-efficiency benchmark harness — measures rays/s on 1..N devices
with the image row-sharded (the BASELINE target: ≥85% efficiency at 2
hosts).

On real GPUs this measures multi-device scaling; under
``--xla_force_host_platform_device_count`` it validates the mechanism (the
virtual devices share host cores, so efficiency numbers there are not
meaningful — the harness reports the topology it ran on).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import numpy as np

from rt.dist.sharding import (image_sharding, make_mesh, replicated_sharding,
                              shard_scene, shard_state, sharded_render_frame)
from rt.render.renderer import init_state


@dataclass
class ScalingResult:
    device_counts: list = field(default_factory=list)
    rays_per_s: list = field(default_factory=list)

    @property
    def efficiency(self) -> list:
        """Throughput per device relative to 1 device."""
        if not self.rays_per_s:
            return []
        base = self.rays_per_s[0] / self.device_counts[0]
        return [r / n / base for n, r in zip(self.device_counts,
                                            self.rays_per_s)]

    def summary(self) -> str:
        rows = [f"  {n} dev: {r:.3e} rays/s ({e:.1%} eff)"
                for n, r, e in zip(self.device_counts, self.rays_per_s,
                                   self.efficiency)]
        return "scaling:\n" + "\n".join(rows)


def measure_scaling(scene_def, device_counts=None, frames: int = 8,
                    warmup: int = 2) -> ScalingResult:
    """Render ``frames`` progressive frames on meshes of increasing size.

    The image height must be divisible by every device count (512 works for
    1..8).  Uses the batched render_frames step per mesh.
    """
    all_devices = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(all_devices)]
    res = ScalingResult()
    cfg = scene_def.config
    for n in device_counts:
        mesh = make_mesh(all_devices[:n])
        step = sharded_render_frame(mesh)
        scene = shard_scene(scene_def.scene, mesh)
        camera = shard_scene(scene_def.camera, mesh)
        state = shard_state(init_state(cfg), mesh)
        t = 1000
        for _ in range(warmup):
            state = step(scene, camera, state, np.uint32(t), cfg)
            t += 10
        jax.block_until_ready(state.image)
        t0 = time.perf_counter()
        for _ in range(frames):
            state = step(scene, camera, state, np.uint32(t), cfg)
            t += 10
        jax.block_until_ready(state.image)
        dt = time.perf_counter() - t0
        rays = cfg.width * cfg.height * cfg.samples_per_frame * frames
        res.device_counts.append(n)
        res.rays_per_s.append(rays / dt)
    return res


def measure_multihost(scene_def, frames: int = 4, warmup: int = 1) -> float:
    """Rays/s over the GLOBAL mesh under ``jax.distributed`` — the 2-host
    evidence mechanism for the ≥85%-at-2-hosts target (BASELINE.md).

    Call from EVERY process of the group (collective); returns the global
    throughput as seen by this process.  Timing is bracketed by
    cross-process barriers so ranks measure the same window; completion is
    forced with ``block_until_ready`` on the local shards.  Scene/camera
    are closed over as jit constants, so no host->global-device transfers
    are needed.  On virtual CPU devices the absolute numbers are not
    meaningful (shared host cores); on a real 2-host slice this is the
    scaling measurement.
    """
    from functools import partial

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from rt.render.renderer import RenderState, render_frame

    cfg = scene_def.config
    mesh = make_mesh()                  # all devices across all processes
    out_s = RenderState(image=image_sharding(mesh),
                        frame_count=replicated_sharding(mesh))

    @partial(jax.jit, out_shardings=out_s)
    def mk_state():
        return init_state(cfg)

    @partial(jax.jit, out_shardings=out_s)
    def step(state, time):
        return render_frame(scene_def.scene, scene_def.camera, state, time,
                            cfg)

    def force(state):
        for s in state.image.addressable_shards:
            jax.block_until_ready(s.data)

    state = mk_state()
    t = 1000
    for _ in range(warmup):
        state = step(state, jnp.uint32(t))
        t += 10
    force(state)
    multihost_utils.sync_global_devices("rt_scaling_start")
    t0 = time.perf_counter()
    for _ in range(frames):
        state = step(state, jnp.uint32(t))
        t += 10
    force(state)
    multihost_utils.sync_global_devices("rt_scaling_end")
    dt = time.perf_counter() - t0
    rays = cfg.width * cfg.height * cfg.samples_per_frame * frames
    return rays / dt
