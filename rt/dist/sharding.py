"""Multi-chip image-plane sharding — the framework's data-parallel axis.

The reference is a single-process, single-GPU program (a lone wgpu queue,
src/renderer.rs:52-134); its only parallelism is one fragment-shader thread
per pixel.  The scaling design (SURVEY.md §2 parallelism table):

- **image-plane tile sharding** = the DP axis: the (H, W, 3) accumulator and
  every per-pixel intermediate are sharded by pixel rows across a 1-D
  ``jax.sharding.Mesh``; scene primitives (spheres / BVH / materials) and the
  camera are replicated.  Ray generation is position-based (iota + per-pixel
  RNG seeded from (x, y) — rt/core/camera.py), so XLA's SPMD partitioner
  splits the whole render graph spatially with **zero per-frame collectives**:
  each device traces only its rows and accumulates into its shard.
- cross-device communication happens in exactly two places (NVLink
  between the GPUs of one host):
  (1) final image assembly (an all-gather performed lazily on readback or
  explicitly via :func:`gather_image`), and (2) parameter-gradient psum in
  the differentiable path (rt/grad — inserted automatically by XLA when the
  scalar loss is reduced over the sharded pixel axis).
- multi-host: :func:`multihost_init` wraps ``jax.distributed.initialize``;
  the same NamedShardings then span hosts.

XLA collectives over the mesh are the communication backend (NCCL on
GPUs); nothing here calls a collective by hand.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rt.config import RenderConfig
from rt.render.renderer import RenderState, render_frame

AXIS = "tiles"


def make_mesh(devices=None, axis_name: str = AXIS) -> Mesh:
    """1-D device mesh over all (or the given) devices.

    Ray tracing has one big embarrassingly-parallel axis — pixels — so a 1-D
    mesh is the right shape; a 2-D (rows, cols) mesh adds nothing because
    there is no cross-pixel communication to localize.
    """
    if devices is None:
        devices = jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), (axis_name,))


def image_sharding(mesh: Mesh, axis_name: str = AXIS) -> NamedSharding:
    """Shard (H, W, 3) images by rows across the mesh."""
    return NamedSharding(mesh, P(axis_name, None, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(state: RenderState, mesh: Mesh) -> RenderState:
    """Place the progressive accumulator row-sharded, frame_count replicated."""
    return RenderState(
        image=jax.device_put(state.image, image_sharding(mesh)),
        frame_count=jax.device_put(state.frame_count, replicated_sharding(mesh)),
    )


def shard_scene(scene, mesh: Mesh):
    """Replicate scene primitives on every chip (they are small: ≤100 spheres
    / the Suzanne BVH is ~95 KB — the reference's own ceilings, SURVEY §6)."""
    return jax.device_put(scene, replicated_sharding(mesh))


def sharded_render_frame(mesh: Mesh, axis_name: str = AXIS):
    """Build a jitted render_frame whose output state keeps the image
    row-sharded — the compiled-once multi-chip render step.

    Height must be divisible by the mesh size (the driver pads otherwise);
    all per-pixel intermediates inherit the row sharding through XLA SPMD.
    """
    img_s = NamedSharding(mesh, P(axis_name, None, None))
    rep_s = NamedSharding(mesh, P())

    @partial(jax.jit, static_argnames=("config",),
             out_shardings=RenderState(image=img_s, frame_count=rep_s))
    def step(scene, camera, state: RenderState, time,
             config: RenderConfig) -> RenderState:
        return render_frame(scene, camera, state, time, config)

    return step


def gather_image(state: RenderState) -> jnp.ndarray:
    """Assemble the full image on the host — the all-gather the reference
    performs as a device→host map-read (src/scene/render_ppm.rs:12-36)."""
    return jax.device_get(state.image)


def sample_sharded_render(mesh: Mesh, axis_name: str = AXIS):
    """Sample-dimension parallelism (the TP/SP analog from SURVEY.md §2):
    every device traces the FULL frame at a different RNG time uniform and
    the results are averaged with one ``psum`` — a parallel version
    of the progressive loop's uniform average (EMA weights before
    saturation), for converged-render throughput.

    Returns step(scene, camera, times, config) -> (H, W, 3) mean color,
    where ``times`` is a (n_devices,) u32 array of time uniforms (one per
    device, e.g. 1000, 1010, ...).
    """
    from jax import shard_map

    from rt.render.renderer import render_color

    rep = P()

    def _mean(scene, camera, times, config: RenderConfig):
        def per_device(scene, camera, t):
            color = render_color(scene, camera, config, t[0])
            return jax.lax.pmean(color, axis_name)

        # check_vma=False: the closest-hit fori_loop seeds its carry with
        # literals (unvarying) and updates them with per-device values
        # (varying) — semantically fine, so skip the varying-axis check.
        return shard_map(
            per_device, mesh=mesh,
            in_specs=(rep, rep, P(axis_name)),
            out_specs=rep, check_vma=False)(scene, camera, times)

    return jax.jit(_mean, static_argnames=("config",))


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Join a multi-host process group (``jax.distributed``).

    No-op single-host; call before any jax op on a multi-host run.  XLA's
    collectives (NCCL on GPUs) then span every process's devices.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
