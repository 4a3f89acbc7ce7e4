"""Image-row DP sharding of the kernel render path.

``rt/dist/sharding.py`` shards the oracle render graph by letting XLA's SPMD
partitioner split the per-pixel math.  A Pallas kernel is one opaque call,
so the partitioner cannot split it; instead ``shard_map`` runs the kernel
on each device over its own row band, with the scene tables replicated.
Ray generation is purely position-based (seed = (x*height + y)*time, uv
from global (x, y) — rt/kernels/tracer_common.generate_rays), so a band
launch with ``row0 = shard_index * band_height`` produces bit-identical
rays to the same rows of the full-frame launch, and the sharded image
equals the single-device render bitwise (tests/test_dist_wave.py).

Collectives: none during rendering; the only cross-device traffic is the
lazy all-gather on host readback — the same as the oracle DP path.
Triangle scenes only: the sphere kernels take no row offset.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rt.config import MAT_DIELECTRIC, MAT_METAL, RenderConfig
from rt.dist.sharding import AXIS
from rt.render.renderer import RenderState

__all__ = ["sharded_band_render_frames", "sharded_band_step",
           "sharded_band_frames"]


def _band_height(config: RenderConfig, n_shards: int) -> int:
    if config.height % n_shards:
        raise ValueError(f"height {config.height} not divisible by "
                         f"{n_shards} shards")
    return config.height // n_shards


def _band_color(scene, cam_row, time, axis_name, band_h,
                config: RenderConfig):
    """(band_h, width, 3) color of this shard's row band for one time."""
    from rt.kernels.dispatch import TRIS_UNROLL, block_grid
    from rt.kernels.tris_kernel import render_color_tris

    row0 = jax.lax.axis_index(axis_name).astype(jnp.int32) * band_h
    color = render_color_tris(
        scene, cam_row, jnp.asarray(time, jnp.uint32).reshape(1, 1),
        height=config.height, width=config.width, bounces=config.bounces,
        normalize_defocus_dir=config.normalize_defocus_dir,
        normalize_reflect_in=config.normalize_reflect_in, chunk=32,
        unroll=TRIS_UNROLL, has_metal=MAT_METAL in config.mat_kinds,
        has_dielectric=MAT_DIELECTRIC in config.mat_kinds,
        sky_from_final_dir=config.sky_from_final_dir,
        spp=config.samples_per_frame, row0=row0,
        interpret=config.interpret, **block_grid(band_h, config.width))
    return jnp.transpose(color, (1, 2, 0))[:band_h, :config.width]


def sharded_band_render_frames(scene, camera, config: RenderConfig, times,
                               mesh: Mesh, axis_name: str = AXIS):
    """(F, H, W, 3) colors for F frames, image rows sharded over ``mesh`` —
    bitwise equal to F single-device ``rt.kernels.dispatch.render_color``
    calls."""
    from rt.kernels.dispatch import pack_camera

    band_h = _band_height(config, mesh.shape[axis_name])

    def per_shard(scene, cam_row, times):
        return jax.lax.map(
            lambda t: _band_color(scene, cam_row, t, axis_name, band_h,
                                  config), times)

    return shard_map(
        per_shard, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=P(None, axis_name, None, None),
        # the kernels' fori_loops seed carries with literals (unvarying)
        # and update them with per-shard values — semantically fine
        check_vma=False)(scene, pack_camera(camera),
                         jnp.asarray(times, jnp.uint32).reshape(-1))


def _step_graph(scene, camera, state: RenderState, time,
                config: RenderConfig, *, axis_name: str, mesh: Mesh):
    """Un-jitted sharded progressive step: trace every shard's row band and
    EMA-accumulate into its image shard (shader_sphere.wgsl:266-271
    semantics, identical to render_frame); frame_count stays replicated."""
    from rt.core.vecmath import mix
    from rt.kernels.dispatch import pack_camera

    band_h = _band_height(config, mesh.shape[axis_name])

    def per_shard(scene, cam_row, img, fc, time):
        color = _band_color(scene, cam_row, time, axis_name, band_h, config)
        fcm = jnp.minimum(fc, jnp.uint32(config.sample_frame))
        w = 1.0 / (fcm.astype(jnp.float32) + 1.0)
        return mix(img, color, w), fc + 1

    rep = P()
    img, fc = shard_map(
        per_shard, mesh=mesh,
        in_specs=(rep, rep, P(axis_name, None, None), rep, rep),
        out_specs=(P(axis_name, None, None), rep),
        check_vma=False)(scene, pack_camera(camera), state.image,
                         state.frame_count, jnp.asarray(time, jnp.uint32))
    return RenderState(image=img, frame_count=fc)


def sharded_band_step(mesh: Mesh, axis_name: str = AXIS):
    """Jitted progressive step on the kernel path with the accumulator
    row-sharded: step(scene, camera, state, time, config) -> RenderState.
    Each device traces its rows and EMA-accumulates into its image shard;
    frame_count stays replicated.  Zero per-frame collectives."""
    img_s = NamedSharding(mesh, P(axis_name, None, None))
    rep_s = NamedSharding(mesh, P())

    @partial(jax.jit, static_argnames=("config",),
             out_shardings=RenderState(image=img_s, frame_count=rep_s))
    def step(scene, camera, state: RenderState, time,
             config: RenderConfig) -> RenderState:
        return _step_graph(scene, camera, state, time, config,
                           axis_name=axis_name, mesh=mesh)

    return step


def sharded_band_frames(mesh: Mesh, axis_name: str = AXIS):
    """Jitted multi-frame progressive loop on the sharded kernel path:
    frames(scene, camera, state, time0, time_step, config, n_frames) ->
    RenderState — the multi-device analog of
    rt.render.renderer.render_frames (a lax.scan of the sharded step, one
    compiled call per batch), which ``rt.cli --sharded --backend pallas``
    drives."""
    img_s = NamedSharding(mesh, P(axis_name, None, None))
    rep_s = NamedSharding(mesh, P())

    @partial(jax.jit, static_argnames=("config", "n_frames"),
             out_shardings=RenderState(image=img_s, frame_count=rep_s))
    def frames(scene, camera, state: RenderState, time0, time_step,
               config: RenderConfig, n_frames: int) -> RenderState:
        time0 = jnp.asarray(time0, jnp.uint32)
        time_step = jnp.asarray(time_step, jnp.uint32)

        def body(st, i):
            return _step_graph(scene, camera, st, time0 + i * time_step,
                               config, axis_name=axis_name,
                               mesh=mesh), None

        st, _ = jax.lax.scan(body, state,
                             jnp.arange(n_frames, dtype=jnp.uint32))
        return st

    return frames
