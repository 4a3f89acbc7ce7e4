"""Kernel dispatch: pack scene/camera pytrees into kernel operand layouts,
pad the image to tile multiples, launch, and crop — the host↔kernel ABI
layer (the analog of the reference's bind-group packing in
src/renderer.rs:139-240).
"""

from __future__ import annotations

import jax.numpy as jnp

from rt.config import RenderConfig
from rt.core.sphere import SphereArray
from rt.core.triangle import TriangleScene
from rt.kernels.tracer_common import (CAM_BLUR, CAM_DIR, CAM_EYE, CAM_FL,
                                      CAM_FOV, CAM_RIGHT, CAM_UP, CAM_WIDTH)


# One Triton program traces a (th, tw) block of pixels with num_warps warps
# (th * tw == 32 * num_warps is one ray per thread).  Powers of two, as
# Triton wants.  One warp of 4x8 rays was the fastest block for every
# kernel in the sweep on the H100 (tools/sweep_blocks.py, PERF.md): the
# chunk culling decides per block, and a smaller block culls more.
BLOCK = (4, 8, 1)
# Triangles scanned per loop iteration inside a live chunk (same ascending
# order at any value — bit-identical); 8 was among the fastest on the
# H100 (4 ties it; 16 and 1 lose — PERF.md).
TRIS_UNROLL = 8


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def block_grid(h: int, w: int, block=BLOCK) -> dict:
    """Kernel tiling for an h x w image: the block shape, the warp count
    and the padded extent the grid covers (the kernels crop back to h, w).
    Padding is at most th - 1 rows and tw - 1 columns."""
    th, tw, num_warps = block
    return dict(th=th, tw=tw, num_warps=num_warps,
                height_pad=_round_up(h, th), width_pad=_round_up(w, tw))


def pack_camera(camera) -> jnp.ndarray:
    row = jnp.zeros((1, CAM_WIDTH), jnp.float32)
    row = row.at[0, CAM_EYE:CAM_EYE + 4].set(camera.eye)
    row = row.at[0, CAM_DIR:CAM_DIR + 4].set(camera.direction)
    row = row.at[0, CAM_UP:CAM_UP + 4].set(camera.up)
    row = row.at[0, CAM_RIGHT:CAM_RIGHT + 4].set(camera.right)
    row = row.at[0, CAM_FL].set(camera.focal_length)
    row = row.at[0, CAM_BLUR].set(camera.focal_blur)
    row = row.at[0, CAM_FOV].set(camera.fov)
    return row


def pack_spheres_table(scene: SphereArray):
    n = scene.count
    tab = jnp.concatenate([
        scene.center.astype(jnp.float32),
        scene.radius.astype(jnp.float32)[:, None],
        scene.albedo.astype(jnp.float32),
        scene.mat_param.astype(jnp.float32)[:, None],
    ], axis=1)                                   # (N, 8)
    kinds = scene.mat_kind.astype(jnp.int32)[:, None]
    return tab, kinds, n


def render_color(scene, camera, config: RenderConfig, time,
                 interpret: bool = False):
    """(H, W, 3) color for one frame via the fused Pallas kernels.

    Drop-in replacement for rt.render.renderer.render_color — same RNG
    stream, same math, same output (validated bit-level in tests).
    """
    # samples_per_frame (SAMPLE_PER_FRAME, shader_sphere.wgsl:11) is an
    # in-kernel sample loop: the same primary ray re-traced spp times with
    # the RNG state threaded across samples, then averaged — bit-equal to
    # the oracle renderer's loop (rt/render/renderer.py:63-70).
    spp = config.samples_per_frame
    h, w = config.height, config.width
    grid = block_grid(h, w)
    hp, wp = grid["height_pad"], grid["width_pad"]

    cam_row = pack_camera(camera)
    time_arr = jnp.asarray(time, jnp.uint32).reshape(1, 1)
    from rt.config import MAT_DIELECTRIC, MAT_METAL
    has_metal = MAT_METAL in config.mat_kinds
    has_dielectric = MAT_DIELECTRIC in config.mat_kinds

    if isinstance(scene, SphereArray):
        tab, kinds, n = pack_spheres_table(scene)
        if 0 < config.n_active_spheres < n:
            n = config.n_active_spheres
        if n > 128:
            # Past the reference's 100-sphere cap (scene_sphere.rs:15) a
            # flat scan pays O(N) per segment — the Morton-chunk-culled
            # variant (slab-tested chunks of 32, front-to-back, as in the
            # triangle path) replaces it for large scenes like the ~490-
            # sphere RTIOW cover (BASELINE config 3).  Reordering only
            # affects measure-zero exact-t ties (strict t < best).
            from rt.kernels.sphere_kernel import render_color_spheres_chunked
            color = render_color_spheres_chunked(
                tab, kinds, cam_row, time_arr, n_spheres=n, height=h,
                width=w, bounces=config.bounces,
                normalize_defocus_dir=config.normalize_defocus_dir,
                normalize_reflect_in=config.normalize_reflect_in,
                has_metal=has_metal, has_dielectric=has_dielectric,
                sky_from_final_dir=config.sky_from_final_dir,
                spp=spp, interpret=interpret, **grid)
        else:
            from rt.kernels.sphere_kernel import render_color_spheres
            color = render_color_spheres(
                tab, kinds, cam_row, time_arr, n_spheres=n, height=h,
                width=w, bounces=config.bounces,
                normalize_defocus_dir=config.normalize_defocus_dir,
                normalize_reflect_in=config.normalize_reflect_in,
                has_metal=has_metal, has_dielectric=has_dielectric,
                sky_from_final_dir=config.sky_from_final_dir,
                unroll_all=n <= 32, spp=spp, interpret=interpret, **grid)
    elif isinstance(scene, TriangleScene):
        from rt.kernels.tris_kernel import render_color_tris
        color = render_color_tris(
            scene, cam_row, time_arr, height=h, width=w,
            bounces=config.bounces,
            normalize_defocus_dir=config.normalize_defocus_dir,
            normalize_reflect_in=config.normalize_reflect_in,
            chunk=32, unroll=TRIS_UNROLL, has_metal=has_metal,
            has_dielectric=has_dielectric,
            sky_from_final_dir=config.sky_from_final_dir,
            spp=spp, interpret=interpret, **grid)
    else:
        raise TypeError(f"unknown scene type {type(scene)}")

    color = jnp.transpose(color, (1, 2, 0))      # (Hp, Wp, 3)
    if (hp, wp) != (h, w):
        color = color[:h, :w]
    return color
