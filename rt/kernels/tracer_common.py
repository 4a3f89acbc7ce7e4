"""Shared in-kernel tracer stages: camera ray generation, material scatter,
sky — plane-form ports of rt/core/{camera,materials,trace}.py (which in turn
replicate shader_sphere.wgsl fs_main/make_ray/scatter/trace).  The math here
must stay op-for-op identical to the oracle so the Pallas backend can be
validated against it exactly.

Camera scalars arrive as a (1, CAM_WIDTH) row ``cam_ref`` with layout:
  [0:4) eye  [4:8) direction  [8:12) up  [12:16) right
  [16] focal_length  [17] focal_blur  [18] fov
(the reference's 80-byte CameraUniform, src/camera_controller.rs:136-147).

Every kernel goes through ``frame_call``: the Pallas Triton route, one
program per (th, tw) block of rays, scene tables passed whole and read with
uniform scalar loads that the L1 cache serves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from rt.kernels import plane_math as pm

CAM_EYE, CAM_DIR, CAM_UP, CAM_RIGHT = 0, 4, 8, 12
CAM_FL, CAM_BLUR, CAM_FOV = 16, 17, 18
CAM_WIDTH = 20  # camera row length (padded)


def whole(x) -> pl.BlockSpec:
    """BlockSpec handing the kernel the whole array (scene tables, camera,
    time uniform) in global memory."""
    return pl.BlockSpec(x.shape, lambda *_: (0,) * len(x.shape))


def any_lane(mask):
    """Block-wide OR of a bool plane — the skip test in front of a scan.
    Triton lowers no boolean reduction, so it is an i32 max."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def frame_call(kernel, operands, *, height_pad: int, width_pad: int,
               th: int, tw: int, num_warps: int, interpret: bool,
               record_bounces: int = 0):
    """Launch a whole-frame kernel on the Triton route, one program per
    (th, tw) pixel block (``num_stages=1``: the kernels stream no tiles,
    so there is nothing to pipeline).  ``operands`` go in whole; the output
    is the planar (3, Hp, Wp) color, plus the (record_bounces, Hp, Wp) i32
    hit ids when ``record_bounces`` > 0 (the recorders)."""
    out_shape = [jax.ShapeDtypeStruct((3, height_pad, width_pad),
                                      jnp.float32)]
    out_specs = [pl.BlockSpec((3, th, tw), lambda i, j: (0, i, j))]
    if record_bounces:
        out_shape.append(jax.ShapeDtypeStruct(
            (record_bounces, height_pad, width_pad), jnp.int32))
        out_specs.append(pl.BlockSpec((record_bounces, th, tw),
                                      lambda i, j: (0, i, j)))
    out = pl.pallas_call(
        kernel, out_shape=tuple(out_shape),
        grid=(height_pad // th, width_pad // tw),
        in_specs=[whole(x) for x in operands], out_specs=tuple(out_specs),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret)(*operands)
    return out if record_bounces else out[0]


def pixel_coords(ti, tj, *, th: int, tw: int, row0=0):
    """(x, y) i32 planes of block (ti, tj); ``row0`` offsets the rows (a
    row band of a larger image renders bit-identical rays)."""
    y_i = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0) + ti * th + row0
    x_i = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1) + tj * tw
    return x_i, y_i

SKY = (0.54, 0.86, 0.92)   # shader_sphere.wgsl:8
BLUE = (0.54, 0.7, 0.98)   # shader_sphere.wgsl:9


def generate_rays(cam, x_f, y_f, x_u, y_u, *, height: int, width: int,
                  time, normalize_defocus_dir: bool):
    """Seed + AA jitter + uv + make_ray, in planes.

    cam: callable idx -> scalar (camera component reader).
    x_f/y_f: f32 pixel-coordinate planes; x_u/y_u: u32 planes.
    time: u32 scalar.  Returns (state, o3, d4) — d4 keeps its w plane so the
    sphere/tris shaders' unnormalized-direction forks stay representable;
    callers use d4[:3] as the direction and d4[1] for the sky.
    """
    # seed = (x * res.y + y) * time  (shader_sphere.wgsl:253)
    state = (x_u * jnp.uint32(height) + y_u) * time

    # AA jitter: pos + normalize(rng_vec2)  (shader_sphere.wgsl:254-255)
    state, (jx, jy) = pm.rng_vec2(state)
    jx, jy = pm.normalize2((jx, jy))
    px = x_f + 0.5 + jx
    py = y_f + 0.5 + jy

    # uv = (2*pos/(res-1) - 1) * (aspect, -1)  (shader_sphere.wgsl:256-257)
    ux = px / jnp.float32(width - 1)
    uy = py / jnp.float32(height - 1)
    aspect = jnp.float32(width) / jnp.float32(height)
    uvx = (2.0 * ux - 1.0) * aspect
    uvy = -(2.0 * uy - 1.0)

    # make_ray (shader_sphere.wgsl:123-135): 4-vec normalize w/ live w.
    k = jnp.tan(cam(CAM_FOV) * 0.5)
    kx = uvx * k
    ky = uvy * k
    d4 = tuple(cam(CAM_RIGHT + c) * kx + cam(CAM_UP + c) * ky
               + cam(CAM_DIR + c) for c in range(4))
    d4 = pm.normalize4(d4)

    zero = jnp.zeros_like(x_f)
    o4 = tuple(zero + cam(CAM_EYE + c) for c in range(4))
    fl = cam(CAM_FL)
    focus = tuple(o4[c] + d4[c] * fl for c in range(4))

    # random_on_disk (shader_sphere.wgsl:118-122): always 3 draws.
    state, (vx, vy) = pm.rng_vec2(state)
    vx, vy = pm.normalize2((vx, vy))
    state, r = pm.rng_float(state)
    r = r * cam(CAM_BLUR)
    o4 = (o4[0] + vx * r, o4[1] + vy * r, o4[2], o4[3] + 1.0)

    d4 = tuple(focus[c] - o4[c] for c in range(4))
    if normalize_defocus_dir:           # tris shader fork (wgsl:146)
        d4 = pm.normalize4(d4)
    return state, (o4[0], o4[1], o4[2]), d4


def scatter(state, d, point, normal, front_face, albedo, param, kind, *,
            normalize_reflect_in: bool, has_metal: bool = True,
            has_dielectric: bool = True):
    """Masked three-way material scatter — plane port of
    rt/core/materials.scatter (shader_sphere.wgsl:172-217).

    kind: int32 plane.  Returns (new_state, new_dir3).
    RNG-stream semantics preserved: lambertian/metal consume 3 draws;
    dielectric consumes 1 draw unless total internal reflection (WGSL ``||``
    short-circuit); unknown kinds take the dielectric arm.

    has_metal/has_dielectric: static scene facts (config.mat_kinds) — absent
    arms are skipped entirely, like specializing the shader per scene.
    Skipping is sound because scatter outputs only matter on hit lanes, and
    hit lanes always carry a kind that IS present.
    """
    s1, f1 = pm.rng_float(state)
    s3 = hemi = None
    if True:  # lambertian arm always present (ground planes etc.)
        s2, f2 = pm.rng_float(s1)
        s3, f3 = pm.rng_float(s2)
        hemi = pm.normalize3((f1, f2, f3))
        hemi = pm.where3(pm.dot3(hemi, normal) > 0.0, hemi, pm.neg3(hemi))
    lam_dir = hemi

    if has_metal:
        refl_in = pm.normalize3(d) if normalize_reflect_in else d
        met_dir = pm.normalize3(
            pm.add3(pm.reflect3(refl_in, normal), pm.scale3(hemi, param)))

    if has_dielectric:
        ir = jnp.where(front_face, 1.0 / param, param)
        cos_theta = jnp.minimum(pm.dot3(pm.neg3(d), normal), 1.0)
        sin_theta = jnp.sqrt(1.0 - cos_theta * cos_theta)
        cannot_refract = ir * sin_theta > 1.0
        use_reflect = cannot_refract | (pm.schlick(cos_theta, ir)
                                        > pm.fract(f1))
        die_dir = pm.where3(use_reflect,
                            pm.normalize3(pm.reflect3(d, normal)),
                            pm.normalize3(pm.refract3(d, normal, ir)))
        die_state = jnp.where(cannot_refract, state, s1)

    is_lam = kind == 1
    if has_metal and has_dielectric:
        is_met = kind == 2
        new_dir = pm.where3(is_lam, lam_dir,
                            pm.where3(is_met, met_dir, die_dir))
        new_state = jnp.where(is_lam | is_met, s3, die_state)
    elif has_metal:
        new_dir = pm.where3(is_lam, lam_dir, met_dir)
        new_state = s3
    elif has_dielectric:
        new_dir = pm.where3(is_lam, lam_dir, die_dir)
        new_state = jnp.where(is_lam, s3, die_state)
    else:
        new_dir = lam_dir
        new_state = s3
    return new_state, new_dir


def sky_times_atten(primary_dy, atten):
    """color = atten * mix(SKY, BLUE, dir.y*0.5+0.5), unclamped
    (shader_sphere.wgsl:230-243); evaluated on the PRIMARY direction."""
    t = primary_dy * 0.5 + 0.5
    return tuple(atten[c] * (SKY[c] * (1.0 - t) + BLUE[c] * t)
                 for c in range(3))
