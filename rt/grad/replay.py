"""Path-replay backprop — the fast differentiable path (BASELINE
config 5).

The expensive part of the forward render is FINDING the hits (intersection
scans / chunk-culled traversal), but the hit decisions are discrete and
detached from gradients anyway (rt/grad/diff_render.py's semantics).  So:

1. **Record** (Pallas, fast): the fused kernels' recording variants
   (``render_color_spheres_record`` / ``render_color_tris_record``) output
   the per-bounce WINNING PRIMITIVE INDEX per pixel (-1 on miss) alongside
   the color — the full Monte-Carlo path structure of the frame.
2. **Replay** (pure JAX, cheap, differentiable): recompute the transport
   with the hit sequence FROZEN — per bounce, gather the known primitive's
   parameters and recompute (t, normal, scatter) directly.  Cost is
   O(pixels x bounces), with NO intersection scans; the backward pass is
   jax.grad through this graph.

This is the classic path-replay backpropagation structure (Vicini et al.
2021) specialized to the reference's transport (shader_sphere.wgsl:230-243 /
shader_tris.wgsl:303-316).  At the recording parameters the replay gradients
equal the full differentiable renderer's (same taken branches — asserted in
tests/test_replay.py); as parameters move the decisions stay frozen until
the next record, exactly like any detached-sampling estimator.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rt.config import EPSILON_TRIS, FLT_MAX, RenderConfig
from rt.core import camera as camera_mod
from rt.core import sphere as sphere_mod
from rt.core import triangle as triangle_mod
from rt.core.materials import scatter
from rt.core.trace import sky_color
from rt.core.vecmath import cross, dot
from rt.grad.gather import gather_rows_auto


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


def record_hits_oracle(scene, camera, config: RenderConfig, time):
    """(color (H,W,3), hits (bounces,H,W) i32 scene-order ids) via the
    pure-JAX oracle — the CPU-runnable recorder used by tests; the Pallas
    recorder below is the device path."""
    state, origin, direction = camera_mod.generate_primary_rays(
        camera, config.width, config.height, time,
        config.normalize_defocus_dir)

    if isinstance(scene, sphere_mod.SphereArray):
        intersect = partial(sphere_mod.intersect_all_spheres, scene)
        hit_rec = partial(sphere_mod.hit_record, scene)
    else:
        intersect = partial(triangle_mod.intersect_all_bvh, scene)
        hit_rec = partial(triangle_mod.hit_record, scene)

    o, d = origin, direction
    atten = jnp.ones_like(o)
    active = jnp.ones(o.shape[:-1], bool)
    hits = []
    for _ in range(config.bounces):
        t, idx = intersect(o, d)
        hm = active & (t != FLT_MAX)
        hit = hit_rec(o, d, t, idx)
        ns, no, nd = scatter(state, o, d, hit,
                             normalize_reflect_in=config.normalize_reflect_in)
        m3 = hm[..., None]
        state = jnp.where(hm, ns, state)
        o = jnp.where(m3, no, o)
        d = jnp.where(m3, nd, d)
        atten = jnp.where(m3, atten * hit["albedo"] * 0.7, atten)
        hits.append(jnp.where(hm, idx, -1))
        active = hm
    sky_dir = d if config.sky_from_final_dir else direction
    return atten * sky_color(sky_dir), jnp.stack(hits)


def record_hits_pallas(scene, camera, config: RenderConfig, time,
                       interpret: bool = False):
    """(color (H,W,3), hits (bounces,H,W) i32 scene-order ids) via the
    recording Pallas kernels — the fast device recorder.  Works both
    eagerly (as fit_replay calls it) and under an outer jax.jit."""
    from rt.kernels.dispatch import (TRIS_UNROLL, block_grid, pack_camera,
                                     pack_spheres_table)
    from rt.config import MAT_DIELECTRIC, MAT_METAL

    h, w = config.height, config.width
    cam_row = pack_camera(camera)
    time_arr = jnp.asarray(time, jnp.uint32).reshape(1, 1)
    has_metal = MAT_METAL in config.mat_kinds
    has_dielectric = MAT_DIELECTRIC in config.mat_kinds
    common = dict(height=h, width=w, bounces=config.bounces,
                  normalize_defocus_dir=config.normalize_defocus_dir,
                  normalize_reflect_in=config.normalize_reflect_in,
                  has_metal=has_metal, has_dielectric=has_dielectric,
                  sky_from_final_dir=config.sky_from_final_dir,
                  interpret=interpret, **block_grid(h, w))

    if isinstance(scene, sphere_mod.SphereArray):
        from rt.kernels.sphere_kernel import render_color_spheres_record
        tab, kinds, n = pack_spheres_table(scene)
        if 0 < config.n_active_spheres < n:
            n = config.n_active_spheres
        color, idx = render_color_spheres_record(
            tab, kinds, cam_row, time_arr, n_spheres=n, **common)
    else:
        from rt.kernels.tris_kernel import render_color_tris_record
        color, idx_tab, morton = render_color_tris_record(
            scene, cam_row, time_arr, chunk=32, unroll=TRIS_UNROLL,
            **common)
        # map Morton-clustered table rows back to scene triangle ids
        safe = jnp.clip(idx_tab, 0, morton.shape[0] - 1)
        idx = jnp.where(idx_tab >= 0, morton[safe], -1)

    color = jnp.transpose(color, (1, 2, 0))[:h, :w]
    idx = idx[:, :h, :w]
    return color, idx


# ---------------------------------------------------------------------------
# Replay (differentiable)
# ---------------------------------------------------------------------------


def _sphere_replay_table(scene):
    """Pack the per-sphere attributes into ONE (N, 9) table so each bounce
    costs a single row gather: [center(3), radius, albedo(3), param, kind].
    Built from the (differentiable) scene arrays INSIDE the loss, so table
    gradients split back onto center/radius/albedo/param in the backward
    pass; the discrete kind column is detached."""
    return jnp.concatenate([
        scene.center.astype(jnp.float32),
        scene.radius.astype(jnp.float32)[:, None],
        scene.albedo.astype(jnp.float32),
        scene.mat_param.astype(jnp.float32)[:, None],
        jax.lax.stop_gradient(
            scene.mat_kind.astype(jnp.float32))[:, None],
    ], axis=1)


def _sphere_replay_hit(scene, tab, o, d, idx, gather_mode="auto"):
    """Recompute (t, hit record) for the KNOWN sphere per lane — the
    differentiable chain of shader_sphere.wgsl:136-155 without the scan.
    The row gather is ``gather_rows_auto`` (rt/grad/gather.py)."""
    i = jnp.clip(idx, 0, scene.count - 1)
    row = gather_rows_auto(tab, i, gather_mode)
    center = row[..., 0:3]
    radius = row[..., 3]
    t = sphere_mod.intersect_sphere_t(o, d, center, radius)
    # recorded hits always have a positive root; guard the measure-zero
    # degenerate replays (param drifted so far the hit vanished)
    t = jnp.where(t > 0.0, t, 1.0)
    point = o + t[..., None] * d
    normal = (point - center) / radius[..., None]
    front_face = dot(d, normal) < 0.0
    normal = jnp.where(front_face[..., None], normal, -normal)
    return {
        "point": point,
        "normal": normal,
        "front_face": front_face,
        "albedo": row[..., 4:7],
        "mat_param": row[..., 7],
        "mat_kind": row[..., 8].astype(scene.mat_kind.dtype),
    }


def _tris_replay_tables(scene):
    """(tri table (m, 13), material table (K, 5)) for the replay gather:
    tri = [a(3), b(3), c(3), normal(3), mat_id], mat = [albedo(3), param,
    kind].  Geometry/normal columns stay differentiable; the discrete id
    columns are detached."""
    n_mats = scene.mat_albedo.shape[0]
    tri = jnp.concatenate([
        scene.a.astype(jnp.float32),
        scene.b.astype(jnp.float32),
        scene.c.astype(jnp.float32),
        scene.normal.astype(jnp.float32),
        jax.lax.stop_gradient(
            jnp.clip(scene.mat_id, 0, n_mats - 1)
            .astype(jnp.float32))[:, None],
    ], axis=1)
    mat = jnp.concatenate([
        scene.mat_albedo.astype(jnp.float32),
        scene.mat_param.astype(jnp.float32)[:, None],
        jax.lax.stop_gradient(
            scene.mat_kind.astype(jnp.float32))[:, None],
    ], axis=1)
    return tri, mat


def _tris_replay_hit(scene, tabs, o, d, idx, gather_mode="auto", row=None):
    """Recompute (t, hit record) for the KNOWN triangle per lane
    (shader_tris.wgsl:161-202's M-T restricted to the winner).  Triangle
    and material rows arrive via ``gather_rows_auto``; large meshes
    (lucy/dragon, > MAX_ONEHOT_ROWS) take the XLA gather for the triangle
    table while the small material table stays on the one-hot matmul.

    row: optionally the PRE-GATHERED (..., 13) triangle rows — the
    frozen-geometry fast path hoists the triangle-table gather out of the
    train loop entirely (hits are constant across steps), leaving only the
    small differentiable material gather per bounce."""
    tri_tab, mat_tab = tabs
    if row is None:
        i = jnp.clip(idx, 0, scene.m - 1)
        row = gather_rows_auto(tri_tab, i, gather_mode)
    a = row[..., 0:3]
    edge1 = row[..., 3:6] - a
    edge2 = row[..., 6:9] - a
    h = cross(d, edge2)
    det = dot(edge1, h)
    # grad guard: miss lanes gather an arbitrary triangle whose det can be
    # ~0; the division's inf would poison cotangents through the masked
    # selects downstream (forward values on those lanes are discarded)
    ok = jnp.abs(det) >= EPSILON_TRIS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    s = o - a
    q = cross(s, edge1)
    t = inv_det * dot(edge2, q)
    t = jnp.where(ok & (t > 0.0), t, 1.0)
    normal = row[..., 9:12]
    mid = row[..., 12].astype(jnp.int32)
    mrow = gather_rows_auto(mat_tab, mid, gather_mode)
    return {
        "point": o + t[..., None] * d,
        "normal": normal,
        "front_face": dot(normal, d) > 0.0,
        "albedo": mrow[..., 0:3],
        "mat_param": mrow[..., 3],
        "mat_kind": mrow[..., 4].astype(scene.mat_kind.dtype),
    }


def replay_color(scene, camera, config: RenderConfig, time, hits,
                 remat: bool = True, gather_mode: str = "auto",
                 frozen_geometry: bool = True, _pre_rows=None):
    """Differentiable (H, W, 3) color with the hit sequence FROZEN.

    hits: (bounces, H, W) i32 scene-order primitive ids (-1 = miss), from
    either recorder.  Gradients flow through the continuous transport
    (t, point, normal, scatter, attenuation, sky) w.r.t. scene arrays and
    camera; the discrete path structure is fixed — identical gradient
    semantics to render_color_diff at the recording point, at O(pixels x
    bounces) cost with no intersection scans.

    gather_mode: how per-pixel primitive rows are fetched — "onehot"
    (one-hot matmul, bit-equal to the native gather), "take" (XLA gather), or
    "auto" (onehot for tables up to gather.MAX_ONEHOT_ROWS).

    frozen_geometry (triangle scenes only): hoist the triangle-table gather
    out of the per-step graph — the hit ids are constants across training
    steps, so the winning triangles' (a, e1, e2, normal) rows are gathered
    once under stop_gradient and fed to the bounce scan as inputs.  Only the
    small differentiable MATERIAL gather remains per step.  Valid while
    triangle vertices are not optimization parameters (TriangleParams
    exposes materials only); pass False to keep geometry in-graph, e.g. for
    custom losses differentiating w.r.t. scene.a/b/c.  Camera gradients are
    unaffected (the M-T recompute against the constant rows stays
    in-graph).
    """
    state, origin, direction = camera_mod.generate_primary_rays(
        camera, config.width, config.height, time,
        config.normalize_defocus_dir)

    hits = jax.lax.stop_gradient(hits)

    if isinstance(scene, sphere_mod.SphereArray):
        tabs = _sphere_replay_table(scene)
        xs = (hits, None)
        replay_hit = _sphere_replay_hit
    else:
        tabs = _tris_replay_tables(scene)
        if _pre_rows is not None:
            xs = (hits, jax.lax.stop_gradient(_pre_rows))
        elif frozen_geometry:
            i = jnp.clip(hits, 0, scene.m - 1)
            rows = jax.lax.stop_gradient(
                gather_rows_auto(tabs[0], i, gather_mode))
            xs = (hits, rows)
        else:
            xs = (hits, None)
        replay_hit = _tris_replay_hit

    if xs[1] is None:
        # keep the scan xs a plain array when there is no row stream
        xs = hits
        unpack = lambda x: (x, None)
    else:
        unpack = lambda x: x

    def body(carry, x):
        idx, row = unpack(x)
        state, o, d, atten = carry
        hm = idx >= 0
        if replay_hit is _tris_replay_hit:
            hit = replay_hit(scene, tabs, o, d, idx, gather_mode, row=row)
        else:
            hit = replay_hit(scene, tabs, o, d, idx, gather_mode)
        ns, no, nd = scatter(state, o, d, hit,
                             normalize_reflect_in=config.normalize_reflect_in)
        m3 = hm[..., None]
        state = jnp.where(hm, ns, state)
        o = jnp.where(m3, no, o)
        d = jnp.where(m3, nd, d)
        atten = jnp.where(m3, atten * hit["albedo"] * 0.7, atten)
        return (state, o, d, atten), None

    if remat:
        body = jax.checkpoint(body)

    atten = jnp.ones_like(origin)
    (state, o, d, atten), _ = jax.lax.scan(
        body, (state, origin, direction, atten), xs)
    sky_dir = d if config.sky_from_final_dir else direction
    return atten * sky_color(sky_dir)


def replay_loss_fn(base_scene, camera, config: RenderConfig, target, hits,
                   time, gather_mode: str = "auto",
                   frozen_geometry: bool = True):
    """loss(params: SphereParams|TriangleParams, camera_params|None) built
    on the replay graph — the fast inverse-rendering objective.

    For triangle scenes with frozen_geometry (the default — TriangleParams
    optimizes materials, never vertices), the winning triangles' geometry
    rows are gathered ONCE here, eagerly, and closed over as constants:
    the per-step graph then contains no triangle-table gather at all (the
    lucy/dragon tables are too big for the one-hot path, and even the
    XLA forward gather is pure waste when repeated every step)."""
    from rt.grad.loss import image_mse
    from rt.grad.params import (SphereParams, apply_params, apply_tri_params,
                                camera_from_params)

    target = jnp.asarray(target, jnp.float32)
    t = jnp.uint32(time)

    pre_rows = None
    if frozen_geometry and not isinstance(base_scene, sphere_mod.SphereArray):
        tri_tab, _ = _tris_replay_tables(base_scene)
        i = jnp.clip(jnp.asarray(hits), 0, base_scene.m - 1)
        pre_rows = jax.lax.stop_gradient(
            gather_rows_auto(tri_tab, i, gather_mode))

    def loss(params, camera_params=None):
        if params is None:
            sc = base_scene
        elif isinstance(params, SphereParams):
            sc = apply_params(base_scene, params)
        else:
            if frozen_geometry and (params.a is not None
                                    or params.b is not None
                                    or params.c is not None):
                raise ValueError(
                    "TriangleParams with vertex fields need "
                    "replay_loss_fn(..., frozen_geometry=False): the "
                    "frozen-geometry fast path detaches the triangle rows, "
                    "so vertex gradients would be silently zero")
            sc = apply_tri_params(base_scene, params)
        cam = camera_from_params(camera_params, camera)
        img = replay_color(sc, cam, config, t, hits,
                           gather_mode=gather_mode,
                           frozen_geometry=frozen_geometry,
                           _pre_rows=pre_rows)
        return image_mse(img, target)

    return loss
