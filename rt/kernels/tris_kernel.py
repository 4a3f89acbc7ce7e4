"""Fused triangle-mesh path-trace kernel — the Pallas (Triton route)
replacement for shader_tris.wgsl (fs_main :326-347, trace :303-316,
Möller–Trumbore :161-202) with a block-coherent acceleration structure.

Instead of the reference's per-thread stackless BVH walk, the kernel
consumes a Morton-sorted triangle order as a *wide* hierarchy:

- triangles are scanned in CHUNKS of ``chunk`` consecutive Morton-clustered
  triangles (32 in the dispatch paths); per-chunk AABBs live in global
  memory;
- per chunk the whole (th, tw) block of rays does one slab test; if NO ray
  in the block enters the chunk, the chunk's triangle scan is skipped with
  a uniform branch (``lax.cond``) — block-coherent culling, a packet
  traversal;
- inside a live chunk the triangle loop broadcasts per-triangle scalars
  (uniform loads; edges precomputed at pack time), tracking only
  (t, normal, mat_id) closest-hit planes with selects; material attributes
  are gathered ONCE per bounce from the winning mat id.

Closest-hit semantics match rt/core/triangle.py: strict ``t < best`` with
ascending triangle index order, EPSILON = 1e-4, flat normals, the inverted
``front_face = dot(normal, dir) > 0`` convention with no normal flip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from rt.config import EPSILON_TRIS, FLT_MAX
from rt.kernels import plane_math as pm
from rt.kernels import tracer_common as tc

CHUNK = 32  # default chunk size (static)

# triangle-table columns (edges precomputed at pack time — the kernel
# never re-derives b-a/c-a per lane, and material attributes are deferred to
# a once-per-bounce resolve keyed on the winning mat id):
#   0:3 a, 3:6 e1 = b-a, 6:9 e2 = c-a, 9:12 normal, 12 mat_id (as f32)
TRI_COLS = 13


def _fmin(a, b):
    """WGSL min: returns the non-NaN operand (jnp.fmin semantics, spelled
    out so interpret mode and the compiled kernel agree)."""
    return jnp.where(jnp.isnan(a) | (b < a), b, a)


def _fmax(a, b):
    return jnp.where(jnp.isnan(a) | (b > a), b, a)


def _tile_rays(cam_ref, time, ti, tj, *, th: int, tw: int, height: int,
               width: int, normalize_defocus_dir: bool, row0=0):
    """Per-tile primary-ray generation (seed, AA jitter, make_ray).

    row0: global row index of this launch's first row — raygen is purely
    position-based (seed = (x*height + y)*time, uv from global (x, y)), so
    a kernel covering rows [row0, row0+grid*th) of the image produces
    BIT-IDENTICAL rays to the full-frame launch.  This is what makes the
    image-row DP sharding of the kernel path exact (rt/dist/bands.py):
    each shard renders its band with row0 = shard_index * band_height."""
    x_i, y_i = tc.pixel_coords(ti, tj, th=th, tw=tw, row0=row0)
    x_f = x_i.astype(jnp.float32)
    y_f = y_i.astype(jnp.float32)
    x_u = x_i.astype(jnp.uint32)
    y_u = y_i.astype(jnp.uint32)

    cam = lambda c: cam_ref[0, c]

    state, o, d4 = tc.generate_rays(
        cam, x_f, y_f, x_u, y_u, height=height, width=width, time=time,
        normalize_defocus_dir=normalize_defocus_dir)
    return state, o, (d4[0], d4[1], d4[2]), d4[1]


def _trace_bounce(tri_ref, mat_ref, chunk_ref, order_ref, zero, carry, *,
                  chunk: int, n_chunks: int, normalize_reflect_in: bool,
                  has_metal: bool, has_dielectric: bool, unroll: int = 1,
                  track_idx: bool = False):
    """One path-trace bounce over a block of rays: front-to-back chunk-culled
    closest-hit scan, once-per-bounce material gather, scatter.

    track_idx (recording variant only): additionally returns the winning
    triangle index in the Morton-clustered table order (-1 on miss) for the
    path-replay gradient recorder — one extra select per pair that the hot
    render path never pays."""
    state, o, d, atten, active = carry
    inv_d = (1.0 / d[0], 1.0 / d[1], 1.0 / d[2])
    izero = jnp.zeros_like(active)

    def scan_tri(k, best):
        # the index plane exists only in the recording variant — the hot
        # render path's loop carry stays 5 planes wide
        bt, bnrm, bmid = best[:3]
        btid = best[3] if track_idx else None
        # Möller–Trumbore (shader_tris.wgsl:161-202); e1/e2 precomputed
        # at pack time (identical f32 subtracts — bit-equal to deriving
        # them in-lane), consumed as scalar broadcasts.
        e1 = (tri_ref[k, 3], tri_ref[k, 4], tri_ref[k, 5])
        e2 = (tri_ref[k, 6], tri_ref[k, 7], tri_ref[k, 8])
        h = pm.cross3(d, e2)
        det = pm.dot3(e1, h)
        inv_det = 1.0 / det
        s = (o[0] - tri_ref[k, 0], o[1] - tri_ref[k, 1],
             o[2] - tri_ref[k, 2])
        u = inv_det * pm.dot3(s, h)
        q = pm.cross3(s, e1)
        v = inv_det * pm.dot3(d, q)
        t = inv_det * pm.dot3(e2, q)
        valid = (jnp.abs(det) >= EPSILON_TRIS)
        valid &= (u >= 0.0) & (u <= 1.0)
        valid &= (v >= 0.0) & (u + v <= 1.0)
        valid &= (t >= EPSILON_TRIS) & (t < bt)
        out = (jnp.where(valid, t, bt),
               pm.where3(valid, (zero + tri_ref[k, 9],
                                 zero + tri_ref[k, 10],
                                 zero + tri_ref[k, 11]), bnrm),
               jnp.where(valid, zero + tri_ref[k, 12], bmid))
        if track_idx:
            out += (jnp.where(valid, izero + k, btid),)
        return out

    def scan_chunk(oi, best):
        # visit chunks approximately front-to-back (order precomputed from
        # the camera eye) so the `tmin < best_t` rejection prunes.
        ci = order_ref[oi, 0]
        # slab test of the chunk AABB against every ray in the block
        # (shader_tris.wgsl:150-159 semantics: WGSL min/max drop NaNs)
        t0x = (chunk_ref[ci, 0] - o[0]) * inv_d[0]
        t1x = (chunk_ref[ci, 3] - o[0]) * inv_d[0]
        t0y = (chunk_ref[ci, 1] - o[1]) * inv_d[1]
        t1y = (chunk_ref[ci, 4] - o[1]) * inv_d[1]
        t0z = (chunk_ref[ci, 2] - o[2]) * inv_d[2]
        t1z = (chunk_ref[ci, 5] - o[2]) * inv_d[2]
        tmin = _fmax(_fmax(_fmin(t0x, t1x), _fmin(t0y, t1y)),
                     _fmin(t0z, t1z))
        tmax = _fmin(_fmin(_fmax(t0x, t1x), _fmax(t0y, t1y)),
                     _fmax(t0z, t1z))
        # also require the chunk to be nearer than the current best
        # (conservative: entry distance vs per-ray best t)
        enter = (tmin <= tmax) & (tmax >= 0.0) & (tmin < best[0])
        live = (active > 0) & enter
        lo = ci * chunk

        def do(best):
            # static trip count; the table is zero-padded to a chunk
            # multiple, so padding triangles are degenerate (det == 0).
            # ``unroll`` scans several triangles per loop iteration in the
            # same ascending order (bit-identical results) — more
            # independent work between the serial best-t selects.
            def body(kk, b):
                for uu in range(unroll):
                    b = scan_tri(lo + kk * unroll + uu, b)
                return b
            return jax.lax.fori_loop(0, chunk // unroll, body, best)

        return jax.lax.cond(tc.any_lane(live), do, lambda b: b, best)

    best0 = (zero + FLT_MAX, (zero, zero, zero), zero)
    if track_idx:
        best0 += (izero - 1,)
    best = jax.lax.fori_loop(0, n_chunks, scan_chunk, best0)
    bt, bnrm, bmid = best[:3]

    hit = (active > 0) & (bt != FLT_MAX)

    # material attributes gathered ONCE per bounce from the winning mat
    # id (a per-lane load) — the per-triangle scan only tracks
    # (t, normal, mat_id).  Miss lanes read material 0; their scatter
    # output is discarded by the `hit` mask below.
    mid = bmid.astype(jnp.int32)
    bal = (mat_ref[mid, 0], mat_ref[mid, 1], mat_ref[mid, 2])
    bpar = mat_ref[mid, 3]
    bkind = mat_ref[mid, 4]

    # hit record (shader_tris.wgsl:197-201): flat normal, NO flip,
    # inverted front_face convention.
    point = pm.add3(o, pm.scale3(d, bt))
    front_face = pm.dot3(bnrm, d) > 0.0
    kind_i = bkind.astype(jnp.int32)

    ns, nd = tc.scatter(state, d, point, bnrm, front_face, bal, bpar,
                        kind_i, normalize_reflect_in=normalize_reflect_in,
                        has_metal=has_metal,
                        has_dielectric=has_dielectric)

    state = jnp.where(hit, ns, state)
    o = pm.where3(hit, point, o)
    d = pm.where3(hit, nd, d)
    atten = pm.where3(hit, pm.scale3(pm.mul3(atten, bal), 0.7), atten)
    out = (state, o, d, atten, hit.astype(jnp.int32))
    if track_idx:
        out += (jnp.where(hit, best[3], izero - 1),)
    return out


def _kernel(tri_ref, mat_ref, chunk_ref, order_ref, cam_ref, time_ref,
            row0_ref, out_ref, *idx_refs,
            n_chunks: int, chunk: int, height: int, width: int,
            th: int, tw: int, bounces: int, normalize_defocus_dir: bool,
            normalize_reflect_in: bool, has_metal: bool = True,
            has_dielectric: bool = True, sky_from_final_dir: bool = False,
            unroll: int = 1, spp: int = 1, track_idx: bool = False):
    """Monolithic whole-frame kernel: raygen + all bounces in one launch.

    track_idx (the path-replay recorder, spp == 1): also store the winning
    triangle index per bounce (-1 on miss, Morton-clustered table order)
    into idx_refs[0][bounce]."""
    state, o, d0, primary_dy = _tile_rays(
        cam_ref, time_ref[0, 0], pl.program_id(0), pl.program_id(1), th=th,
        tw=tw, height=height, width=width,
        normalize_defocus_dir=normalize_defocus_dir, row0=row0_ref[0, 0])

    zero = jnp.zeros((th, tw), jnp.float32)
    one = zero + 1.0

    trace1 = functools.partial(
        _trace_bounce, tri_ref, mat_ref, chunk_ref, order_ref, zero,
        chunk=chunk, n_chunks=n_chunks,
        normalize_reflect_in=normalize_reflect_in, has_metal=has_metal,
        has_dielectric=has_dielectric, unroll=unroll, track_idx=track_idx)

    def bounce(b, carry):
        # whole-block early exit: once every lane has escaped to the sky the
        # remaining bounces are no-ops — skip the chunk scans entirely
        live = tc.any_lane(carry[4] > 0)
        if not track_idx:
            return jax.lax.cond(live, trace1, lambda c: c, carry)

        def traced(c):
            *c, btid = trace1(c)
            return tuple(c), btid

        def dead(c):
            return c, jnp.zeros((th, tw), jnp.int32) - 1

        carry, btid = jax.lax.cond(live, traced, dead, carry)
        idx_refs[0][b] = btid
        return carry

    def one_sample(state):
        carry = (state, o, d0, (one, one, one),
                 jnp.ones((th, tw), jnp.int32))
        state, _, d, atten, _ = jax.lax.fori_loop(0, bounces, bounce, carry)
        # sky_from_final_dir: RenderConfig extension (standard RTIOW
        # background); default False = the reference's primary-ray sky quirk.
        return state, tc.sky_times_atten(
            d[1] if sky_from_final_dir else primary_dy, atten)

    if spp == 1:
        _, col = one_sample(state)
    else:
        # SAMPLE_PER_FRAME > 1 (shader_tris.wgsl fs_main): the SAME primary
        # ray is re-traced spp times with the RNG state THREADED across
        # samples, then the sum is averaged — matching the oracle renderer's
        # sample loop (rt/render/renderer.py:63-70) bit for bit (true divide,
        # not reciprocal-multiply: x/3 and x*(1/3) round differently).
        def sample(_, c):
            state, acc = c
            state, col = one_sample(state)
            return state, pm.add3(acc, col)
        _, col = jax.lax.fori_loop(0, spp, sample,
                                   (state, (zero, zero, zero)))
        n = jnp.float32(spp)
        col = (col[0] / n, col[1] / n, col[2] / n)

    out_ref[0] = col[0]
    out_ref[1] = col[1]
    out_ref[2] = col[2]


def _spread10(v):
    """Spread the low 10 bits of u32 ``v`` out to every 3rd bit."""
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def _morton_order(centroids):
    """Spatial sort by 30-bit Morton code (jnp — runs under jit; the scene
    is a traced pytree there).

    The parity-critical implicit-heap BVH (rt/scene/bvh.py) uses the
    reference's BFS median splits, whose subtree AABBs overlap badly on
    merged scenes (81% of chunks live on Suzanne in that order).  The
    kernel is free to scan triangles in ANY order (closest-hit with strict
    ``t < best`` is order-independent up to measure-zero ties), so its
    chunks come from a Morton sort: spatially compact clusters → tight
    chunk AABBs → the slab test culls far more.
    """
    c = centroids.astype(jnp.float32)
    lo = c.min(axis=0)
    span = jnp.maximum(c.max(axis=0) - lo, 1e-12)
    q = jnp.clip((c - lo) / span * 1023.0, 0, 1023).astype(jnp.uint32)

    code = ((_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1)
            | _spread10(q[:, 2]))
    return jnp.argsort(code, stable=True)


def pack_tri_table(scene, chunk: int = CHUNK):
    """Build the (m_pad, 13) triangle table (Morton-clustered order,
    precomputed edges, per-triangle mat id), the (K, 5) material table
    [albedo rgb, param, kind] and the (n_chunks, 6) chunk-AABB table."""
    order = _morton_order((scene.a + scene.b + scene.c) / 3.0)
    a = scene.a[order].astype(jnp.float32)
    b = scene.b[order].astype(jnp.float32)
    c = scene.c[order].astype(jnp.float32)
    mid = jnp.clip(scene.mat_id, 0, scene.mat_albedo.shape[0] - 1)[order]
    tab = jnp.concatenate([
        a, b - a, c - a, scene.normal[order].astype(jnp.float32),
        mid.astype(jnp.float32)[:, None],
    ], axis=1)                                          # (m, 13)
    mats = jnp.concatenate([
        scene.mat_albedo.astype(jnp.float32),
        scene.mat_param.astype(jnp.float32)[:, None],
        scene.mat_kind.astype(jnp.float32)[:, None],
    ], axis=1)                                          # (K, 5)

    # zero-pad to a chunk multiple; padding rows are degenerate (e1=e2=0 so
    # det == 0 rejects them)
    m = scene.m
    m_pad = -(-m // chunk) * chunk
    if m_pad != m:
        tab = jnp.concatenate(
            [tab, jnp.zeros((m_pad - m, TRI_COLS), jnp.float32)])

    # chunk AABBs over the clustered order (vertex min/max per chunk, from
    # the ordered vertices — the table itself only holds edges); padding
    # vertices never widen a box
    verts = jnp.stack([a, b, c], axis=1)                # (m, 3, 3)
    big = jnp.float32(3.0e38)
    if m_pad != m:
        pad = jnp.zeros((m_pad - m, 3, 3), jnp.float32)
        verts_min = jnp.concatenate([verts, pad + big])
        verts_max = jnp.concatenate([verts, pad - big])
    else:
        verts_min = verts_max = verts
    vmin = verts_min.reshape(-1, chunk, 3, 3).min(axis=(1, 2))
    vmax = verts_max.reshape(-1, chunk, 3, 3).max(axis=(1, 2))
    chunks = jnp.concatenate([vmin, vmax], axis=1).astype(jnp.float32)
    return tab, mats, chunks, m_pad, chunks.shape[0]


def _eye_order(cam_row, chunks):
    """Approximate front-to-back chunk visit order from the camera eye
    (closest chunk-AABB centroid first) as an (n_chunks, 1) i32 column;
    order only affects pruning, never the closest hit (strict t < best)."""
    eye = cam_row[0, 0:3]
    centroid = (chunks[:, 0:3] + chunks[:, 3:6]) * 0.5
    dist = jnp.sum((centroid - eye) ** 2, axis=1)
    return jnp.argsort(dist).astype(jnp.int32)[:, None]


def _mono_call(scene, cam_row, time, row0, *, height_pad, width_pad, th,
               tw, chunk, num_warps, interpret, track_idx, **kw):
    tab, mats, chunks, _, n_chunks = pack_tri_table(scene, chunk)
    order = _eye_order(cam_row, chunks)
    row0_arr = (jnp.zeros((1, 1), jnp.int32) if row0 is None
                else jnp.asarray(row0, jnp.int32).reshape(1, 1))
    kernel = functools.partial(_kernel, n_chunks=n_chunks, chunk=chunk,
                               th=th, tw=tw, track_idx=track_idx, **kw)
    return tc.frame_call(
        kernel, (tab, mats, chunks, order, cam_row, time, row0_arr),
        height_pad=height_pad, width_pad=width_pad, th=th, tw=tw,
        num_warps=num_warps, interpret=interpret,
        record_bounces=kw["bounces"] if track_idx else 0)


_STATIC = ("height", "width", "height_pad", "width_pad", "bounces",
           "normalize_defocus_dir", "normalize_reflect_in", "th", "tw",
           "num_warps", "chunk", "unroll", "has_metal", "has_dielectric",
           "sky_from_final_dir", "interpret")


@functools.partial(jax.jit, static_argnames=_STATIC + ("spp",))
def render_color_tris(scene, cam_row, time, *, height: int, width: int,
                      height_pad: int, width_pad: int, bounces: int,
                      normalize_defocus_dir: bool, normalize_reflect_in: bool,
                      th: int, tw: int, num_warps: int, chunk: int = CHUNK,
                      unroll: int = 1, has_metal: bool = True,
                      has_dielectric: bool = True,
                      sky_from_final_dir: bool = False, spp: int = 1,
                      row0=None, interpret: bool = False):
    """Planar (3, Hp, Wp) color for one frame of a TriangleScene.

    row0: optional global row offset (traced i32 scalar) — the launch then
    covers image rows [row0, row0 + height_pad) with bit-identical rays to
    the same rows of a full-frame launch (image-row DP sharding)."""
    return _mono_call(
        scene, cam_row, time, row0, height=height, width=width,
        height_pad=height_pad, width_pad=width_pad, bounces=bounces,
        normalize_defocus_dir=normalize_defocus_dir,
        normalize_reflect_in=normalize_reflect_in, th=th, tw=tw,
        num_warps=num_warps, chunk=chunk, unroll=unroll,
        has_metal=has_metal, has_dielectric=has_dielectric,
        sky_from_final_dir=sky_from_final_dir, spp=spp, interpret=interpret,
        track_idx=False)


@functools.partial(jax.jit, static_argnames=_STATIC)
def render_color_tris_record(scene, cam_row, time, *, height: int,
                             width: int, height_pad: int, width_pad: int,
                             bounces: int, normalize_defocus_dir: bool,
                             normalize_reflect_in: bool, th: int, tw: int,
                             num_warps: int, chunk: int = CHUNK,
                             unroll: int = 1, has_metal: bool = True,
                             has_dielectric: bool = True,
                             sky_from_final_dir: bool = False,
                             interpret: bool = False):
    """(color (3, Hp, Wp) f32, hit indices (bounces, Hp, Wp) i32, morton
    order (m,) i32) — forward render plus the per-bounce winning triangle
    index stream (in Morton-clustered TABLE order; the returned ``order``
    array maps table rows back to scene triangle ids for the replay).  Same
    kernel body as render_color_tris, so the color is bit-identical."""
    color, idx = _mono_call(
        scene, cam_row, time, None, height=height, width=width,
        height_pad=height_pad, width_pad=width_pad, bounces=bounces,
        normalize_defocus_dir=normalize_defocus_dir,
        normalize_reflect_in=normalize_reflect_in, th=th, tw=tw,
        num_warps=num_warps, chunk=chunk, unroll=unroll,
        has_metal=has_metal, has_dielectric=has_dielectric,
        sky_from_final_dir=sky_from_final_dir, interpret=interpret,
        track_idx=True)
    morton = _morton_order((scene.a + scene.b + scene.c) / 3.0)
    return color, idx, morton.astype(jnp.int32)
