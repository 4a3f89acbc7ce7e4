"""Fused sphere path-trace kernel — the Pallas replacement for
shader_sphere.wgsl's fs_main (:252-273) + trace (:230-243) +
intersect_all_sphere (:218-229).

Design (Pallas, Triton route):
- grid over (th, tw) pixel blocks, about one ray per thread; every
  per-pixel quantity is a (th, tw) plane held in registers;
- the sphere table sits in global memory and per-sphere constants are
  uniform SCALAR loads (served by L1) broadcast against the block, so the
  closest-hit scan is a select chain: winning-sphere attributes are carried
  as planes instead of gathered after the loop;
- bounce loop and sphere loop are ``fori_loop``s inside the kernel: one
  launch traces the whole frame; device-memory traffic is one (3, th, tw)
  color write per block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from rt.config import FLT_MAX
from rt.kernels import plane_math as pm
from rt.kernels import tracer_common as tc

# sphere-table layout (one row per sphere):
#   0:3 center, 3 radius, 4:7 albedo, 7 mat_param
SPH_COLS = 8


def _sphere_bounce(sph_ref, kind_ref, zero, one, carry, *, n_spheres: int,
                   th: int, tw: int, normalize_reflect_in: bool,
                   has_metal: bool, has_dielectric: bool,
                   track_idx: bool = False, unroll_all: bool = False):
    """One bounce over a tile: closest-hit sphere scan + scatter.  Returns
    (state, o, d, atten, active[, winning sphere index when track_idx —
    -1 on miss, for the path-replay gradient recorder])."""
    state, o, d, atten, active = carry

    # ray-constant quadratic terms hoisted out of the sphere loop (d is
    # fixed within a bounce); the 2x/4x multiples are exact exponent
    # shifts, so disc and t round identically to the in-loop form
    a = pm.dot3(d, d)
    two_a = 2.0 * a
    four_a = 4.0 * a
    izero = jnp.zeros((th, tw), jnp.int32)

    # ---- closest-hit scan over the sphere table ----------------------
    def scan_sphere(si, best):
        # the index plane exists only in the recording variant — the hot
        # render path's loop carry stays unchanged
        bt, bc, br, bal, bpar, bkind = best[:6]
        bidx = best[6] if track_idx else None
        c = (zero + sph_ref[si, 0], zero + sph_ref[si, 1],
             zero + sph_ref[si, 2])
        r = sph_ref[si, 3]
        oc = pm.sub3(o, c)
        b = 2.0 * pm.dot3(oc, d)
        cc = pm.dot3(oc, oc) - r * r
        disc = b * b - four_a * cc
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t = (-b - sq) / two_a
        t = jnp.where(disc < 0.0, jnp.float32(-1.0), t)
        better = (t > 0.0) & (t < bt)
        sel = lambda new, old: jnp.where(better, new, old)
        out = (sel(t, bt),
               pm.where3(better, c, bc),
               sel(zero + r, br),
               pm.where3(better, (zero + sph_ref[si, 4],
                                  zero + sph_ref[si, 5],
                                  zero + sph_ref[si, 6]), bal),
               sel(zero + sph_ref[si, 7], bpar),
               jnp.where(better, izero + kind_ref[si, 0], bkind))
        if track_idx:
            out += (jnp.where(better, izero + si, bidx),)
        return out

    best0 = (zero + FLT_MAX, (zero, zero, zero), one,
             (zero, zero, zero), zero, izero)
    if track_idx:
        best0 += (izero - 1,)
    if unroll_all:
        # small scenes: fully unroll the scan (same ascending order —
        # bit-identical), so every sphere's independent quadratic can
        # overlap the serialized select chain
        best = best0
        for si in range(n_spheres):
            best = scan_sphere(si, best)
    else:
        best = jax.lax.fori_loop(0, n_spheres, scan_sphere, best0)
    bt, bc, br, bal, bpar, bkind = best[:6]
    bidx = best[6] if track_idx else None

    hit = (active > 0) & (bt != FLT_MAX)

    # ---- hit record (shader_sphere.wgsl:148-154) ---------------------
    point = pm.add3(o, pm.scale3(d, bt))
    normal = ((point[0] - bc[0]) / br, (point[1] - bc[1]) / br,
              (point[2] - bc[2]) / br)
    front_face = pm.dot3(d, normal) < 0.0
    normal = pm.where3(front_face, normal, pm.neg3(normal))

    ns, nd = tc.scatter(state, d, point, normal, front_face, bal, bpar,
                        bkind, normalize_reflect_in=normalize_reflect_in,
                        has_metal=has_metal,
                        has_dielectric=has_dielectric)

    state = jnp.where(hit, ns, state)
    o = pm.where3(hit, point, o)
    d = pm.where3(hit, nd, d)
    atten = pm.where3(hit, pm.scale3(pm.mul3(atten, bal), 0.7), atten)
    out = (state, o, d, atten, hit.astype(jnp.int32))
    if track_idx:
        return out + (jnp.where(hit, bidx, izero - 1),)
    return out


def _kernel(sph_ref, kind_ref, cam_ref, time_ref, out_ref, *idx_refs,
            n_spheres: int, height: int, width: int, th: int, tw: int,
            bounces: int, normalize_defocus_dir: bool,
            normalize_reflect_in: bool, has_metal: bool = True,
            has_dielectric: bool = True, sky_from_final_dir: bool = False,
            spp: int = 1, unroll_all: bool = False, track_idx: bool = False):
    """One (th, tw) block of pixels: raygen, the spp loop, the bounce loop
    and the sphere scan, with every ray's state in registers throughout.

    track_idx (the path-replay recorder, spp == 1): also store the winning
    sphere index per bounce (-1 on miss) into idx_refs[0][bounce]."""
    x_i, y_i = tc.pixel_coords(pl.program_id(0), pl.program_id(1), th=th,
                               tw=tw)
    x_f = x_i.astype(jnp.float32)
    y_f = y_i.astype(jnp.float32)
    x_u = x_i.astype(jnp.uint32)
    y_u = y_i.astype(jnp.uint32)

    cam = lambda c: cam_ref[0, c]
    time = time_ref[0, 0]

    state, o, d4 = tc.generate_rays(
        cam, x_f, y_f, x_u, y_u, height=height, width=width, time=time,
        normalize_defocus_dir=normalize_defocus_dir)
    d0 = (d4[0], d4[1], d4[2])
    primary_dy = d4[1]

    zero = jnp.zeros((th, tw), jnp.float32)
    one = zero + 1.0

    body = functools.partial(
        _sphere_bounce, sph_ref, kind_ref, zero, one, n_spheres=n_spheres,
        th=th, tw=tw, normalize_reflect_in=normalize_reflect_in,
        has_metal=has_metal, has_dielectric=has_dielectric,
        unroll_all=unroll_all, track_idx=track_idx)

    def bounce(b, carry):
        # whole-block early exit once every lane has escaped to the sky
        live = tc.any_lane(carry[4] > 0)
        if not track_idx:
            return jax.lax.cond(live, body, lambda c: c, carry)

        def traced(c):
            *c, bidx = body(c)
            return tuple(c), bidx

        def dead(c):
            return c, jnp.zeros((th, tw), jnp.int32) - 1

        carry, bidx = jax.lax.cond(live, traced, dead, carry)
        idx_refs[0][b] = bidx
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
        # SAMPLE_PER_FRAME > 1 (shader_sphere.wgsl:259-262): the SAME primary
        # ray is re-traced spp times with the RNG state THREADED across
        # samples, then the sum is averaged — matching the oracle renderer's
        # sample loop (rt/render/renderer.py:63-70) bit for bit.
        def sample(_, c):
            state, acc = c
            state, col = one_sample(state)
            return state, pm.add3(acc, col)
        _, col = jax.lax.fori_loop(0, spp, sample, (state, (zero, zero, zero)))
        # true divide (not reciprocal-multiply): x/3 and x*(1/3) round
        # differently, and the oracle divides (renderer.py:70)
        n = jnp.float32(spp)
        col = (col[0] / n, col[1] / n, col[2] / n)

    out_ref[0] = col[0]
    out_ref[1] = col[1]
    out_ref[2] = col[2]


def _flat_call(sph_table, kind_table, cam_row, time, *, height_pad,
               width_pad, th, tw, num_warps, interpret, track_idx, **kw):
    kernel = functools.partial(_kernel, th=th, tw=tw, track_idx=track_idx,
                               **kw)
    return tc.frame_call(
        kernel, (sph_table, kind_table, cam_row, time),
        height_pad=height_pad, width_pad=width_pad, th=th, tw=tw,
        num_warps=num_warps, interpret=interpret,
        record_bounces=kw["bounces"] if track_idx else 0)


_STATIC = ("n_spheres", "height", "width", "height_pad", "width_pad",
           "bounces", "normalize_defocus_dir", "normalize_reflect_in", "th",
           "tw", "num_warps", "has_metal", "has_dielectric",
           "sky_from_final_dir", "interpret")


@functools.partial(jax.jit, static_argnames=_STATIC + ("spp", "unroll_all"))
def render_color_spheres(sph_table, kind_table, cam_row, time, *,
                         n_spheres: int, height: int, width: int,
                         height_pad: int, width_pad: int,
                         bounces: int, normalize_defocus_dir: bool,
                         normalize_reflect_in: bool, th: int, tw: int,
                         num_warps: int, has_metal: bool = True,
                         has_dielectric: bool = True,
                         sky_from_final_dir: bool = False,
                         spp: int = 1, unroll_all: bool = False,
                         interpret: bool = False):
    """Returns planar (3, Hp, Wp) color for one frame (crop to H, W).

    height/width: REAL resolution (seed + uv math); height_pad/width_pad:
    block-aligned grid extent.  sph_table: (N, 8) f32, kind_table: (N, 1)
    i32, cam_row: (1, 20) f32, time: (1, 1) u32.
    """
    return _flat_call(
        sph_table, kind_table, cam_row, time, n_spheres=n_spheres,
        height=height, width=width, height_pad=height_pad,
        width_pad=width_pad, bounces=bounces,
        normalize_defocus_dir=normalize_defocus_dir,
        normalize_reflect_in=normalize_reflect_in, th=th, tw=tw,
        num_warps=num_warps, has_metal=has_metal,
        has_dielectric=has_dielectric, sky_from_final_dir=sky_from_final_dir,
        spp=spp, unroll_all=unroll_all, interpret=interpret,
        track_idx=False)


# ---------------------------------------------------------------------------
# Chunk-culled variant for LARGE sphere scenes (the ~490-sphere RTIOW cover
# scene, BASELINE config 3).  The reference caps scenes at 100 spheres
# (scene_sphere.rs:15) and scans them all per segment
# (intersect_all_sphere, shader_sphere.wgsl:218-229); past that cap a flat
# scan pays O(N) per segment.  This variant applies the triangle path's
# Morton-chunk machinery (rt/kernels/tris_kernel.py): spheres are sorted by
# center Morton code into chunks of 32, each chunk's AABB (center ± radius)
# is slab-tested against the whole tile front-to-back, and dead chunks are
# skipped with a scalar branch.  Closest hit is strict ``t < best`` so the
# reorder only affects measure-zero exact-t ties; per-pair arithmetic is
# identical to ``_sphere_bounce`` (asserted bit-level against the flat scan
# over the same Morton-ordered table in tests/test_kernels.py).
# ---------------------------------------------------------------------------


def _sphere_bounce_chunked(sph_ref, kind_ref, chunk_ref, order_ref, zero,
                           one, carry, *, chunk: int, n_chunks: int, th: int,
                           tw: int, normalize_reflect_in: bool,
                           has_metal: bool, has_dielectric: bool,
                           unroll: int = 1):
    """One bounce over a tile: front-to-back chunk-culled closest-hit sphere
    scan + scatter.  Same hit/scatter semantics as ``_sphere_bounce``."""
    state, o, d, atten, active = carry

    a = pm.dot3(d, d)
    two_a = 2.0 * a
    four_a = 4.0 * a
    izero = jnp.zeros((th, tw), jnp.int32)
    inv_d = (1.0 / d[0], 1.0 / d[1], 1.0 / d[2])

    def scan_sphere(si, best):
        # identical per-pair arithmetic to _sphere_bounce.scan_sphere —
        # padding rows carry radius = -1e30 (r*r overflows to +inf, so
        # cc = -inf, disc = +inf, t = -inf: a deterministic miss with no
        # NaNs anywhere in the chain)
        bt, bc, br, bal, bpar, bkind = best
        c = (zero + sph_ref[si, 0], zero + sph_ref[si, 1],
             zero + sph_ref[si, 2])
        r = sph_ref[si, 3]
        oc = pm.sub3(o, c)
        b = 2.0 * pm.dot3(oc, d)
        cc = pm.dot3(oc, oc) - r * r
        disc = b * b - four_a * cc
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t = (-b - sq) / two_a
        t = jnp.where(disc < 0.0, jnp.float32(-1.0), t)
        better = (t > 0.0) & (t < bt)
        sel = lambda new, old: jnp.where(better, new, old)
        return (sel(t, bt),
                pm.where3(better, c, bc),
                sel(zero + r, br),
                pm.where3(better, (zero + sph_ref[si, 4],
                                   zero + sph_ref[si, 5],
                                   zero + sph_ref[si, 6]), bal),
                sel(zero + sph_ref[si, 7], bpar),
                jnp.where(better, izero + kind_ref[si, 0], bkind))

    def scan_chunk(oi, best):
        # front-to-back chunk visit order (precomputed from the camera eye)
        ci = order_ref[oi, 0]
        # slab test of the chunk AABB against every ray in the tile (WGSL
        # fmin/fmax semantics — rt/kernels/tris_kernel.py:_fmin)
        t0x = (chunk_ref[ci, 0] - o[0]) * inv_d[0]
        t1x = (chunk_ref[ci, 3] - o[0]) * inv_d[0]
        t0y = (chunk_ref[ci, 1] - o[1]) * inv_d[1]
        t1y = (chunk_ref[ci, 4] - o[1]) * inv_d[1]
        t0z = (chunk_ref[ci, 2] - o[2]) * inv_d[2]
        t1z = (chunk_ref[ci, 5] - o[2]) * inv_d[2]
        tmin = _cfmax(_cfmax(_cfmin(t0x, t1x), _cfmin(t0y, t1y)),
                      _cfmin(t0z, t1z))
        tmax = _cfmin(_cfmin(_cfmax(t0x, t1x), _cfmax(t0y, t1y)),
                      _cfmax(t0z, t1z))
        enter = (tmin <= tmax) & (tmax >= 0.0) & (tmin < best[0])
        live = (active > 0) & enter
        lo = ci * chunk

        def do(best):
            # ``unroll`` scans several spheres per iteration in the same
            # ascending order (bit-identical results) — ILP between the
            # serialized best-t select chains, as in the triangle kernel
            def body(kk, b):
                for uu in range(unroll):
                    b = scan_sphere(lo + kk * unroll + uu, b)
                return b
            return jax.lax.fori_loop(0, chunk // unroll, body, best)

        return jax.lax.cond(tc.any_lane(live), do, lambda b: b, best)

    best0 = (zero + FLT_MAX, (zero, zero, zero), one,
             (zero, zero, zero), zero, izero)
    bt, bc, br, bal, bpar, bkind = jax.lax.fori_loop(0, n_chunks, scan_chunk,
                                                     best0)

    hit = (active > 0) & (bt != FLT_MAX)

    point = pm.add3(o, pm.scale3(d, bt))
    normal = ((point[0] - bc[0]) / br, (point[1] - bc[1]) / br,
              (point[2] - bc[2]) / br)
    front_face = pm.dot3(d, normal) < 0.0
    normal = pm.where3(front_face, normal, pm.neg3(normal))

    ns, nd = tc.scatter(state, d, point, normal, front_face, bal, bpar,
                        bkind, normalize_reflect_in=normalize_reflect_in,
                        has_metal=has_metal,
                        has_dielectric=has_dielectric)

    state = jnp.where(hit, ns, state)
    o = pm.where3(hit, point, o)
    d = pm.where3(hit, nd, d)
    atten = pm.where3(hit, pm.scale3(pm.mul3(atten, bal), 0.7), atten)
    return (state, o, d, atten, hit.astype(jnp.int32))


def _cfmin(a, b):
    """WGSL min (NaN-dropping) — as in the triangle kernel's slab test."""
    return jnp.where(jnp.isnan(a) | (b < a), b, a)


def _cfmax(a, b):
    return jnp.where(jnp.isnan(a) | (b > a), b, a)


def _spread10(v):
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def pack_spheres_chunked(sph_table, kind_table, n: int, chunk: int = 32):
    """Morton-sort the (N, 8) sphere table by center, pad to a chunk
    multiple, and build per-chunk AABBs (center ± radius over real rows).

    Padding rows have radius = -1e30: ``r*r`` overflows to +inf so the
    quadratic's ``cc`` term is -inf and the candidate t is -inf — a
    deterministic miss with no NaN in the select chain.  Padding never
    widens a chunk AABB (masked min/max below).
    """
    sph = sph_table[:n]
    kinds = kind_table[:n]
    c = sph[:, 0:3]
    lo = c.min(axis=0)
    span = jnp.maximum(c.max(axis=0) - lo, 1e-12)
    q = jnp.clip((c - lo) / span * 1023.0, 0, 1023).astype(jnp.uint32)
    code = ((_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1)
            | _spread10(q[:, 2]))
    order = jnp.argsort(code, stable=True)
    sph = sph[order]
    kinds = kinds[order]

    n_pad = -(-n // chunk) * chunk
    if n_pad != n:
        pad = jnp.zeros((n_pad - n, SPH_COLS), jnp.float32)
        pad = pad.at[:, 3].set(-1e30)
        sph = jnp.concatenate([sph, pad])
        kinds = jnp.concatenate([kinds,
                                 jnp.zeros((n_pad - n, 1), jnp.int32)])

    ctr = sph[:, 0:3]
    rad = sph[:, 3:4]
    real = (jnp.arange(n_pad) < n)[:, None]
    big = jnp.float32(3.0e38)
    bmin = jnp.where(real, ctr - rad, big).reshape(-1, chunk, 3).min(axis=1)
    bmax = jnp.where(real, ctr + rad, -big).reshape(-1, chunk, 3).max(axis=1)
    aabbs = jnp.concatenate([bmin, bmax], axis=1).astype(jnp.float32)
    return sph, kinds, aabbs, n_pad, aabbs.shape[0]


def _kernel_chunked(sph_ref, kind_ref, chunk_ref, order_ref, cam_ref,
                    time_ref, out_ref, *, n_chunks: int, chunk: int,
                    height: int, width: int, th: int, tw: int, bounces: int,
                    normalize_defocus_dir: bool, normalize_reflect_in: bool,
                    has_metal: bool = True, has_dielectric: bool = True,
                    sky_from_final_dir: bool = False, spp: int = 1,
                    unroll: int = 1):
    x_i, y_i = tc.pixel_coords(pl.program_id(0), pl.program_id(1), th=th,
                               tw=tw)
    cam = lambda c: cam_ref[0, c]
    state, o, d4 = tc.generate_rays(
        cam, x_i.astype(jnp.float32), y_i.astype(jnp.float32),
        x_i.astype(jnp.uint32), y_i.astype(jnp.uint32),
        height=height, width=width, time=time_ref[0, 0],
        normalize_defocus_dir=normalize_defocus_dir)
    d0 = (d4[0], d4[1], d4[2])
    primary_dy = d4[1]

    zero = jnp.zeros((th, tw), jnp.float32)
    one = zero + 1.0

    body = functools.partial(
        _sphere_bounce_chunked, sph_ref, kind_ref, chunk_ref, order_ref,
        zero, one, chunk=chunk, n_chunks=n_chunks, th=th, tw=tw,
        normalize_reflect_in=normalize_reflect_in, has_metal=has_metal,
        has_dielectric=has_dielectric, unroll=unroll)

    def bounce(_, carry):
        return jax.lax.cond(tc.any_lane(carry[4] > 0), body, lambda c: c,
                            carry)

    def one_sample(state):
        carry = (state, o, d0, (one, one, one),
                 jnp.ones((th, tw), jnp.int32))
        state, _, d, atten, _ = jax.lax.fori_loop(0, bounces, bounce, carry)
        return state, tc.sky_times_atten(
            d[1] if sky_from_final_dir else primary_dy, atten)

    if spp == 1:
        _, col = one_sample(state)
    else:
        def sample(_, c):
            state, acc = c
            state, col = one_sample(state)
            return state, pm.add3(acc, col)
        _, col = jax.lax.fori_loop(0, spp, sample,
                                   (state, (zero, zero, zero)))
        nf = jnp.float32(spp)
        col = (col[0] / nf, col[1] / nf, col[2] / nf)

    out_ref[0] = col[0]
    out_ref[1] = col[1]
    out_ref[2] = col[2]


@functools.partial(jax.jit,
                   static_argnames=_STATIC + ("spp", "chunk", "unroll"))
def render_color_spheres_chunked(sph_table, kind_table, cam_row, time, *,
                                 n_spheres: int, height: int, width: int,
                                 height_pad: int, width_pad: int,
                                 bounces: int, normalize_defocus_dir: bool,
                                 normalize_reflect_in: bool, th: int,
                                 tw: int, num_warps: int, chunk: int = 32,
                                 has_metal: bool = True,
                                 has_dielectric: bool = True,
                                 sky_from_final_dir: bool = False,
                                 spp: int = 1, unroll: int = 4,
                                 interpret: bool = False):
    """Planar (3, Hp, Wp) color for one frame — Morton-chunk-culled sphere
    scan for scenes past the reference's 100-sphere cap."""
    sph, kinds, aabbs, n_pad, n_chunks = pack_spheres_chunked(
        sph_table, kind_table, n_spheres, chunk)
    # approximate front-to-back chunk order from the camera eye (as in the
    # triangle path — order only affects pruning, not the closest hit)
    eye = cam_row[0, 0:3]
    centroid = (aabbs[:, 0:3] + aabbs[:, 3:6]) * 0.5
    dist = jnp.sum((centroid - eye) ** 2, axis=1)
    order = jnp.argsort(dist).astype(jnp.int32)[:, None]   # (n_chunks, 1)

    kernel = functools.partial(
        _kernel_chunked, n_chunks=n_chunks, chunk=chunk, height=height,
        width=width, th=th, tw=tw, bounces=bounces,
        normalize_defocus_dir=normalize_defocus_dir,
        normalize_reflect_in=normalize_reflect_in, has_metal=has_metal,
        has_dielectric=has_dielectric, sky_from_final_dir=sky_from_final_dir,
        spp=spp, unroll=unroll)
    return tc.frame_call(
        kernel, (sph, kinds, aabbs, order, cam_row, time),
        height_pad=height_pad, width_pad=width_pad, th=th, tw=tw,
        num_warps=num_warps, interpret=interpret)


@functools.partial(jax.jit, static_argnames=_STATIC)
def render_color_spheres_record(sph_table, kind_table, cam_row, time, *,
                                n_spheres: int, height: int, width: int,
                                height_pad: int, width_pad: int,
                                bounces: int, normalize_defocus_dir: bool,
                                normalize_reflect_in: bool, th: int, tw: int,
                                num_warps: int, has_metal: bool = True,
                                has_dielectric: bool = True,
                                sky_from_final_dir: bool = False,
                                interpret: bool = False):
    """(color (3, Hp, Wp) f32, hit indices (bounces, Hp, Wp) i32) — the
    forward render plus the per-bounce winning sphere index stream that
    the path-replay backward (rt/grad/replay.py) consumes.  Same kernel body
    as render_color_spheres, so the color is bit-identical to it."""
    return _flat_call(
        sph_table, kind_table, cam_row, time, n_spheres=n_spheres,
        height=height, width=width, height_pad=height_pad,
        width_pad=width_pad, bounces=bounces,
        normalize_defocus_dir=normalize_defocus_dir,
        normalize_reflect_in=normalize_reflect_in, th=th, tw=tw,
        num_warps=num_warps, has_metal=has_metal,
        has_dielectric=has_dielectric, sky_from_final_dir=sky_from_final_dir,
        interpret=interpret, track_idx=True)
