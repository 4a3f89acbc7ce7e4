"""Triangle mesh (SoA), Möller–Trumbore intersection, and the vectorized
stackless BVH traversal.

Replicates shader_tris.wgsl:

- ``intersect_triangle`` (:161-202): Möller–Trumbore with EPSILON = 1e-4,
  closest-hit update (accept t >= EPSILON and t < best), FLAT face normal
  from the BVH build, and the INVERTED convention
  ``front_face = dot(normal, dir) > 0`` with no normal flip;
- ``intersect_node`` (:150-159): slab AABB test with NaN-forgiving min/max
  (WGSL min/max return the non-NaN operand — jnp.fmin/fmax);
- ``intersect_all_node`` (:268-301): stackless implicit-heap walk starting at
  node 1 (descend = i*2 on AABB hit; leaf j = i - n; ascend by stripping
  trailing 1-bits then +1), capped at 600 steps.

The walk is lane-parallel: every pixel carries its own node pointer ``i`` and
a done flag; iterations are globally synchronized (the reference's ``step``
counter increments once per loop for every thread, so a shared loop with
per-lane masking is semantics-preserving).  The inner ascent
``while (i & 1) == 1 { i /= 2 }`` is closed-form:
``i >>= count_trailing_ones(i)`` via population_count — no inner loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rt.config import BVH_MAX_STEPS, EPSILON_TRIS, FLT_MAX
from rt.core.vecmath import cross, dot


class TriangleScene(NamedTuple):
    """SoA mesh + implicit-heap BVH + material table (device pytree).

    n = padded node count (power of two), m = triangle count — the
    ``bvh_tree_size`` uniform (shader_tris.wgsl:25-26).  Static ints so jit
    specializes per mesh, like the reference's per-scene pipeline.
    """

    a: jnp.ndarray        # (m, 3) f32 vertex A
    b: jnp.ndarray        # (m, 3)
    c: jnp.ndarray        # (m, 3)
    normal: jnp.ndarray   # (m, 3) flat face normal (post-build `custom`)
    mat_id: jnp.ndarray   # (m,)  i32
    bmin: jnp.ndarray     # (n, 3) node AABB minima (node 0 unused)
    bmax: jnp.ndarray     # (n, 3)
    mat_albedo: jnp.ndarray  # (K, 3)
    mat_param: jnp.ndarray   # (K,)
    mat_kind: jnp.ndarray    # (K,) u32

    @property
    def n(self) -> int:
        return self.bmin.shape[0]

    @property
    def m(self) -> int:
        return self.a.shape[0]


def moller_trumbore(origin, direction, a, b, c, best_t):
    """Batched M-T test of one triangle per lane.

    a/b/c: (..., 3) (already gathered per lane).  Returns (valid, t):
    valid where all the reference's early-exit conditions pass AND t < best_t.
    """
    edge1 = b - a
    edge2 = c - a
    h = cross(direction, edge2)
    det = dot(edge1, h)
    inv_det = 1.0 / det
    s = origin - a
    u = inv_det * dot(s, h)
    q = cross(s, edge1)
    v = inv_det * dot(direction, q)
    t = inv_det * dot(edge2, q)
    valid = (jnp.abs(det) >= EPSILON_TRIS)
    valid &= (u >= 0.0) & (u <= 1.0)
    valid &= (v >= 0.0) & (u + v <= 1.0)
    valid &= (t >= EPSILON_TRIS) & (t < best_t)
    return valid, t


def intersect_node_mask(origin, direction, bmin, bmax):
    """Slab test (shader_tris.wgsl:150-159). bmin/bmax: (..., 3) gathered."""
    inv_d = 1.0 / direction
    t0 = (bmin - origin) * inv_d
    t1 = (bmax - origin) * inv_d
    tmin = jnp.fmin(t0, t1)   # WGSL min/max: NaN loses
    tmax = jnp.fmax(t0, t1)
    tmin_f = jnp.max(tmin, axis=-1)
    tmax_f = jnp.min(tmax, axis=-1)
    return (tmin_f <= tmax_f) & (tmax_f >= 0.0)


def _trailing_ones(i):
    """count of low-order 1-bits of i (uint32), via population_count."""
    x = i + jnp.uint32(1)
    low = x & (~x + jnp.uint32(1))      # lowest set bit of i+1
    return jax.lax.population_count(low - jnp.uint32(1))


def intersect_all_bvh(scene: TriangleScene, origin, direction):
    """Lane-parallel replica of intersect_all_node (shader_tris.wgsl:268-301).

    Returns (t, tri_idx): t == FLT_MAX where no triangle was hit,
    tri_idx == -1 there.
    """
    n = jnp.uint32(scene.n)
    m = jnp.uint32(scene.m)
    shape = origin.shape[:-1]

    i0 = jnp.full(shape, 1, jnp.uint32)
    t0 = jnp.full(shape, FLT_MAX, jnp.float32)
    idx0 = jnp.full(shape, -1, jnp.int32)
    done0 = jnp.zeros(shape, jnp.bool_)
    if scene.m == 0:
        return t0, idx0

    def cond(carry):
        step, i, best_t, best_i, done = carry
        return (step < BVH_MAX_STEPS) & jnp.logical_not(jnp.all(done))

    def body(carry):
        step, i, best_t, best_i, done = carry
        is_node = i < n
        # gather node AABB (clamped index for lanes at leaves / done)
        ni = jnp.clip(i, 0, n - jnp.uint32(1)).astype(jnp.int32)
        node_hit = intersect_node_mask(origin, direction,
                                       scene.bmin[ni], scene.bmax[ni])
        descend = jnp.logical_not(done) & is_node & node_hit

        # leaf handling
        j = i - n
        at_leaf = jnp.logical_not(done) & jnp.logical_not(is_node)
        leaf_oob = at_leaf & (j >= m)          # `break` in the reference
        tri_mask = at_leaf & (j < m)
        tj = jnp.clip(j, 0, m - jnp.uint32(1)).astype(jnp.int32)
        valid, t = moller_trumbore(origin, direction,
                                   scene.a[tj], scene.b[tj], scene.c[tj],
                                   best_t)
        take = tri_mask & valid
        best_t = jnp.where(take, t, best_t)
        best_i = jnp.where(take, tj, best_i)

        # ascent (for non-descending, non-finished lanes)
        k = _trailing_ones(i)
        i_up = i >> k
        asc_root = i_up == jnp.uint32(0)       # climbed past the root
        i_asc = i_up + jnp.uint32(1)

        new_done = done | leaf_oob | (jnp.logical_not(descend)
                                      & jnp.logical_not(done) & asc_root)
        new_i = jnp.where(descend, i * jnp.uint32(2),
                          jnp.where(done | leaf_oob, i, i_asc))
        return step + 1, new_i, best_t, best_i, new_done

    carry = (jnp.int32(0), i0, t0, idx0, done0)
    _, _, best_t, best_i, _ = jax.lax.while_loop(cond, body, carry)
    return best_t, best_i


def intersect_all_bruteforce(scene: TriangleScene, origin, direction):
    """Closest hit by scanning every triangle (no BVH, no 600-step cap).
    Same closest hit as the walk except tie-order and the cap's truncation
    — the semantics the chunk-scanning Pallas kernels implement.
    """
    def body(k, carry):
        best_t, best_i = carry
        valid, t = moller_trumbore(origin, direction,
                                   scene.a[k], scene.b[k], scene.c[k], best_t)
        return jnp.where(valid, t, best_t), jnp.where(valid, k, best_i)

    best_t = jnp.full(origin.shape[:-1], FLT_MAX, jnp.float32)
    best_i = jnp.full(origin.shape[:-1], -1, jnp.int32)
    return jax.lax.fori_loop(0, scene.m, body, (best_t, best_i))


def hit_record(scene: TriangleScene, origin, direction, t, idx):
    """HitRecord fields for the winning triangle (shader_tris.wgsl:197-201).

    Flat normal, NO flip; front_face = dot(normal, dir) > 0 (inverted
    convention, replicated)."""
    i = jnp.clip(idx, 0, scene.m - 1)
    normal = scene.normal[i]
    mid = jnp.clip(scene.mat_id[i], 0, scene.mat_albedo.shape[0] - 1)
    # Pin the miss-lane FLT_MAX sentinel (same reverse-mode NaN guard as
    # sphere.hit_record: FLT_MAX * d overflows, callers mask on t anyway).
    t_safe = jnp.where(t == FLT_MAX, jnp.float32(1.0), t)
    return {
        "point": origin + t_safe[..., None] * direction,
        "normal": normal,
        "front_face": dot(normal, direction) > 0.0,
        "albedo": scene.mat_albedo[mid],
        "mat_param": scene.mat_param[mid],
        "mat_kind": scene.mat_kind[mid],
    }
