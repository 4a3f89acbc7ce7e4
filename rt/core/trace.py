"""The bounce loop (`trace`) and sky — shader_sphere.wgsl:230-243 /
shader_tris.wgsl:303-316.

Light transport replicated exactly:
- multiplicative attenuation ``albedo.rgb * 0.7`` per bounce;
- loop breaks on miss (t == FLT_MAX); masked lanes freeze state;
- NO black on bounce exhaustion — the final color is always
  ``attenuation * sky(primary_ray.direction.y)``;
- sky gradient ``mix(SKY, BLUE, dir.y * 0.5 + 0.5)`` is UNCLAMPED and is
  evaluated on the original camera-ray direction, which in the sphere shader
  is unnormalized (|dir| ~ focal_length) — extrapolation is intentional.

The loop is a ``lax.fori_loop`` with per-lane active masks (SIMT
divergence as masked selects), usable unchanged inside Pallas kernels
and differentiable when unrolled via ``lax.scan`` (see rt.grad).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rt.config import BLUE, FLT_MAX, SKY
from rt.core.materials import scatter
from rt.core.vecmath import mix


def sky_color(primary_dir):
    """shader_sphere.wgsl:241-242."""
    t = primary_dir[..., 1] * 0.5 + 0.5
    return mix(jnp.array(SKY, jnp.float32), jnp.array(BLUE, jnp.float32),
               t[..., None])


def trace(intersect_fn, hit_record_fn, state, origin, direction, *,
          bounces: int, normalize_reflect_in: bool,
          sky_from_final_dir: bool = False):
    """Generic bounce loop.

    intersect_fn(origin, direction) -> (t, idx) with t == FLT_MAX on miss.
    hit_record_fn(origin, direction, t, idx) -> hit dict.
    Returns (new_state, color(...,3)).

    sky_from_final_dir: extension (RenderConfig.sky_from_final_dir) — sky on
    the last bounced direction (standard RTIOW) instead of the reference's
    primary-ray quirk.
    """
    atten = jnp.ones(origin.shape, jnp.float32)
    active = jnp.ones(origin.shape[:-1], jnp.bool_)
    primary_dir = direction

    def body(_, carry):
        state, o, d, atten, active = carry
        t, idx = intersect_fn(o, d)
        # reference miss test: abs(t - FLT_MAX) < EPSILON — t is exactly
        # FLT_MAX (the sentinel) iff nothing was hit.
        hit_mask = active & (t != FLT_MAX)
        hit = hit_record_fn(o, d, t, idx)
        ns, no, nd = scatter(state, o, d, hit,
                             normalize_reflect_in=normalize_reflect_in)
        m3 = hit_mask[..., None]
        state = jnp.where(hit_mask, ns, state)
        o = jnp.where(m3, no, o)
        d = jnp.where(m3, nd, d)
        atten = jnp.where(m3, atten * hit["albedo"] * 0.7, atten)
        return state, o, d, atten, hit_mask

    state, _, d, atten, _ = jax.lax.fori_loop(
        0, bounces, body, (state, origin, direction, atten, active))
    return state, atten * sky_color(d if sky_from_final_dir else primary_dir)
