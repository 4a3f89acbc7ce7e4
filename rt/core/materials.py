"""Material scatter — masked lane-parallel replica of the WGSL ``scatter``
switch (shader_sphere.wgsl:172-217 / shader_tris.wgsl:222-267).

Array design: no data-dependent branches.  All three material programs are
evaluated on every lane and the results selected with ``jnp.where`` — SIMT
divergence written as masked selects.

RNG-stream exactness (required for golden parity at 1 spp):

- lambertian and metal both consume exactly 3 draws (random_on_hemisphere);
- dielectric consumes 1 draw only when ``cannot_refract`` is false — WGSL
  ``||`` short-circuits, so ``cannot_refract || reflectance(..) > fract(rng)``
  skips the draw on total internal reflection;
- unknown material ids fall through to the dielectric code (default arm).

We therefore compute the 3-draw chain s0→s1→s2→s3 once, build each branch
from the values it would see, and select the per-lane final state:
lambertian/metal → s3; dielectric → s0 if cannot_refract else s1.

Scatter quirks replicated:
- hemisphere sampling normalizes a positive-octant rng_vec3 then sign-flips
  against the normal (uniform over a *biased* set — NOT cosine-weighted);
- the sphere shader's metal arm reflects ``normalize(ray.direction)`` while
  the tris shader reflects the raw direction (cfg.normalize_reflect_in);
- the dielectric arm uses the *raw* (possibly unnormalized) incident
  direction for cos_theta / refract, and ``ir -> 1/ir`` on front_face.
"""

from __future__ import annotations

import jax.numpy as jnp

from rt.config import MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_METAL
from rt.core import rng as rng_mod
from rt.core.vecmath import dot, fract, normalize, reflect, refract, schlick_reflectance


def random_on_hemisphere_values(f3, normal):
    """shader_sphere.wgsl:107-117 given the 3 pre-drawn floats ``f3``."""
    v = normalize(f3)
    # The `length(v) < EPSILON -> return normal` arm is dead for finite
    # inputs (normalize output has unit length); on an all-zero draw the
    # normalize yields NaN exactly as the GPU does.
    return jnp.where(dot(v, normal)[..., None] > 0.0, v, -v)


def scatter(state, ray_origin, ray_dir, hit, *, normalize_reflect_in: bool):
    """Returns (new_state, new_origin, new_direction).

    hit: dict from sphere.hit_record / triangle hit with keys
    point, normal, front_face, mat_param, mat_kind.
    """
    normal = hit["normal"]
    point = hit["point"]
    kind = hit["mat_kind"]
    param = hit["mat_param"]

    # --- shared 3-draw chain ---------------------------------------------
    s1, f1 = rng_mod.next_float(state)
    s2, f2 = rng_mod.next_float(s1)
    s3, f3 = rng_mod.next_float(s2)
    hemi = random_on_hemisphere_values(jnp.stack([f1, f2, f3], axis=-1), normal)

    # --- lambertian (shader_sphere.wgsl:174-177) -------------------------
    lam_dir = hemi

    # --- metal (shader_sphere.wgsl:178-182) ------------------------------
    refl_in = normalize(ray_dir) if normalize_reflect_in else ray_dir
    met_dir = normalize(reflect(refl_in, normal) + param[..., None] * hemi)

    # --- dielectric / default (shader_sphere.wgsl:183-216) ---------------
    # Grad guard: lambertian/metal lanes still EVALUATE this arm (masked
    # out below), and their param is fuzz (often 0) -> ir = 1/0 = inf ->
    # NaN primals inside the untaken branch, which poison normal/dir
    # cotangents in reverse mode (0 * NaN = NaN).  Pinning ir to 1 on those
    # lanes keeps the selected forward values bit-identical (the outer
    # select never reads die_dir there) and the backward finite.
    is_lam = kind == MAT_LAMBERTIAN
    is_met = kind == MAT_METAL
    param_die = jnp.where(is_lam | is_met, jnp.float32(1.0), param)
    ir = jnp.where(hit["front_face"], 1.0 / param_die, param_die)
    cos_theta = jnp.minimum(dot(-ray_dir, normal), 1.0)
    sin_theta = jnp.sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ir * sin_theta > 1.0
    use_reflect = cannot_refract | (schlick_reflectance(cos_theta, ir) > fract(f1))
    die_dir = jnp.where(use_reflect[..., None],
                        normalize(reflect(ray_dir, normal)),
                        normalize(refract(ray_dir, normal, ir)))
    die_state = jnp.where(cannot_refract, state, s1)

    # --- select by material id -------------------------------------------
    # dielectric AND any unknown id both take the dielectric path.
    new_dir = jnp.where(is_lam[..., None], lam_dir,
                        jnp.where(is_met[..., None], met_dir, die_dir))
    new_state = jnp.where(is_lam | is_met, s3, die_state)
    return new_state, point, new_dir
