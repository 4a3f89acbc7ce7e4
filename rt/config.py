"""Render configuration.

The reference hardcodes all knobs as WGSL ``const`` / Rust ``const``
(src/shaders/shader_sphere.wgsl:10-12, shader_tris.wgsl:11-13,
src/renderer.rs:18, src/scene/scene_sphere.rs:15, src/scene/scene_tris.rs:11-12).
The replacement is a frozen dataclass whose fields are
jit-static arguments: every field participates in the compilation cache key,
exactly like a shader recompile in the reference.
"""

from __future__ import annotations

import dataclasses

# Constants mirrored from the reference shaders.
SKY = (0.54, 0.86, 0.92)  # shader_sphere.wgsl:8
BLUE = (0.54, 0.7, 0.98)  # shader_sphere.wgsl:9
SAMPLE_FRAME = 1000       # shader_sphere.wgsl:10 — EMA saturation frame
SAMPLE_PER_FRAME = 1      # shader_sphere.wgsl:11
BOUNCE_MAX_SPHERE = 10    # shader_sphere.wgsl:12
BOUNCE_MAX_TRIS = 5       # shader_tris.wgsl:13
EPSILON_SPHERE = 1e-6     # shader_sphere.wgsl:3
EPSILON_TRIS = 1e-4       # shader_tris.wgsl:3
FLT_MAX = 3.40282e38      # shader_sphere.wgsl:4 (the shader's own constant,
                          # NOT float32 max — replicated verbatim)
BVH_MAX_STEPS = 600       # shader_tris.wgsl:274 — traversal step cap
MAX_SPHERES = 100         # src/scene/scene_sphere.rs:15 (buffer is always
                          # this long; unused slots are zero — the shader
                          # scans arrayLength == 100 spheres)
MAX_TRIS = 1_000_000      # src/scene/scene_tris.rs:11
MAX_MATS = 1000           # src/scene/scene_tris.rs:12

MAT_LAMBERTIAN = 1        # src/scene/material.rs:4
MAT_METAL = 2             # src/scene/material.rs:5
MAT_DIELECTRIC = 3        # src/scene/material.rs:6


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) render parameters.

    width/height — image resolution (src/renderer.rs resolution uniform).
    bounces      — max path depth (BOUNCE_MAX in the shaders).
    samples_per_frame — SAMPLE_PER_FRAME.
    sample_frame — EMA saturation count (SAMPLE_FRAME).
    normalize_defocus_dir — the tris shader normalizes the post-defocus ray
        direction (shader_tris.wgsl:146) while the sphere shader does not
        (shader_sphere.wgsl:133).  Behavioral fork replicated via this flag.
    normalize_reflect_in  — the sphere shader's metal scatter normalizes the
        incident direction before reflecting (shader_sphere.wgsl:180); the
        tris shader does not (shader_tris.wgsl:230).
    backend      — "jax" (pure-JAX oracle, runs anywhere) or "pallas"
                   (the fused whole-frame GPU kernels of rt.kernels, for
                   sphere and triangle scenes).
    """

    width: int = 512
    height: int = 512
    bounces: int = BOUNCE_MAX_SPHERE
    samples_per_frame: int = SAMPLE_PER_FRAME
    sample_frame: int = SAMPLE_FRAME
    normalize_defocus_dir: bool = False
    normalize_reflect_in: bool = True
    backend: str = "jax"
    # Number of live spheres in the padded MAX_SPHERES buffer (0 = scan all).
    # The oracle always scans the full buffer like the shader's arrayLength
    # loop; the Pallas kernel scans only the live prefix — identical results
    # except the measure-zero case of a ray exactly through a zero-radius
    # padding sphere's center.
    n_active_spheres: int = 0
    # Material kinds present in the scene (static): the Pallas kernels skip
    # scatter arms for absent kinds (a WGSL shader would be specialized the
    # same way at pipeline-creation time). The oracle always evaluates all
    # arms (masked), so results agree on every lane that can actually hit.
    mat_kinds: tuple = (MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC)
    # EXTENSION (default off = reference behavior): evaluate the sky term on
    # the FINAL bounced ray direction instead of the primary camera ray.
    # The reference quirk (shader_sphere.wgsl:241-242 reads `ray.dir`, the
    # ORIGINAL ray) makes pixel color piecewise-constant in geometry/pose —
    # with detached Monte-Carlo decisions there is NO continuous path from
    # sphere centers/radii (or camera, beyond the primary dir) to the color,
    # so exact-renderer geometry gradients are structurally zero.  The
    # standard RTIOW background semantics (sky of the escaped ray) restores
    # a continuous chain  center/radius -> t -> normal -> reflect/refract ->
    # final dir -> sky,  making geometry gradients FD-verifiable in the
    # EXACT transport (rt/grad, tests/test_grad.py geometry tests).
    sky_from_final_dir: bool = False
    # Run the Pallas kernels in interpret mode (CPU-executable reference
    # semantics) — lets the pallas backends be driven end-to-end on the
    # CPU (CLI --interpret, CPU tests).  No effect on the "jax" backend.
    interpret: bool = False

    @staticmethod
    def for_spheres(width: int = 512, height: int = 512, **kw) -> "RenderConfig":
        """Config matching shader_sphere.wgsl semantics."""
        kw.setdefault("bounces", BOUNCE_MAX_SPHERE)
        kw.setdefault("normalize_defocus_dir", False)
        kw.setdefault("normalize_reflect_in", True)
        return RenderConfig(width=width, height=height, **kw)

    @staticmethod
    def for_triangles(width: int = 512, height: int = 512, **kw) -> "RenderConfig":
        """Config matching shader_tris.wgsl semantics."""
        kw.setdefault("bounces", BOUNCE_MAX_TRIS)
        kw.setdefault("normalize_defocus_dir", True)
        kw.setdefault("normalize_reflect_in", False)
        return RenderConfig(width=width, height=height, **kw)

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height
