"""Pallas-kernel correctness: interpret-mode (CPU) parity against the
pure-JAX oracle, which itself has bit-exact golden parity with the reference
GPU renderer — so agreement here transfers golden correctness to the
kernel path.

Tolerance: almost all pixels agree to a few ULP; a handful of grazing-hit /
Schlick-Bernoulli pixels legitimately flip branches because XLA's compiled
oracle contracts the quadratic/Möller-Trumbore math into FMAs while the
kernel (and interpret mode) rounds each op — so the assertion combines a
pixel-fraction bound with the reference's own golden metric (mean abs diff
of u8 pixels, tests/rendering_tests.rs:84-131; acceptance there is 2%%, we
require 10x tighter)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from rt.kernels.dispatch import render_color as k_render
from rt.render.ppm import parity_metrics
from rt.render.renderer import render_color
from rt.scene import scenes

W, H = 64, 32


def _compare(sd, bounces, max_flip_frac=0.08, max_mae_pct=0.3, spp=1):
    sd = dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=bounces,
                                       samples_per_frame=spp))
    t = jnp.uint32(1000)
    a = np.asarray(render_color(sd.scene, sd.camera, sd.config, t))
    b = np.asarray(k_render(sd.scene, sd.camera, sd.config, t,
                            interpret=True))
    assert a.shape == b.shape == (sd.config.height, sd.config.width, 3)
    flips, mae_pct = parity_metrics(a, b)
    assert flips <= max_flip_frac, f"{flips:.2%} pixels flipped branches"
    assert mae_pct <= max_mae_pct, f"golden-metric {mae_pct:.3f}%"


@pytest.mark.parametrize("name,mae", [
    ("metal_materials", 0.3), ("lambertian_materials", 0.3),
    # dielectric: the Schlick Bernoulli makes branch flips likeliest, and at
    # 64x32 x 1 frame each flip weighs ~0.05% — still under the reference's
    # own 2% single-config acceptance (tests/rendering_tests.rs:11)
    ("dielectric_materials", 1.5), ("depth_of_field", 0.3)])
def test_sphere_kernel_matches_oracle(name, mae):
    _compare(scenes.GOLDEN_SCENES[name](W, H), bounces=4, max_mae_pct=mae)


def test_sphere_kernel_full_depth():
    _compare(scenes.test_scene_complex(W, H), bounces=10)


@pytest.mark.parametrize("builder,mae", [
    (scenes.scene_rtiow_one_sphere, 0.5),
    # three_spheres holds a dielectric: Schlick-Bernoulli branch flips weigh
    # ~0.05% each at 64x32 x 1 frame (same band as dielectric_materials)
    (scenes.scene_rtiow_three_spheres, 1.5)])
def test_baseline_config_scenes_match_oracle(builder, mae):
    """BASELINE configs 1-2 (RTIOW one-sphere / three-materials) render
    through the same flat sphere kernel; parity with the oracle."""
    _compare(builder(W, H), bounces=4, max_mae_pct=mae)


@pytest.mark.parametrize("builder", [scenes.scene_quad, scenes.scene_cube])
def test_tris_kernel_matches_oracle(builder):
    _compare(builder(W, H), bounces=3)


def test_tris_kernel_suzanne_chunked():
    """Suzanne: 979 tris -> 8 chunks of the implicit heap; exercises chunk
    culling + multi-mesh materials (lambertian/metal/dielectric)."""
    _compare(scenes.scene_suzanne(W, H), bounces=2)


def test_sphere_kernel_spp_matches_oracle():
    """samples_per_frame > 1: the in-kernel sample loop (same primary ray,
    RNG state threaded across samples, true-divide average) matches the
    oracle renderer's sample loop (rt/render/renderer.py:63-70) — the
    reference's SAMPLE_PER_FRAME semantics (shader_sphere.wgsl:259-262)."""
    _compare(scenes.test_scene_metal(W, H), bounces=4, spp=3)


@pytest.mark.parametrize("builder", [scenes.scene_cube,
                                     scenes.scene_suzanne])
def test_tris_kernel_spp_matches_oracle(builder):
    """spp loop in the triangle kernel (same primary ray, RNG state
    threaded across samples) matches the oracle's sample loop."""
    _compare(builder(W, H), bounces=3, spp=3)


def test_tris_kernel_nonaligned_resolution():
    """Triangle kernel: odd sizes pad to whole blocks and crop back."""
    sd = scenes.scene_cube(60, 28)
    sd = dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=3))
    t = jnp.uint32(1000)
    b = np.asarray(k_render(sd.scene, sd.camera, sd.config, t,
                            interpret=True))
    assert b.shape == (28, 60, 3)
    _compare(sd, bounces=3)


def test_nonaligned_resolution_padding():
    """Odd sizes pad to tile multiples and crop back."""
    sd = scenes.test_scene_metal(60, 28)
    sd = dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=3))
    t = jnp.uint32(1000)
    a = np.asarray(render_color(sd.scene, sd.camera, sd.config, t))
    b = np.asarray(k_render(sd.scene, sd.camera, sd.config, t,
                            interpret=True))
    assert b.shape == (28, 60, 3)
    np.testing.assert_allclose(a, b, atol=5e-7, rtol=0)


def test_render_frames_batched_equals_loop():
    """render_frames (scan) == N sequential render_frame calls."""
    from rt.render.renderer import init_state, render_frame, render_frames
    sd = scenes.test_scene_metal(W, H)
    sd = dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=3))
    s1 = init_state(sd.config)
    for i in range(3):
        s1 = render_frame(sd.scene, sd.camera, s1,
                          jnp.uint32(1000 + 10 * i), sd.config)
    s2 = render_frames(sd.scene, sd.camera, init_state(sd.config),
                       1000, 10, sd.config, 3)
    np.testing.assert_array_equal(np.asarray(s1.image), np.asarray(s2.image))
    assert int(s2.frame_count) == 3


def test_cover_scene_vmem_table_matches_oracle():
    """The ~490-sphere cover scene routes through the Morton-chunk-culled
    sphere kernel (dispatch switches past the reference's 100-sphere cap) —
    parity with the oracle must hold through that path too."""
    _compare(scenes.scene_sphere_cover(W, H), bounces=4, max_mae_pct=0.5)


def test_sphere_chunked_equals_flat_bitwise():
    """The chunk-culled sphere kernel must agree BITWISE with a flat scan
    over the SAME Morton-ordered padded table: per-pair arithmetic is
    identical, culling is conservative (a sphere is inside its chunk AABB),
    and ``tmin < best`` pruning only skips chunks that cannot improve the
    strict closest hit.  Exact-t ties across chunks are the only admissible
    divergence (measure-zero; none in this scene)."""
    import dataclasses as dc

    from rt.kernels.dispatch import (block_grid, pack_camera,
                                     pack_spheres_table)
    from rt.kernels.sphere_kernel import (pack_spheres_chunked,
                                          render_color_spheres,
                                          render_color_spheres_chunked)
    sd = scenes.scene_sphere_cover(W, H)
    cfg = dc.replace(sd.config, bounces=4)
    tab, kinds, n = pack_spheres_table(sd.scene)
    cam_row = pack_camera(sd.camera)
    t = jnp.uint32(1000).reshape(1, 1)
    h, w = cfg.height, cfg.width
    common = dict(height=h, width=w, bounces=cfg.bounces,
                  normalize_defocus_dir=cfg.normalize_defocus_dir,
                  normalize_reflect_in=cfg.normalize_reflect_in,
                  interpret=True, **block_grid(h, w))
    a = np.asarray(render_color_spheres_chunked(
        tab, kinds, cam_row, t, n_spheres=n, unroll=1, **common))
    # flat scan over the identical Morton-ordered padded table (padding rows
    # are deterministic misses: radius -1e30 makes the candidate t -inf)
    sph, kk, _, n_pad, _ = pack_spheres_chunked(tab, kinds, n)
    b = np.asarray(render_color_spheres(
        sph, kk, cam_row, t, n_spheres=n_pad, **common))
    np.testing.assert_array_equal(a, b)


def test_sphere_flat_unroll_all_bit_identical():
    """Fully unrolling the small-scene flat sphere scan (a Python loop
    instead of fori_loop, same ascending order) is bit-identical."""
    from rt.kernels.dispatch import (block_grid, pack_camera,
                                     pack_spheres_table)
    from rt.kernels.sphere_kernel import render_color_spheres
    sd = scenes.scene_sphere_simple(W, H)
    tab, kinds, n = pack_spheres_table(sd.scene)
    if 0 < sd.config.n_active_spheres < n:
        n = sd.config.n_active_spheres
    cam_row = pack_camera(sd.camera)
    t = jnp.uint32(1000).reshape(1, 1)
    common = dict(n_spheres=n, height=H, width=W, bounces=6,
                  normalize_defocus_dir=sd.config.normalize_defocus_dir,
                  normalize_reflect_in=sd.config.normalize_reflect_in,
                  interpret=True, **block_grid(H, W))
    a = np.asarray(render_color_spheres(tab, kinds, cam_row, t, **common))
    b = np.asarray(render_color_spheres(tab, kinds, cam_row, t,
                                        unroll_all=True, **common))
    np.testing.assert_array_equal(a, b)


def test_sphere_chunked_unroll_bit_identical():
    """Sphere-scan unrolling is a pure scheduling change (ascending order
    within the chunk is preserved) — bit-identical to unit stride."""
    from rt.kernels.dispatch import (block_grid, pack_camera,
                                     pack_spheres_table)
    from rt.kernels.sphere_kernel import render_color_spheres_chunked
    sd = scenes.scene_sphere_cover(W, H)
    tab, kinds, n = pack_spheres_table(sd.scene)
    cam_row = pack_camera(sd.camera)
    t = jnp.uint32(1000).reshape(1, 1)
    common = dict(n_spheres=n, height=H, width=W, bounces=4,
                  normalize_defocus_dir=sd.config.normalize_defocus_dir,
                  normalize_reflect_in=sd.config.normalize_reflect_in,
                  interpret=True, **block_grid(H, W))
    a = np.asarray(render_color_spheres_chunked(tab, kinds, cam_row, t,
                                                unroll=1, **common))
    b = np.asarray(render_color_spheres_chunked(tab, kinds, cam_row, t,
                                                unroll=4, **common))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("unroll", [2, 4, 8, 32])
def test_unroll_variants_bit_identical(unroll):
    """Triangle-scan unrolling is a pure scheduling change: strict t < best
    in ascending index order keeps results BIT-IDENTICAL to the unit-stride
    scan."""
    from rt.kernels.dispatch import block_grid, pack_camera
    from rt.kernels.tris_kernel import render_color_tris
    sd = scenes.scene_suzanne(64, 32)
    cam_row = pack_camera(sd.camera)
    t = jnp.uint32(1000).reshape(1, 1)
    common = dict(height=32, width=64, bounces=3, normalize_defocus_dir=True,
                  normalize_reflect_in=False, chunk=32, interpret=True,
                  **block_grid(32, 64))
    a = np.asarray(render_color_tris(sd.scene, cam_row, t, **common))
    b = np.asarray(render_color_tris(sd.scene, cam_row, t, unroll=unroll,
                                     **common))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("builder", [scenes.scene_sphere_simple,
                                     scenes.scene_sphere_cover,
                                     scenes.scene_suzanne])
def test_block_shape_bit_identical(builder):
    """The block shape only regroups rays: per-ray arithmetic is the same
    and the per-block chunk culling is conservative, so every block renders
    the same image bit for bit (the sweep on the card compares speed only).
    Compared as u32 bit patterns."""
    from rt.kernels import dispatch
    sd = builder(W, H)
    cfg = dataclasses.replace(sd.config, bounces=3)
    t = jnp.uint32(1000)
    bits = lambda x: np.asarray(x).view(np.uint32)
    a = k_render(sd.scene, sd.camera, cfg, t, interpret=True)
    old = dispatch.BLOCK
    try:
        dispatch.BLOCK = (8, 16, 4)
        b = k_render(sd.scene, sd.camera, cfg, t, interpret=True)
    finally:
        dispatch.BLOCK = old
    np.testing.assert_array_equal(bits(a), bits(b))


def test_row_band_equals_full_frame_rows():
    """A launch with row0 covers rows [row0, row0 + band) of the image with
    bit-identical rays — the property the row-band sharding
    (rt/dist/bands.py) rests on."""
    from rt.kernels.dispatch import block_grid, pack_camera
    from rt.kernels.tris_kernel import render_color_tris
    sd = scenes.scene_suzanne(W, H)
    cam_row = pack_camera(sd.camera)
    t = jnp.uint32(1000).reshape(1, 1)
    common = dict(height=H, width=W, bounces=3, normalize_defocus_dir=True,
                  normalize_reflect_in=False, interpret=True)
    full = np.asarray(render_color_tris(sd.scene, cam_row, t, **common,
                                        **block_grid(H, W)))
    band = np.asarray(render_color_tris(sd.scene, cam_row, t, row0=12,
                                        **common, **block_grid(8, W)))
    np.testing.assert_array_equal(band[:, :8, :W], full[:, 12:20, :W])
