"""DP sharding of the kernel render path (rt/dist/bands.py) on the
8-virtual-CPU-device mesh, Pallas kernels in interpret mode.

Each device runs the triangle kernel over its own row band (shard_map with
a row offset); the row-sharded image must equal the unsharded kernel
render BITWISE.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt.dist import make_mesh, sharded_band_render_frames, sharded_band_step
from rt.kernels.dispatch import render_color
from rt.scene import scenes

W, H = 128, 64  # H divisible by 8 devices


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(jax.devices()[:8])


def small(builder, bounces, spp=1):
    sd = builder(W, H)
    return dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=bounces,
                                       samples_per_frame=spp,
                                       backend="pallas", interpret=True))


def frames_ref(sd, times):
    return np.stack([np.asarray(render_color(sd.scene, sd.camera, sd.config,
                                             t, interpret=True))
                     for t in times])


@pytest.mark.parametrize("builder,bounces,spp", [
    (scenes.scene_cube, 3, 1),
    (scenes.scene_quad, 2, 1),
    (scenes.scene_cube, 2, 2),   # the in-kernel spp loop too
])
def test_sharded_wave_bitwise_equal(mesh, builder, bounces, spp):
    sd = small(builder, bounces, spp)
    times = jnp.asarray([1000, 1010], jnp.uint32)
    out = sharded_band_render_frames(sd.scene, sd.camera, sd.config, times,
                                     mesh)
    np.testing.assert_array_equal(frames_ref(sd, times), np.asarray(out))


def test_sharded_wave_step_matches_single_device(mesh):
    """Progressive EMA accumulation with the image left row-sharded across
    frames equals the SAME step on a 1-device mesh bitwise, and keeps its
    sharding.

    The 1-device reference (rather than a hand-rolled EMA loop) keeps both
    sides in the identical compiled structure: the EMA tail may
    FMA-contract with the graph it fuses into, so an eagerly-computed mix
    can differ by 1 ULP."""
    from rt.dist import image_sharding, shard_scene
    from rt.render.renderer import RenderState, init_state

    sd = small(scenes.scene_cube, 2)
    step = sharded_band_step(mesh)
    mesh1 = make_mesh(jax.devices()[:1])
    step1 = sharded_band_step(mesh1)

    img_s = image_sharding(mesh)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    state = RenderState(
        image=jax.device_put(init_state(sd.config).image, img_s),
        frame_count=jax.device_put(jnp.uint32(0), rep))
    scene = shard_scene(sd.scene, mesh)
    camera = shard_scene(sd.camera, mesh)
    ref_state = init_state(sd.config)

    for i in range(3):
        t = jnp.uint32(1000 + 10 * i)
        state = step(scene, camera, state, t, sd.config)
        ref_state = step1(sd.scene, sd.camera, ref_state, t, sd.config)

    np.testing.assert_array_equal(np.asarray(ref_state.image),
                                  np.asarray(state.image))
    assert int(state.frame_count) == 3
    assert state.image.sharding.is_equivalent_to(img_s, 3)
    # and the accumulated image tracks the unsharded per-frame colors to
    # float32 roundoff (1-ULP EMA contraction bound)
    ref2 = init_state(sd.config)
    for i in range(3):
        color = frames_ref(sd, [jnp.uint32(1000 + 10 * i)])[0]
        fc = jnp.minimum(ref2.frame_count, jnp.uint32(sd.config.sample_frame))
        w = 1.0 / (fc.astype(jnp.float32) + 1.0)
        ref2 = RenderState(image=ref2.image * (1.0 - w) + color * w,
                           frame_count=ref2.frame_count + 1)
    np.testing.assert_allclose(np.asarray(ref2.image),
                               np.asarray(state.image), atol=3e-7, rtol=0)


def test_sharded_wave_real_mesh(mesh):
    """A real multi-mesh scene (Suzanne, 1105 tris / 5 materials) shards
    bitwise too — the flagship scene's DP form."""
    sd = small(scenes.scene_suzanne, 2)
    times = jnp.asarray([1000], jnp.uint32)
    out = sharded_band_render_frames(sd.scene, sd.camera, sd.config, times,
                                     mesh)
    np.testing.assert_array_equal(frames_ref(sd, times), np.asarray(out))


def test_bad_height_raises(mesh):
    sd = small(scenes.scene_cube, 2)
    cfg = dataclasses.replace(sd.config, height=60)  # 60 % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        sharded_band_render_frames(sd.scene, sd.camera, cfg,
                                   jnp.asarray([1000], jnp.uint32), mesh)


def test_band_height_not_a_block_multiple(mesh):
    """A band whose height is not a multiple of the block height pads past
    its rows and crops back — still bitwise equal (56 / 8 = 7 rows)."""
    sd = small(scenes.scene_cube, 2)
    sd = dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, height=56))
    times = jnp.asarray([1000], jnp.uint32)
    out = sharded_band_render_frames(sd.scene, sd.camera, sd.config, times,
                                     mesh)
    assert out.shape == (1, 56, W, 3)
    np.testing.assert_array_equal(frames_ref(sd, times), np.asarray(out))
