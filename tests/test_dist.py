"""Multi-device sharding tests on the 8-virtual-CPU-device mesh (conftest
forces --xla_force_host_platform_device_count=8).

The invariant that makes sharded rendering trivially correct: per-pixel RNG
seeds depend only on (x, y, time) — rt/core/rng.seed — so splitting pixel
rows across chips changes nothing numerically.  Sharded output must equal
the single-device render BITWISE.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt.dist import (gather_image, image_sharding, make_mesh, shard_scene,
                     shard_state, sharded_render_frame)
from rt.render.renderer import init_state, render_frame
from rt.scene import scenes

W, H = 128, 64  # H divisible by 8 devices


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(jax.devices()[:8])


def small(builder, bounces):
    sd = builder(W, H)
    return dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=bounces))


@pytest.mark.parametrize("builder,bounces", [
    (scenes.test_scene_metal, 3),
    (scenes.scene_cube, 2),
])
def test_sharded_render_bitwise_equal(mesh, builder, bounces):
    sd = small(builder, bounces)
    t = jnp.uint32(1000)

    ref = render_frame(sd.scene, sd.camera, init_state(sd.config), t, sd.config)

    step = sharded_render_frame(mesh)
    state = shard_state(init_state(sd.config), mesh)
    scene = shard_scene(sd.scene, mesh)
    camera = shard_scene(sd.camera, mesh)
    out = step(scene, camera, state, t, sd.config)

    np.testing.assert_array_equal(np.asarray(ref.image), gather_image(out))
    assert int(out.frame_count) == 1


def test_progressive_sharded_frames(mesh):
    """Multi-frame progressive accumulation with the image left sharded
    between frames (zero per-frame collectives)."""
    sd = small(scenes.test_scene_metal, 3)
    step = sharded_render_frame(mesh)
    state = shard_state(init_state(sd.config), mesh)
    scene = shard_scene(sd.scene, mesh)
    camera = shard_scene(sd.camera, mesh)

    ref_state = init_state(sd.config)
    for i in range(3):
        t = jnp.uint32(1000 + 10 * i)
        state = step(scene, camera, state, t, sd.config)
        ref_state = render_frame(sd.scene, sd.camera, ref_state, t, sd.config)

    np.testing.assert_array_equal(np.asarray(ref_state.image),
                                  gather_image(state))
    # the sharding survived the frame loop
    assert state.image.sharding.is_equivalent_to(image_sharding(mesh), 3)


def test_sharded_train_step_runs(mesh):
    """The full inverse-rendering step under a 2-D mesh (dryrun path)."""
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_sample_sharded_render_matches_sequential(mesh):
    """SP mode: 8 devices, one time uniform each, pmean over the mesh == the
    uniform average of 8 sequential single-frame renders."""
    from rt.dist.sharding import sample_sharded_render
    from rt.render.renderer import render_color

    sd = small(scenes.test_scene_metal, 3)
    times = jnp.arange(1000, 1080, 10, dtype=jnp.uint32)
    step = sample_sharded_render(mesh)
    out = np.asarray(step(sd.scene, sd.camera, times, sd.config))

    seq = [np.asarray(render_color(sd.scene, sd.camera, sd.config, t))
           for t in times]
    np.testing.assert_allclose(out, np.mean(seq, axis=0), atol=2e-6, rtol=0)


def test_fit_replay_sharded_matches_unsharded(mesh):
    """BASELINE config 5's multi-device form: ``fit_replay(mesh=...)``
    shards the recorded hit stream / target by image row, keeps params
    replicated, and lets the scalar loss mean psum the gradients.  Losses
    must match the unsharded loop (same graph up to reduction order)."""
    from rt.grad.train import fit_replay

    sd = small(scenes.test_scene_metal, 3)
    from rt.render.renderer import render_color
    target = render_color(sd.scene, sd.camera, sd.config, jnp.uint32(1000))

    bad = sd.scene._replace(
        albedo=sd.scene.albedo.at[1].set(jnp.array([0.9, 0.1, 0.1],
                                                   jnp.float32)))
    kw = dict(steps=4, rerecord_every=2, learning_rate=5e-2,
              recorder="oracle")
    _, losses_ref = fit_replay(bad, sd.camera, sd.config, target, **kw)
    _, losses_sh = fit_replay(bad, sd.camera, sd.config, target, mesh=mesh,
                              **kw)
    np.testing.assert_allclose(losses_sh, losses_ref, rtol=2e-5, atol=1e-8)
