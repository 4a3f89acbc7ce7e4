"""The jit-compiled render graph + progressive accumulation state.

Functional replacement for the reference's Renderer (src/renderer.rs):

- the wgpu device/pipeline/bind groups become a jitted pure function
  ``render_frame(scene, camera, state, time) -> state`` compiled once per
  (scene shape, config) and cached by XLA;
- GPU buffers become a ``RenderState`` pytree {image (H, W, 3) f32,
  frame_count u32} living on device;
- the EMA accumulation (shader_sphere.wgsl:266-271):
      w   = 1 / (min(frame_count, SAMPLE_FRAME) + 1)
      new = mix(old, color, w)
- the progressive-rendering invariant (src/renderer.rs:336-348): any camera /
  scene change must zero both the accumulator and frame_count —
  ``ProgressiveRenderer.reset()``;
- resize reallocates the accumulator and resets (renderer.rs:271-313).

Backends: "jax" (pure-JAX oracle, runs anywhere) and "pallas"
(the fused GPU kernels of rt.kernels).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rt.config import RenderConfig
from rt.core import camera as camera_mod
from rt.core import sphere as sphere_mod
from rt.core import triangle as triangle_mod
from rt.core.trace import trace
from rt.core.vecmath import mix


class RenderState(NamedTuple):
    image: jnp.ndarray        # (H, W, 3) f32 linear accumulator
    frame_count: jnp.ndarray  # () u32


def init_state(config: RenderConfig) -> RenderState:
    return RenderState(
        image=jnp.zeros((config.height, config.width, 3), jnp.float32),
        frame_count=jnp.uint32(0))


def render_color(scene, camera, config: RenderConfig, time):
    """One frame's per-pixel color (H, W, 3) — fs_main minus accumulation."""
    state, origin, direction = camera_mod.generate_primary_rays(
        camera, config.width, config.height, time,
        config.normalize_defocus_dir)

    if isinstance(scene, sphere_mod.SphereArray):
        intersect = partial(sphere_mod.intersect_all_spheres, scene)
        hit_rec = partial(sphere_mod.hit_record, scene)
    else:
        intersect = partial(triangle_mod.intersect_all_bvh, scene)
        hit_rec = partial(triangle_mod.hit_record, scene)

    color = jnp.zeros((config.height, config.width, 3), jnp.float32)
    for _ in range(config.samples_per_frame):
        state, c = trace(intersect, lambda o, d, t, i: hit_rec(o, d, t, i),
                         state, origin, direction,
                         bounces=config.bounces,
                         normalize_reflect_in=config.normalize_reflect_in,
                         sky_from_final_dir=config.sky_from_final_dir)
        color = color + c
    return color / config.samples_per_frame


@partial(jax.jit, static_argnames=("config",))
def render_frame(scene, camera, state: RenderState, time,
                 config: RenderConfig) -> RenderState:
    """draw(): trace every pixel once and EMA-accumulate."""
    if config.backend == "pallas":
        from rt.kernels import dispatch as kernel_dispatch
        color = kernel_dispatch.render_color(scene, camera, config, time,
                                             interpret=config.interpret)
    else:
        color = render_color(scene, camera, config, time)
    fc = jnp.minimum(state.frame_count, jnp.uint32(config.sample_frame))
    w = 1.0 / (fc.astype(jnp.float32) + 1.0)
    image = mix(state.image, color, w)
    return RenderState(image=image, frame_count=state.frame_count + 1)


@partial(jax.jit, static_argnames=("config", "n_frames"))
def render_frames(scene, camera, state: RenderState, time0, time_step,
                  config: RenderConfig, n_frames: int) -> RenderState:
    """N progressive frames in ONE compiled call (lax.scan over the frame
    loop) — amortizes dispatch latency and lets XLA pipeline tiles across
    frames.  Equivalent to n_frames render_frame calls with
    time = time0 + i*time_step (the test harness's 1000,1010,... schedule).
    """
    time0 = jnp.asarray(time0, jnp.uint32)
    time_step = jnp.asarray(time_step, jnp.uint32)

    def step(state, i):
        t = time0 + i * time_step
        return render_frame(scene, camera, state, t, config), None

    state, _ = jax.lax.scan(step, state,
                            jnp.arange(n_frames, dtype=jnp.uint32))
    return state


class ProgressiveRenderer:
    """Stateful convenience wrapper mirroring the reference Renderer's
    host-side API (draw / set_time / reset_frame_count / resize /
    update_camera), wrapping the functional core."""

    def __init__(self, scene_def):
        self.scene_def = scene_def
        self.camera = scene_def.camera
        self.config = scene_def.config
        self.time = 0
        self.state = init_state(self.config)

    def set_time(self, time: int):
        self.time = int(time) & 0xFFFFFFFF

    def update_camera(self, camera):
        """src/scene/mod.rs update_camera — does NOT auto-reset, matching the
        reference (the app resets explicitly on movement, app.rs:134-137)."""
        self.camera = camera

    def reset_frame_count(self):
        """renderer.rs:336-348 — zero accumulator AND frame count."""
        self.state = init_state(self.config)

    def resize(self, width: int, height: int):
        import dataclasses
        self.config = dataclasses.replace(self.config, width=width, height=height)
        self.state = init_state(self.config)

    def draw(self):
        self.state = render_frame(self.scene_def.scene, self.camera,
                                  self.state, jnp.uint32(self.time),
                                  self.config)

    def draw_frames(self, n_frames: int, time_step: int = 10):
        """n progressive frames in one compiled call, starting at the
        current time uniform; advances time past the last frame."""
        self.state = render_frames(self.scene_def.scene, self.camera,
                                   self.state, jnp.uint32(self.time),
                                   jnp.uint32(time_step), self.config,
                                   n_frames)
        self.time = (self.time + n_frames * time_step) & 0xFFFFFFFF

    @property
    def image(self):
        return jax.device_get(self.state.image)

    @property
    def frame_count(self) -> int:
        return int(self.state.frame_count)
