"""Throughput regression guard — the analog of the reference's performance
test (tests/rendering_tests.rs:527-578: the 20-sphere ring scene at 512x512
must render TEST_FRAMES=1 frame in < 5 s on whatever GPU CI has).

This suite runs on CPU (conftest forces the host platform), so the guard
uses the pure-JAX oracle at a reduced resolution with a deliberately loose
bound: it exists to catch order-of-magnitude regressions (an accidental
de-vectorization, a gather slipping into the hot loop), not to benchmark.
GPU numbers live in PERF.md (from chip_smoke.py and bench.py runs).
"""

import time

import jax.numpy as jnp
import numpy as np

from rt.render.renderer import init_state, render_frame
from rt.scene import scenes

# 128x128 x 10 bounces x 21 spheres on one CPU core takes ~0.1-0.5 s via the
# vmapped oracle; 30 s only trips on a >50x regression (CI boxes vary).
BOUND_S = 30.0


def test_perf_guard_sphere_oracle():
    sd = scenes.test_scene_perf(128, 128)
    state = init_state(sd.config)
    t = jnp.uint32(1000)
    # compile excluded (the reference times warm GPU dispatches too — its
    # renderer/pipeline is built before the timer starts)
    state = render_frame(sd.scene, sd.camera, state, t, sd.config)
    np.asarray(state.image)

    t0 = time.perf_counter()
    state = render_frame(sd.scene, sd.camera, state, jnp.uint32(1010),
                         sd.config)
    np.asarray(state.image)
    dt = time.perf_counter() - t0
    assert dt < BOUND_S, f"perf regression: 128x128 oracle frame took {dt:.2f}s"
