"""Fast inverse rendering via path-replay backprop (rt/grad/replay.py).

The production inverse-rendering loop: the FORWARD (and the hit decisions)
come from the fused Pallas kernels' recording variants; the BACKWARD
differentiates the frozen-path replay — no intersection scans anywhere in
the gradient graph.  Periodically re-record so the frozen Monte-Carlo path
structure tracks the moving parameters.

    python examples/replay_inverse.py            # GPU: the kernel recorder
    JAX_PLATFORMS=cpu python examples/replay_inverse.py --interpret
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rt.grad import SphereParams, apply_params, image_mse
from rt.grad.replay import record_hits_pallas, replay_color
from rt.scene import scenes


def main():
    sd = scenes.test_scene_metal(96, 64)
    sd = dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=3))
    cfg = sd.config
    t = jnp.uint32(1000)

    interpret = "--interpret" in sys.argv

    def record(sc):
        return record_hits_pallas(sc, sd.camera, cfg, t, interpret=interpret)

    target, _ = record(sd.scene)

    # perturb two spheres' albedos; recover them
    wrong = sd.scene.albedo.at[1].set(jnp.array([0.1, 0.9, 0.1])) \
                            .at[2].set(jnp.array([0.9, 0.2, 0.6]))
    params = SphereParams(albedo=wrong)
    opt = optax.adam(5e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, hits):
        def loss(p):
            img = replay_color(apply_params(sd.scene, p), sd.camera, cfg, t,
                               hits)
            return image_mse(img, target)
        l, g = jax.value_and_grad(loss)(params)
        upd, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, l

    for outer in range(6):                 # re-record every 20 steps
        _, hits = record(apply_params(sd.scene, params))
        for _ in range(20):
            params, opt_state, l = step(params, opt_state, hits)
        print(f"outer {outer}: loss {float(l):.3e}")

    err = float(jnp.abs(params.albedo[1:3] - sd.scene.albedo[1:3]).max())
    print(f"albedo recovery error: {err:.4f} "
          f"({'OK' if err < 0.05 else 'NOT CONVERGED'})")
    return 0 if err < 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
