"""Inverse rendering demo: recover sphere albedos from a rendered target.

The differentiable capability the reference (forward-only Rust/WGSL) lacks:
render a target image, perturb the scene's materials, and recover them by
gradient descent through the full path tracer (BASELINE config 5's shape,
scaled down to run on CPU in ~a minute).

    JAX_PLATFORMS=cpu python examples/inverse_materials.py
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from rt.grad import SphereParams, fit, render_image_diff
from rt.scene import scenes


def main():
    sd = scenes.test_scene_lambertian(96, 64)
    sd = dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=3))
    times = (1000, 1010)

    target = render_image_diff(sd.scene, sd.camera, sd.config, times)
    true_albedo = np.asarray(sd.scene.albedo[:4])

    wrong = sd.scene.albedo.at[0].set(jnp.array([0.2, 0.6, 0.9]))
    wrong = wrong.at[2].set(jnp.array([0.9, 0.6, 0.2]))
    init = {"scene": SphereParams(albedo=wrong)}

    params, losses = fit(sd.scene, sd.camera, sd.config, target,
                         times=times, steps=80, learning_rate=5e-2,
                         init_params=init, optimize_scene=False,
                         log_every=20)
    rec = np.asarray(params["scene"].albedo[:4])
    print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
    for i in range(4):
        print(f"  sphere {i}: true {true_albedo[i].round(3)} "
              f"recovered {rec[i].round(3)}")


if __name__ == "__main__":
    main()
