"""Sweep the kernels' pixel block (th, tw, num_warps) and scan unroll on
the GPU: ms per frame (median of 5 warm calls) for each choice.

    PYTHONPATH=. python tools/sweep_blocks.py

``rt.kernels.dispatch.BLOCK`` and ``TRIS_UNROLL`` hold the chosen values;
PERF.md keeps the table this prints.  Every block renders the same image
(tests/test_kernels.py::test_block_shape_bit_identical), so only speed is
compared.  Exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import dataclasses
import sys
import time

BLOCKS = [(4, 8, 1), (8, 4, 1), (8, 8, 2), (8, 16, 4)]


def _kernel_fn(sd, block, unroll=None):
    """One frame through the kernel dispatch would pick, at ``block``.
    ``unroll``: triangles or chunked spheres per scan iteration; for the
    flat sphere kernel, 1 turns the full scan unroll off."""
    import jax.numpy as jnp

    from rt.config import MAT_DIELECTRIC, MAT_METAL
    from rt.core.sphere import SphereArray
    from rt.kernels import sphere_kernel, tris_kernel
    from rt.kernels.dispatch import (TRIS_UNROLL, block_grid, pack_camera,
                                     pack_spheres_table)

    cfg = sd.config
    common = dict(height=cfg.height, width=cfg.width, bounces=cfg.bounces,
                  normalize_defocus_dir=cfg.normalize_defocus_dir,
                  normalize_reflect_in=cfg.normalize_reflect_in,
                  has_metal=MAT_METAL in cfg.mat_kinds,
                  has_dielectric=MAT_DIELECTRIC in cfg.mat_kinds,
                  spp=cfg.samples_per_frame,
                  **block_grid(cfg.height, cfg.width, block))

    def f(scene, camera, t):
        cam = pack_camera(camera)
        t = jnp.asarray(t, jnp.uint32).reshape(1, 1)
        if isinstance(scene, SphereArray):
            tab, kinds, n = pack_spheres_table(scene)
            if 0 < cfg.n_active_spheres < n:
                n = cfg.n_active_spheres
            if n > 128:
                return sphere_kernel.render_color_spheres_chunked(
                    tab, kinds, cam, t, n_spheres=n, **common,
                    **({} if unroll is None else {"unroll": unroll}))
            return sphere_kernel.render_color_spheres(
                tab, kinds, cam, t, n_spheres=n,
                unroll_all=n <= 32 and unroll != 1, **common)
        return tris_kernel.render_color_tris(
            scene, cam, t, chunk=32,
            unroll=TRIS_UNROLL if unroll is None else unroll, **common)
    return f


def main() -> int:
    import jax
    import jax.numpy as jnp

    from chip_smoke import median_ms
    from rt.scene import scenes
    from rt.utils import enable_compile_cache
    from rt.utils.device import card_name_and_power, require_gpu

    info = require_gpu("tools/sweep_blocks.py")
    enable_compile_cache()
    print(f"device={info} card={card_name_and_power()}", flush=True)

    def sd_of(builder, w, h, **kw):
        sd = builder(w, h)
        return dataclasses.replace(
            sd, config=dataclasses.replace(sd.config, **kw))

    cases = [
        # (name, scene def, unrolls tried at BLOCKS[0])
        ("three_spheres 800x450 spp64 b10",
         sd_of(scenes.scene_rtiow_three_spheres, 800, 450, bounces=10,
               samples_per_frame=64), [None, 1]),
        ("cover 1280x720 b10 (chunked)",
         sd_of(scenes.scene_sphere_cover, 1280, 720, bounces=10),
         [None, 8, 32]),
        ("suzanne 512x512 b8",
         sd_of(scenes.scene_suzanne, 512, 512, bounces=8), [None, 4, 16]),
        ("dragon 512x512 b5",
         sd_of(scenes.scene_dragon, 512, 512, bounces=5), [None, 4, 16]),
    ]
    t = jnp.uint32(1000)
    for name, sd, unrolls in cases:
        for block in BLOCKS:
            for u in unrolls if block == BLOCKS[0] else [None]:
                t0 = time.perf_counter()
                try:
                    exe = jax.jit(_kernel_fn(sd, block, u)).lower(
                        sd.scene, sd.camera, t).compile()
                    comp = time.perf_counter() - t0
                    ms = median_ms(exe, sd.scene, sd.camera, t)
                    print(f"sweep {name} block={block} unroll={u}: "
                          f"{ms:.3f} ms/frame (compile {comp:.1f} s)",
                          flush=True)
                except Exception as e:  # noqa: BLE001 — report and go on
                    print(f"sweep {name} block={block} unroll={u}: "
                          f"FAILED {type(e).__name__}: {str(e)[:400]}",
                          flush=True)
    print(card_name_and_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
