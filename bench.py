"""Headline benchmark — prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
     "device": {...}}

Canonical metric config (the default run): the flagship Suzanne mesh scene
(the reference's src/scene/scene_tris.rs:119-159) at **512x512, 8 bounces,
256 progressive frames per timed call** — the golden-test resolution with
BASELINE.md's bounce budget; BASELINE's "64 spp" is realized as progressive
1-spp frames (SAMPLE_PER_FRAME=1 is the reference's own sampling unit,
shader_sphere.wgsl:11).  The frames are scanned inside ONE compiled call
(``render_frames``).  "rays/s" counts traced ray segments — every pixel's
bounce-loop iteration casts one ray (the fixed-depth loop traces
``bounces`` segments per sample), the standard Mrays/s accounting for path
tracers.

vs_baseline: the reference publishes no numbers; its perf test implies a
lower bound of ~5.24e5 ray segments/s (512*512 px * 1 spp * 10 bounces in
<5 s — tests/rendering_tests.rs:8-11,571-575 + shader_sphere.wgsl:12), so
the ratio is reported against that implied floor.

device: JAX's platform, device kind and count, and the card's name and
power limit from nvidia-smi.  The benchmark runs the device kernels and
exits non-zero when JAX finds no GPU; ``--backend jax`` times the XLA
oracle on the same card.

Usage: python bench.py [--scene suzanne] [--size 512x512] [--frames 64]
                       [--bounces 8] [--backend auto]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time as time_mod

REFERENCE_RAYS_PER_S = 512 * 512 * 10 / 5.0  # implied floor, see docstring


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="suzanne",
                   choices=["suzanne", "sphere_simple", "lucy", "dragon",
                            "perf", "cover", "one_sphere", "three_spheres"])
    p.add_argument("--size", default="512x512")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--backend", default="auto",
                   help="auto|jax|pallas (auto: the device kernels)")
    args = p.parse_args(argv)

    import jax

    from rt.render.renderer import ProgressiveRenderer
    from rt.scene import scenes
    from rt.utils import enable_compile_cache
    from rt.utils.device import card_name_and_power, require_gpu

    info = require_gpu("bench.py")
    enable_compile_cache()
    card = card_name_and_power()

    w, h = (int(v) for v in args.size.lower().split("x"))
    builders = {"suzanne": scenes.scene_suzanne,
                "sphere_simple": scenes.scene_sphere_simple,
                "lucy": scenes.scene_lucy,
                "dragon": scenes.scene_dragon,
                "perf": scenes.test_scene_perf,
                # BASELINE config 3: ~490-sphere RTIOW cover, 1280x720
                "cover": scenes.scene_sphere_cover,
                # BASELINE configs 1-2 (tools/bench_configs.py runs them at
                # their canonical spp/resolution)
                "one_sphere": scenes.scene_rtiow_one_sphere,
                "three_spheres": scenes.scene_rtiow_three_spheres}
    sd = builders[args.scene](w, h)

    backend = "pallas" if args.backend == "auto" else args.backend
    sd = dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, bounces=args.bounces, backend=backend))

    print(f"bench: {args.scene} {w}x{h} bounces={args.bounces} "
          f"frames={args.frames} backend={backend} "
          f"device={info['kind']} x{info['count']} ({card})",
          file=sys.stderr)

    r = ProgressiveRenderer(sd)
    # warmup: compile + run the full batched call
    r.set_time(1000)
    r.draw_frames(args.frames)
    jax.block_until_ready(r.state.image)

    t0 = time_mod.perf_counter()
    r.draw_frames(args.frames)
    jax.block_until_ready(r.state.image)
    dt = time_mod.perf_counter() - t0

    spp = sd.config.samples_per_frame
    rays = w * h * spp * args.bounces * args.frames
    rays_per_s = rays / dt
    print(f"bench: {args.frames} frames in {dt:.3f}s "
          f"({args.frames/dt:.2f} fps, {rays_per_s:.4g} ray segments/s)",
          file=sys.stderr)

    print(json.dumps({
        "metric": f"ray_segments_per_s_{args.scene}_{w}x{h}_b{args.bounces}",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / REFERENCE_RAYS_PER_S,
        "device": dict(info, card=card),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
