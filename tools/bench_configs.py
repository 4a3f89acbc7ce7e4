"""Bench every BASELINE.json config end-to-end on the attached GPU and
write ``BENCH_CONFIGS.json`` at the repo root (plus a human table to
stderr).  ``bench.py`` stays the driver's single-line headline; this is the
per-config evidence artifact.

Configs (BASELINE.json "configs"):
  1. rtiow_one_sphere     400x225   16 spp   4 bounces
  2. rtiow_three_spheres  800x450   64 spp  10 bounces
  3. sphere_cover        1280x720  128 spp  10 bounces  (~490 spheres)
  4. suzanne             1280x720  128 spp   5 bounces  (BVH mesh)
  5. differentiable suzanne 1920x1080 — fit_replay steps/s + loss drop

Throughput counts traced ray segments: w*h*spp*bounces*frames / wall time,
timed with ``block_until_ready``.  Exits non-zero when JAX finds no GPU.

Usage: PYTHONPATH=. python tools/bench_configs.py
       [--quick]  (smaller frame batches for a fast sanity pass)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time as time_mod


def bench_forward(sd, *, spp, bounces, frames, label):
    import jax

    from rt.render.renderer import ProgressiveRenderer

    sd = dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, bounces=bounces, samples_per_frame=spp,
        backend="pallas"))
    w, h = sd.config.width, sd.config.height
    r = ProgressiveRenderer(sd)
    r.set_time(1000)
    r.draw_frames(frames)
    jax.block_until_ready(r.state.image)     # compile + warm
    t0 = time_mod.perf_counter()
    r.draw_frames(frames)
    jax.block_until_ready(r.state.image)
    dt = time_mod.perf_counter() - t0
    segs = w * h * spp * bounces * frames
    v = segs / dt
    print(f"{label:28s} {w}x{h} spp={spp} b={bounces} F={frames}: "
          f"{dt:.2f}s  {v:.4g} seg/s", file=sys.stderr, flush=True)
    return {"config": label, "resolution": f"{w}x{h}", "spp": spp,
            "bounces": bounces, "frames_per_call": frames,
            "metric": "ray_segments_per_s", "value": v, "unit": "rays/s"}


def bench_config5(*, steps, rerecord_every):
    import jax
    import jax.numpy as jnp

    from rt.grad.train import fit_replay
    from rt.kernels.dispatch import render_color
    from rt.scene import scenes

    w, h = 1920, 1080
    sd = scenes.scene_suzanne(w, h)
    cfg = dataclasses.replace(sd.config, backend="pallas")
    target = render_color(sd.scene, sd.camera, cfg, jnp.uint32(1000))
    jax.block_until_ready(target)
    bad = sd.scene._replace(
        mat_albedo=sd.scene.mat_albedo.at[0].set(
            jnp.array([0.8, 0.1, 0.1], jnp.float32)))
    t0 = time_mod.perf_counter()
    params, losses = fit_replay(bad, sd.camera, cfg, target, steps=steps,
                                rerecord_every=rerecord_every,
                                learning_rate=5e-2)
    dt = time_mod.perf_counter() - t0
    print(f"{'config5_diff_suzanne':28s} {w}x{h} {steps} steps: {dt:.1f}s "
          f"({dt/steps*1e3:.0f} ms/step incl. records+compile), "
          f"loss {losses[0]:.3e} -> {losses[-1]:.3e}",
          file=sys.stderr, flush=True)
    return {"config": "config5_diff_suzanne", "resolution": f"{w}x{h}",
            "steps": steps, "metric": "train_step_ms_incl_records",
            "value": dt / steps * 1e3, "unit": "ms/step",
            "loss_start": float(losses[0]), "loss_end": float(losses[-1])}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--out", default="BENCH_CONFIGS.json")
    p.add_argument("--configs", default="1,2,3,4,5",
                   help="subset to run; with --merge-into, the chosen "
                        "configs' rows replace same-name rows in the "
                        "existing artifact; runs stay sequential, one "
                        "process on the card at a time")
    p.add_argument("--merge-into", action="store_true")
    args = p.parse_args(argv)

    from rt.scene import scenes
    from rt.utils import enable_compile_cache
    from rt.utils.device import card_name_and_power, require_gpu

    info = require_gpu("tools/bench_configs.py")
    enable_compile_cache()
    card = card_name_and_power()
    q = args.quick
    want = {int(v) for v in args.configs.split(",")}
    print(f"device={info} card={card} configs={sorted(want)}",
          file=sys.stderr, flush=True)
    results = []
    if 1 in want:
        results.append(bench_forward(
            scenes.scene_rtiow_one_sphere(), spp=16, bounces=4,
            frames=8 if q else 256, label="config1_one_sphere"))
    if 2 in want:
        results.append(bench_forward(
            scenes.scene_rtiow_three_spheres(), spp=64, bounces=10,
            frames=2 if q else 64, label="config2_three_spheres"))
    if 3 in want:
        results.append(bench_forward(
            scenes.scene_sphere_cover(), spp=8 if q else 128, bounces=10,
            frames=2 if q else 4, label="config3_cover"))
    if 4 in want:
        results.append(bench_forward(
            scenes.scene_suzanne(1280, 720), spp=8 if q else 128, bounces=5,
            frames=2 if q else 4, label="config4_suzanne"))
    if 5 in want:
        results.append(bench_config5(steps=8 if q else 24,
                                     rerecord_every=8))

    out = {"device": dict(info, card=card), "results": results}
    if args.merge_into:
        import os
        if os.path.exists(args.out):
            with open(args.out) as f:
                old = json.load(f)
            new_names = {r["config"] for r in results}
            out["results"] = [r for r in old["results"]
                              if r["config"] not in new_names] + results
            out["results"].sort(key=lambda r: r["config"])
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
