"""Headless CLI — the replacement for the reference's winit app
shell (src/main.rs, src/app.rs).

Scene selection mirrors App::parse_args + build_scene (src/app.rs:36-55):
a scene id 1-7, random in 1..=7 when absent/unparsable.  Instead of a window
swapchain, frames accumulate progressively into the device-resident image
(batched: ``render_frames`` scans N frames per compiled call) and are
written out as PPM (the reference's own headless path,
src/scene/render_ppm.rs).  Long renders can be checkpointed and resumed.

Usage:
    python -m rt.cli [scene_id] [--frames N] [--size WxH] [-o out.ppm]
                     [--backend jax|pallas] [--time-step MS] [--stats]
                     [--batch N] [--checkpoint PATH] [--resume]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import sys
import time as time_mod

from rt.render.ppm import write_ppm
from rt.render.renderer import ProgressiveRenderer
from rt.scene import scenes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", nargs="?", default=None,
                   help="scene id 1-7 (random if omitted, like the "
                        "reference); 8 = RTIOW ~490-sphere cover (extension)")
    p.add_argument("--scene", dest="scene_opt", type=int, default=None)
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--size", default="512x512")
    p.add_argument("-o", "--output", default="out.ppm")
    p.add_argument("--backend",
                   choices=["jax", "pallas"],
                   default="jax")
    p.add_argument("--time-step", type=int, default=10,
                   help="ms added to the RNG time uniform per frame")
    p.add_argument("--spp", type=int, default=None,
                   help="samples per frame (SAMPLE_PER_FRAME; default = the "
                        "reference's 1) — an in-kernel sample loop with the "
                        "RNG state threaded across samples")
    p.add_argument("--start-time", type=int, default=1000)
    p.add_argument("--batch", type=int, default=25,
                   help="frames per compiled render_frames call")
    p.add_argument("--stats", action="store_true",
                   help="print throughput stats per frame batch")
    p.add_argument("--seed", type=int, default=0,
                   help="seed for the randomized globe scene (scene 2)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; saved after every batch")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--sharded", action="store_true",
                   help="shard the image by rows across all devices "
                        "(height must divide by the device count); with the "
                        "pallas backend on a triangle scene each device runs "
                        "the kernel on its row band (rt/dist/bands.py)")
    p.add_argument("--interpret", action="store_true",
                   help="run Pallas kernels in interpret mode (CPU debug)")
    return p.parse_args(argv)


def resolve_scene_id(args) -> int:
    if args.scene_opt is not None:
        return args.scene_opt
    j = random.randint(1, 7)  # App::parse_args random fallback (app.rs:36-41)
    if args.scene is None:
        return j
    try:
        return int(args.scene)
    except ValueError:
        return j


def main(argv=None) -> int:
    import jax

    from rt.utils import RenderStats, enable_compile_cache, setup_logging

    setup_logging()
    args = parse_args(argv)
    enable_compile_cache()
    scene_id = resolve_scene_id(args)
    w, h = (int(v) for v in args.size.lower().split("x"))
    if scene_id == 2:
        sd = scenes.scene_sphere_globe(w, h, seed=args.seed)
    else:
        sd = scenes.build_scene(scene_id, w, h)
    cfg_kw = dict(backend=args.backend)
    if args.spp is not None:
        cfg_kw["samples_per_frame"] = args.spp
    if args.interpret:
        cfg_kw["interpret"] = True
    sd = dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, **cfg_kw))
    print(f"scene {scene_id} ({sd.name}), {w}x{h}, {args.frames} frames, "
          f"spp={sd.config.samples_per_frame}, backend={sd.config.backend}",
          file=sys.stderr)

    r = ProgressiveRenderer(sd)
    band_frames = None
    if args.sharded:
        from rt.core.triangle import TriangleScene
        from rt.dist import make_mesh, shard_scene, shard_state
        mesh = make_mesh()
        if h % len(jax.devices()) != 0:
            print(f"--sharded: height {h} not divisible by "
                  f"{len(jax.devices())} devices", file=sys.stderr)
            return 2
        if args.backend == "pallas":
            # the kernel path shards by shard_map over row bands
            # (rt/dist/bands.py); it exists only for triangle scenes, and
            # anything else fails loudly rather than silently replicating a
            # Pallas launch under the SPMD partitioner.
            if not isinstance(sd.scene, TriangleScene):
                print("--sharded with the pallas backend requires a "
                      "triangle scene; use --backend jax for sharded "
                      "sphere scenes", file=sys.stderr)
                return 2
            from rt.dist.bands import sharded_band_frames
            band_frames = sharded_band_frames(mesh)
        r.state = shard_state(r.state, mesh)
        sd = dataclasses.replace(sd, scene=shard_scene(sd.scene, mesh),
                                 camera=shard_scene(sd.camera, mesh))
        r.scene_def = sd
        r.camera = sd.camera
        print(f"sharded over {len(jax.devices())} devices"
              + (" (kernel row bands)" if band_frames is not None else ""),
              file=sys.stderr)
    r.set_time(args.start_time)
    done = 0
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        from rt.render.checkpoint import load_render_state
        r.state, t = load_render_state(args.checkpoint)
        r.set_time(t)
        done = int(r.state.frame_count)
        print(f"resumed at frame {done} (time {t})", file=sys.stderr)

    stats = RenderStats(width=w, height=h, bounces=sd.config.bounces,
                        samples_per_frame=sd.config.samples_per_frame)
    while done < args.frames:
        n = min(args.batch, args.frames - done)
        t0 = time_mod.perf_counter()
        if band_frames is not None:
            import jax.numpy as jnp
            r.state = band_frames(sd.scene, r.camera, r.state,
                                  jnp.uint32(r.time),
                                  jnp.uint32(args.time_step), sd.config, n)
            r.set_time(r.time + n * args.time_step)
        else:
            r.draw_frames(n, args.time_step)
        jax.block_until_ready(r.state.image)
        stats.update(n, time_mod.perf_counter() - t0)
        done += n
        if args.checkpoint:
            from rt.render.checkpoint import save_render_state
            save_render_state(args.checkpoint, r.state, r.time)
        if args.stats:
            print(f"  frame {done}/{args.frames}: {stats.summary()}",
                  file=sys.stderr)
    write_ppm(args.output, r.image)
    print(f"wrote {args.output} ({stats.summary()})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
