"""CLI app-shell tests (rt/cli.py) — the entry-point coverage the reference
carries as in-module smoke renders (src/scene/scene_sphere.rs:131-161,
src/scene/scene_tris.rs:204-244) plus the argv semantics of
App::parse_args (src/app.rs:36-41).

Everything runs tiny (32x32, <=4 frames, oracle backend on CPU) so the
whole module stays in the default suite.
"""

import random

import numpy as np
import pytest

from rt import cli
from rt.render.ppm import parse_ppm


def run_cli(argv):
    return cli.main(argv)


def test_render_writes_ppm(tmp_path):
    out = tmp_path / "out.ppm"
    rc = run_cli(["--scene", "1", "--frames", "2", "--size", "32x32",
                  "-o", str(out)])
    assert rc == 0
    text = out.read_text()
    dims, vals = parse_ppm(text)
    assert text.startswith("P3\n")
    assert dims == "32 32 255"
    assert len(vals) == 32 * 32 * 3
    # a real render, not zeros: the sky gradient alone lights most pixels
    assert vals.astype(np.int64).sum() > 0


def test_render_matches_renderer_path(tmp_path):
    """The CLI's output is exactly the progressive renderer's state."""
    import dataclasses

    import jax.numpy as jnp

    from rt.render.ppm import render_ppm
    from rt.render.renderer import ProgressiveRenderer
    from rt.scene import scenes

    out = tmp_path / "out.ppm"
    rc = run_cli(["--scene", "3", "--frames", "2", "--size", "32x32",
                  "-o", str(out)])
    assert rc == 0

    sd = scenes.build_scene(3, 32, 32)
    r = ProgressiveRenderer(sd)
    r.set_time(1000)
    r.draw_frames(2, 10)
    assert out.read_text() == render_ppm(r.image)


def test_checkpoint_resume_bitwise(tmp_path):
    """Interrupted (2 frames, checkpoint, resume to 4) == uninterrupted 4."""
    ck = tmp_path / "state.npz"
    out_a = tmp_path / "a.ppm"
    out_b = tmp_path / "b.ppm"
    common = ["--scene", "1", "--size", "32x32", "--batch", "2",
              "--checkpoint", str(ck)]
    assert run_cli(common + ["--frames", "2", "-o", str(out_a)]) == 0
    assert ck.exists()
    assert run_cli(common + ["--frames", "4", "--resume",
                             "-o", str(out_a)]) == 0

    rc = run_cli(["--scene", "1", "--size", "32x32", "--frames", "4",
                  "-o", str(out_b)])
    assert rc == 0
    assert out_a.read_text() == out_b.read_text()


def test_sharded_bad_height_exits_2(tmp_path):
    """--sharded with a height the device count can't divide -> exit 2
    before any rendering."""
    import jax

    n = len(jax.devices())
    bad_h = 8 * n + 4  # not divisible by n (n >= 2 on the test mesh)
    out = tmp_path / "out.ppm"
    rc = run_cli(["--scene", "1", "--frames", "1",
                  "--size", f"32x{bad_h}", "--sharded", "-o", str(out)])
    assert rc == 2
    assert not out.exists()


def test_sharded_render_matches_unsharded(tmp_path):
    out_s = tmp_path / "s.ppm"
    out_u = tmp_path / "u.ppm"
    args = ["--scene", "1", "--frames", "2", "--size", "32x32"]
    assert run_cli(args + ["--sharded", "-o", str(out_s)]) == 0
    assert run_cli(args + ["-o", str(out_u)]) == 0
    assert out_s.read_text() == out_u.read_text()


def test_sharded_wave_cli_matches_unsharded(tmp_path):
    """--sharded --backend pallas on a triangle scene runs the kernel on
    every device's row band (rt/dist/bands.py) from the app shell; its PPM
    equals the unsharded kernel render bitwise."""
    out_s = tmp_path / "s.ppm"
    out_u = tmp_path / "u.ppm"
    args = ["--scene", "3", "--frames", "2", "--size", "32x32",
            "--backend", "pallas", "--interpret"]
    assert run_cli(args + ["--sharded", "-o", str(out_s)]) == 0
    assert run_cli(args + ["-o", str(out_u)]) == 0
    assert out_s.read_text() == out_u.read_text()


def test_sharded_pallas_sphere_fails_loudly(tmp_path):
    """--sharded + pallas on a sphere scene has no row-band kernel path,
    and a height that does not divide by the device count has no bands —
    exit 2 before rendering, never a silent fallback."""
    out = tmp_path / "out.ppm"
    rc = run_cli(["--scene", "1", "--frames", "1", "--size", "32x32",
                  "--backend", "pallas", "--interpret", "--sharded",
                  "-o", str(out)])
    assert rc == 2
    assert not out.exists()
    rc = run_cli(["--scene", "3", "--frames", "1", "--size", "32x30",
                  "--backend", "pallas", "--interpret", "--sharded",
                  "-o", str(out)])
    assert rc == 2
    assert not out.exists()


def test_scene_id_fallback_semantics():
    """App::parse_args (src/app.rs:36-41): id from argv when parseable,
    random in 1..=7 otherwise; --scene overrides positionally."""
    ns = cli.parse_args(["5"])
    assert cli.resolve_scene_id(ns) == 5

    random.seed(123)
    expect = random.randint(1, 7)
    random.seed(123)
    ns = cli.parse_args(["not-a-number"])
    got = cli.resolve_scene_id(ns)
    assert got == expect and 1 <= got <= 7

    random.seed(123)
    ns = cli.parse_args([])
    assert cli.resolve_scene_id(ns) == expect

    ns = cli.parse_args(["3", "--scene", "4"])
    assert cli.resolve_scene_id(ns) == 4


def test_spp_flag_threads_into_config(tmp_path):
    """--spp reaches RenderConfig.samples_per_frame (in-kernel sample loop)."""
    out1 = tmp_path / "spp1.ppm"
    out2 = tmp_path / "spp2.ppm"
    args = ["--scene", "1", "--frames", "1", "--size", "32x32"]
    assert run_cli(args + ["-o", str(out1)]) == 0
    assert run_cli(args + ["--spp", "2", "-o", str(out2)]) == 0
    # 2 samples averaged != 1 sample (different RNG draws)
    assert out1.read_text() != out2.read_text()


@pytest.mark.parametrize("scene_id", [8])
def test_extension_scene_ids(tmp_path, scene_id):
    """Scene 8 (RTIOW cover) is the documented extension past the
    reference's 1-7 range."""
    out = tmp_path / "out.ppm"
    rc = run_cli(["--scene", str(scene_id), "--frames", "1",
                  "--size", "32x32", "-o", str(out)])
    assert rc == 0
    assert parse_ppm(out.read_text())[0] == "32 32 255"
