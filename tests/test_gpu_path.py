"""The GPU path's host side, checked on the CPU: block shapes and padding,
the Triton route of every kernel (lowered for CUDA without a card), the
recorder choice, the compile cache, and the entry points that refuse to
measure without a GPU.  The ``gpu``-marked tests at the end need the card;
they skip here and ``python chip_smoke.py`` runs the same checks there."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt.kernels import dispatch
from rt.scene import scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Block shapes and padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(512, 512), (450, 800), (720, 1280),
                                 (1080, 1920), (28, 60), (1, 1)])
def test_block_grid_shapes(h, w):
    g = dispatch.block_grid(h, w)
    th, tw = g["th"], g["tw"]
    for v in (th, tw, g["num_warps"]):
        assert v & (v - 1) == 0, f"{v} is not a power of two"
    assert th * tw == 32 * g["num_warps"], "one ray per thread"
    assert g["height_pad"] % th == 0 and g["width_pad"] % tw == 0
    assert 0 <= g["height_pad"] - h < th
    assert 0 <= g["width_pad"] - w < tw


@pytest.mark.parametrize("w", [800, 1280, 1920])
def test_block_grid_no_width_padding_at_standard_widths(w):
    """The old 128-lane rounding padded 800 px to 1024; every standard
    width is now a whole number of blocks."""
    assert dispatch.block_grid(64, w)["width_pad"] == w


def test_block_grid_explicit_block():
    g = dispatch.block_grid(30, 70, (16, 16, 8))
    assert (g["height_pad"], g["width_pad"]) == (32, 80)
    assert g["num_warps"] == 8


# ---------------------------------------------------------------------------
# Every kernel lowers on the Triton route (cross-platform lowering for CUDA)
# ---------------------------------------------------------------------------

def _small(builder, w=64, h=32, **kw):
    sd = builder(w, h)
    return dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, **kw))


def _lowered_text(fn, sd):
    return jax.jit(fn).trace(sd.scene, sd.camera, jnp.uint32(1000)).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("name,builder,kw", [
    ("sphere_flat", scenes.scene_rtiow_three_spheres,
     dict(bounces=3, samples_per_frame=2)),
    ("sphere_chunked", scenes.scene_sphere_cover, dict(bounces=3)),
    ("tris", scenes.scene_suzanne, dict(bounces=3)),
    ("tris_spp", scenes.scene_cube, dict(bounces=2, samples_per_frame=2)),
])
def test_render_kernels_lower_to_triton(name, builder, kw):
    sd = _small(builder, backend="pallas", **kw)
    txt = _lowered_text(
        lambda s, c, t: dispatch.render_color(s, c, sd.config, t), sd)
    assert "__gpu$xla.gpu.triton" in txt
    assert "mosaic" not in txt.lower()


@pytest.mark.parametrize("builder", [scenes.test_scene_metal,
                                     scenes.scene_cube])
def test_recorders_lower_to_triton(builder):
    from rt.grad.replay import record_hits_pallas
    sd = _small(builder, bounces=3)
    txt = _lowered_text(
        lambda s, c, t: record_hits_pallas(s, c, sd.config, t), sd)
    assert "__gpu$xla.gpu.triton" in txt


# ---------------------------------------------------------------------------
# Recorder choice
# ---------------------------------------------------------------------------

def test_recorder_follows_backend():
    from rt.grad.replay import record_hits_oracle, record_hits_pallas
    from rt.grad.train import recorder_for
    cfg = scenes.scene_cube(8, 8).config
    assert recorder_for(dataclasses.replace(cfg, backend="jax")) \
        is record_hits_oracle
    rec = recorder_for(dataclasses.replace(cfg, backend="pallas"))
    assert rec.func is record_hits_pallas
    assert rec.keywords == {"interpret": False}
    rec = recorder_for(dataclasses.replace(cfg, backend="pallas",
                                           interpret=True))
    assert rec.keywords == {"interpret": True}
    assert recorder_for(cfg, "oracle") is record_hits_oracle
    with pytest.raises(ValueError, match="unknown recorder"):
        recorder_for(cfg, "bogus")


def test_fit_replay_auto_records_with_the_kernels(monkeypatch):
    """fit_replay(recorder="auto") with a pallas backend records through
    the kernel recorder (interpret mode only because the config asks)."""
    from rt.grad import replay
    from rt.grad.train import fit_replay
    calls = []
    real = replay.record_hits_pallas

    def spy(*a, **kw):
        calls.append(kw.get("interpret"))
        return real(*a, **kw)

    monkeypatch.setattr(replay, "record_hits_pallas", spy)
    sd = _small(scenes.test_scene_metal, 32, 16, bounces=2,
                backend="pallas", interpret=True)
    target = jnp.zeros((16, 32, 3), jnp.float32)
    _, losses = fit_replay(sd.scene, sd.camera, sd.config, target, steps=2,
                           rerecord_every=1)
    assert calls == [True, True] and len(losses) == 2


# ---------------------------------------------------------------------------
# Compile cache
# ---------------------------------------------------------------------------

@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    old_t = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_t)


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path,
                                             cache_config):
    from rt.utils import compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_unset_uses_fixed_checkout_path(monkeypatch,
                                                      cache_config):
    from rt.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same path on every call: no temporary name, pid or time in it
    assert compile_cache.enable_compile_cache() == path


def test_compile_cache_entries_land_in_the_directory(monkeypatch, tmp_path,
                                                     cache_config):
    from jax._src import compilation_cache as cc

    from rt.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", tmp_path / "cache")
    compile_cache.enable_compile_cache()
    cc.reset_cache()
    try:
        jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
        assert any((tmp_path / "cache").iterdir())
    finally:
        jax.config.update("jax_compilation_cache_dir", None)
        cc.reset_cache()


# ---------------------------------------------------------------------------
# Entry points refuse to measure without a GPU
# ---------------------------------------------------------------------------

def test_bench_refuses_cpu(capsys):
    import bench
    with pytest.raises(SystemExit) as e:
        bench.main(["--frames", "1", "--size", "8x8"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_device_helpers_without_nvidia_smi(monkeypatch):
    from rt.utils import device
    monkeypatch.setattr(device.shutil, "which", lambda _: None)
    assert device.card_name_and_power() == "nvidia-smi not found"
    info = device.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    with pytest.raises(SystemExit, match="needs a GPU"):
        device.require_gpu("probe")


# ---------------------------------------------------------------------------
# Parity metric shared by the tests and chip_smoke.py
# ---------------------------------------------------------------------------

def test_parity_metrics():
    from rt.render.ppm import parity_metrics
    a = np.zeros((4, 5, 3), np.float32)
    b = a.copy()
    assert parity_metrics(a, b) == (0.0, 0.0)
    b[0, 0] = 1.0                     # one pixel of 20 flips to white
    flips, mae = parity_metrics(a, b)
    assert flips == pytest.approx(1 / 20)
    assert mae == pytest.approx(100 / 20)
    with pytest.raises(ValueError):
        parity_metrics(a, b[:2])


def test_chip_smoke_last_line_contract(monkeypatch, capsys):
    """With every phase passing, the last stdout line is exactly the JSON
    object the contract names, and the card line comes before it."""
    import chip_smoke
    from rt.utils import device
    monkeypatch.setattr(device, "require_gpu", lambda what: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    monkeypatch.setattr(device, "card_name_and_power",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for name in ("phase_device", "phase_compile", "phase_parity",
                 "phase_goldens", "phase_fit", "phase_race"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "parity_cases", lambda: [])
    monkeypatch.setattr(chip_smoke, "race_cases", lambda: [])
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    import rt.utils
    monkeypatch.setattr(rt.utils, "enable_compile_cache", lambda: "cache")
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert lines[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"


# ---------------------------------------------------------------------------
# On the card (skip here): compiled kernels against the oracle
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this check on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("builder,mae", [
    (scenes.scene_rtiow_three_spheres, 1.5), (scenes.scene_suzanne, 1.5)])
def test_compiled_kernels_match_oracle(gpu, builder, mae):
    from rt.render.ppm import parity_metrics
    from rt.render.renderer import render_color
    sd = _small(builder, 256, 128, bounces=4)
    t = jnp.uint32(1000)
    ref = np.asarray(render_color(sd.scene, sd.camera, sd.config, t))
    img = np.asarray(dispatch.render_color(sd.scene, sd.camera, sd.config, t))
    flips, mae_pct = parity_metrics(ref, img)
    assert flips <= 0.08 and mae_pct <= mae
