"""Profiling, stats, and logging — the observability subsystem.

The reference's only observability is wall-clock `Instant` reads and ad-hoc
println! (src/app.rs:17,94, src/renderer.rs:174,241 — SURVEY.md §5).  This
framework provides:

- ``Timer`` / ``device_sync``: wall-clock timing that waits for device
  work (``block_until_ready`` on every array);
- ``RenderStats``: running rays/s, frames, per-frame ms — the numbers
  bench.py reports;
- ``profile_trace``: a ``jax.profiler.trace`` context for device traces
  viewable in TensorBoard/Perfetto;
- ``setup_logging``: stdlib logging config (the env_logger analog,
  src/main.rs:6).
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

import jax

log = logging.getLogger("rt")


def setup_logging(level=logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s %(levelname).1s %(message)s",
        datefmt="%H:%M:%S")


def device_sync(*arrays) -> None:
    """Wait for the device work feeding ``arrays``."""
    for a in arrays:
        jax.block_until_ready(a)


class Timer:
    """``with Timer() as t: ...; t.seconds`` — syncs the given arrays on
    exit so device work is included."""

    def __init__(self, *sync_arrays):
        self._sync = sync_arrays

    def __enter__(self):
        self.seconds = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        device_sync(*self._sync)
        self.seconds = time.perf_counter() - self._t0
        return False


@dataclass
class RenderStats:
    """Running throughput accounting: one update per frame batch."""

    width: int
    height: int
    bounces: int
    samples_per_frame: int = 1
    frames: int = 0
    seconds: float = 0.0
    history: list = field(default_factory=list)

    def update(self, n_frames: int, seconds: float) -> None:
        self.frames += n_frames
        self.seconds += seconds
        self.history.append((n_frames, seconds))

    @property
    def pixels(self) -> int:
        return self.width * self.height

    @property
    def camera_rays_per_s(self) -> float:
        return (self.pixels * self.samples_per_frame * self.frames
                / self.seconds) if self.seconds else 0.0

    @property
    def ray_segments_per_s(self) -> float:
        """Each bounce iteration casts one segment per sample (fixed-depth
        loop) — the Mrays/s accounting used by bench.py."""
        return self.camera_rays_per_s * self.bounces

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    def summary(self) -> str:
        return (f"{self.frames} frames in {self.seconds:.3f}s: "
                f"{self.fps:.1f} fps, "
                f"{self.camera_rays_per_s:.3e} camera rays/s, "
                f"{self.ray_segments_per_s:.3e} ray segments/s")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """XLA profiler trace (TensorBoard/Perfetto-viewable).  No-op if the
    profiler is unavailable on the platform."""
    import jax
    try:
        with jax.profiler.trace(logdir):
            yield
    except Exception as e:  # profiling must never break a render
        log.warning("profiler unavailable: %s", e)
        yield
