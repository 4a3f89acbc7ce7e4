"""PPM (P3) readback + golden comparison.

Writer replicates render_ppm (src/scene/render_ppm.rs:38-57):
- header ``P3\\n{w} {h} 255\\n``;
- all pixels on ONE line, ``"{r} {g} {b} "`` each (trailing space, no final
  newline), row-major;
- channel = raw LINEAR value * 255, cast with Rust ``as u8`` semantics:
  truncation toward zero, saturating to [0, 255], NaN -> 0.  No gamma.

Comparator replicates compare_ppm_images (tests/rendering_tests.rs:84-131):
dimension line must match exactly; mean absolute per-channel u8 difference
as a percentage of 255 must be <= tolerance (2.0 for the goldens).
"""

from __future__ import annotations

import numpy as np


def image_to_u8(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) f32 linear -> (H, W, 3) u8 with Rust `as u8` cast rules."""
    v = np.asarray(image, np.float32) * 255.0
    v = np.nan_to_num(v, nan=0.0, posinf=255.0, neginf=0.0)
    v = np.clip(np.trunc(v), 0.0, 255.0)
    return v.astype(np.uint8)


def render_ppm(image: np.ndarray, use_native: bool = True) -> str:
    if use_native:
        try:
            from rt.scene import native_bridge
            if native_bridge.available():
                return native_bridge.render_ppm(np.asarray(image, np.float32))
        except Exception:
            pass
    h, w = image.shape[:2]
    u8 = image_to_u8(image).reshape(-1, 3)
    body = "".join(f"{r} {g} {b} " for r, g, b in u8)
    return f"P3\n{w} {h} 255\n{body}"


def write_ppm(path: str, image: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(render_ppm(image))


def parse_ppm(text: str):
    """Parse a P3 file the way the reference comparator does
    (tests/rendering_tests.rs:89-108): dims from line 1, pixels from
    lines[2:], any u8-parseable whitespace-separated token."""
    lines = text.splitlines()
    if len(lines) < 2:
        raise ValueError("not a P3 file")
    dims = lines[1]
    toks = " ".join(lines[2:]).split()
    vals = []
    for t in toks:
        try:
            v = int(t)
        except ValueError:
            continue
        if 0 <= v <= 255:
            vals.append(v)
    return dims, np.array(vals, np.uint8)


def compare_ppm(img1: str, img2: str, tolerance_percent: float = 2.0):
    """Returns (ok, avg_diff_percent). Raises ValueError on dim mismatch."""
    d1, p1 = parse_ppm(img1)
    d2, p2 = parse_ppm(img2)
    if d1 != d2:
        raise ValueError(f"different dimensions: {d1!r} vs {d2!r}")
    if len(p1) != len(p2):
        raise ValueError(f"pixel count mismatch: {len(p1)} vs {len(p2)}")
    diff = np.abs(p1.astype(np.float32) - p2.astype(np.float32)).sum()
    avg = diff / len(p1)
    pct = avg / 255.0 * 100.0
    return pct <= tolerance_percent, float(pct)


def parity_metrics(ref: np.ndarray, img: np.ndarray):
    """(flip fraction, golden-metric MAE %) of ``img`` against ``ref``, two
    (H, W, 3) f32 frames rendered from the same time uniform.

    flip fraction: share of pixels whose color differs by more than 1e-6 —
    a path that took another branch (FMA contraction and other last-bit
    differences flip grazing hits and Schlick draws).  MAE: the reference's
    golden metric on the u8 images (tests/rendering_tests.rs:84-131), mean
    absolute difference as a percentage of 255."""
    a = np.asarray(ref, np.float32)
    b = np.asarray(img, np.float32)
    if a.shape != b.shape:
        raise ValueError(f"shape {b.shape} != {a.shape}")
    flips = float((np.abs(a - b).max(-1) > 1e-6).mean())
    qa = image_to_u8(a).astype(np.float64)
    qb = image_to_u8(b).astype(np.float64)
    return flips, float(np.abs(qa - qb).mean() / 255 * 100)
