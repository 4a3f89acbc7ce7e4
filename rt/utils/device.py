"""Which device a measurement ran on.

Every number the benchmarks print names its device: the platform, kind and
count as JAX reports them, and the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs slower
under load).  A measurement path that finds no GPU stops instead of timing
the CPU.
"""

from __future__ import annotations

import shutil
import subprocess


def device_info() -> dict:
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or a
    note that it could not be read."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else f"nvidia-smi rc={out.returncode}"


def require_gpu(what: str) -> dict:
    """device_info(), or SystemExit(1) when JAX finds no GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"{what}: needs a GPU, JAX found "
                         f"{info['platform']} ({info['kind']})")
    return info
