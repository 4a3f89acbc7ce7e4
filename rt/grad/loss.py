"""Losses for inverse rendering against golden images."""

from __future__ import annotations

import jax.numpy as jnp


def image_mse(rendered: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    """Mean squared error in linear RGB — the optimization twin of the golden
    comparator's mean-abs metric (tests/rendering_tests.rs:84-131; MAE's
    gradient is sign(), MSE's is smooth, so MSE optimizes and MAE validates).

    Under pjit with the image row-sharded, this mean is the one spot XLA
    inserts a cross-device psum — the gradient all-reduce.
    """
    d = rendered - target
    return jnp.mean(d * d)


def golden_mae_percent(rendered: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    """The acceptance metric itself: mean abs diff as % of 255 over u8-quantized
    pixels (tests/rendering_tests.rs:110-127)."""
    q = lambda x: jnp.clip(x * 255.0, 0.0, 255.0).astype(jnp.uint8).astype(jnp.float32)
    return jnp.mean(jnp.abs(q(rendered) - q(target))) / 255.0 * 100.0
