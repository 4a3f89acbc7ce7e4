"""Fused Pallas kernels (Triton route) — the device render path.

The reference's WGSL fragment shaders (shader_sphere.wgsl / shader_tris.wgsl)
become fused Pallas kernels: one program per (th, tw) block of pixels traces
the full path (RNG seed → camera ray → bounce loop → sky) with every ray's
state in registers, and writes the frame's color once.  Scene primitives are
uniform scalar loads broadcast against the block.
"""

from rt.kernels.dispatch import render_color

__all__ = ["render_color"]
