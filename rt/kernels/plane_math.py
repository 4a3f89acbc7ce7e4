"""Component-plane math for Pallas kernels.

Inside a kernel every vector quantity is a tuple of 2-D ``(TH, TW)`` float32
planes (one per component) — one element per ray, each op one elementwise
block operation, and the math mirrors rt/core/vecmath.py op-for-op so the
kernels stay numerically interchangeable with the pure-JAX oracle.

Replicated semantics (same citations as rt/core):
- PCG RNG: shader_sphere.wgsl:87-103 (wrapping u32, f32 divisor == 2^32);
- normalize without zero-guard (NaN on zero, like the GPU);
- WGSL mix unclamped; reflect/refract/Schlick per shader_sphere.wgsl:156-171.
"""

from __future__ import annotations

import jax.numpy as jnp

U = jnp.uint32
F = jnp.float32

_INC = 747796405 + 2891336453          # 3639132858 < 2^32
_MULT = 277803737
_DENOM = 4294967296.0                  # f32(0xffffffffu) rounds to 2^32


# --------------------------------------------------------------------------
# RNG (planes of uint32 state)
# --------------------------------------------------------------------------

def rng_step(s):
    old = s + U(_INC)
    shift = (old >> U(28)) + U(4)
    word = ((old >> shift) ^ old) * U(_MULT)
    return (word >> U(22)) ^ word


def rng_float(s):
    s = rng_step(s)
    return s, s.astype(F) / F(_DENOM)


def rng_vec2(s):
    s, a = rng_float(s)
    s, b = rng_float(s)
    return s, (a, b)


def rng_vec3(s):
    s, a = rng_float(s)
    s, b = rng_float(s)
    s, c = rng_float(s)
    return s, (a, b, c)


# --------------------------------------------------------------------------
# vec3 planes
# --------------------------------------------------------------------------

def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul3(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale3(a, k):
    return (a[0] * k, a[1] * k, a[2] * k)


def neg3(a):
    return (-a[0], -a[1], -a[2])


def where3(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def normalize3(a):
    # division (not reciprocal-multiply) to match vecmath.normalize bitwise
    ln = jnp.sqrt(dot3(a, a))
    return (a[0] / ln, a[1] / ln, a[2] / ln)


def normalize2(a):
    ln = jnp.sqrt(a[0] * a[0] + a[1] * a[1])
    return (a[0] / ln, a[1] / ln)


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def reflect3(v, n):
    k = 2.0 * dot3(v, n)
    return sub3(v, scale3(n, k))


def refract3(uv, n, ir):
    cos_theta = jnp.minimum(dot3(neg3(uv), n), 1.0)
    perp = scale3(add3(uv, scale3(n, cos_theta)), ir)
    ln = jnp.sqrt(dot3(perp, perp))      # round-trip sqrt matches vecmath
    par_k = -jnp.sqrt(jnp.abs(1.0 - ln * ln))
    return add3(perp, scale3(n, par_k))


def schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def fract(x):
    return x - jnp.floor(x)


# --------------------------------------------------------------------------
# vec4 planes (make_ray's 4-D-normalize quirk needs the w component)
# --------------------------------------------------------------------------

def dot4(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]


def normalize4(a):
    ln = jnp.sqrt(dot4(a, a))
    return (a[0] / ln, a[1] / ln, a[2] / ln, a[3] / ln)
