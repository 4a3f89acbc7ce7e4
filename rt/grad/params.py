"""Differentiable parameter pytrees for inverse rendering.

The reference has no gradient story at all (Rust + WGSL forward only); this
subsystem is new capability: recover camera / material / geometry
parameters from a golden render by gradient descent (BASELINE.json config 5).

Design: parameters live in small pytrees (`CameraParams`, `SphereParams`)
that are *applied onto* a base scene right inside the traced loss function,
so the whole path  params → camera basis → rays → intersections → scatter →
EMA image → loss  is one differentiable XLA graph.  Discrete Monte-Carlo
decisions (hit index, material arm, reflect-vs-refract Bernoulli) stay frozen
at their sampled values — `jnp.where` routes gradients through the chosen
branch only, the standard detached-sampling estimator this replicates from
differentiable-rendering practice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from rt.core.camera import Camera
from rt.core.sphere import SphereArray


class CameraParams(NamedTuple):
    """Differentiable camera: the inputs of Camera::new (src/scene/camera.rs:15-28)."""

    eye: jnp.ndarray           # (3,) f32
    target: jnp.ndarray        # (3,) f32
    focal_length: jnp.ndarray  # ()  f32
    focal_blur: jnp.ndarray    # ()  f32
    fov: jnp.ndarray           # ()  f32

    @staticmethod
    def create(eye, target, focal_length, focal_blur, fov) -> "CameraParams":
        f = lambda v: jnp.asarray(np.asarray(v, np.float32))
        return CameraParams(f(eye), f(target), f(focal_length), f(focal_blur),
                            f(fov))


def _normalize3(v):
    return v / jnp.sqrt(jnp.sum(v * v))


def look_at_jnp(p: CameraParams) -> Camera:
    """Traceable/differentiable replica of Camera::new (src/scene/camera.rs:15-28):
    right = normalize(dir × +Y), up = normalize(right × dir), w = 1 on every
    basis vector (the vec4-normalize quirk in make_ray needs those w's)."""
    d = _normalize3(p.target - p.eye)
    r = _normalize3(jnp.cross(d, jnp.array([0.0, 1.0, 0.0], jnp.float32)))
    u = _normalize3(jnp.cross(r, d))
    one = jnp.ones((1,), jnp.float32)
    ext = lambda v: jnp.concatenate([v, one])
    return Camera(eye=ext(p.eye), direction=ext(d), up=ext(u), right=ext(r),
                  focal_length=p.focal_length, focal_blur=p.focal_blur,
                  fov=p.fov)


class SphereParams(NamedTuple):
    """Differentiable per-sphere scene parameters (any field may be None to
    freeze it at the base scene's value)."""

    albedo: Optional[jnp.ndarray] = None     # (N, 3)
    mat_param: Optional[jnp.ndarray] = None  # (N,)  fuzz / IOR
    center: Optional[jnp.ndarray] = None     # (N, 3)
    radius: Optional[jnp.ndarray] = None     # (N,)

    @staticmethod
    def from_scene(scene: SphereArray, *, albedo=True, mat_param=False,
                   center=False, radius=False) -> "SphereParams":
        return SphereParams(
            albedo=scene.albedo if albedo else None,
            mat_param=scene.mat_param if mat_param else None,
            center=scene.center if center else None,
            radius=scene.radius if radius else None)


def apply_params(scene: SphereArray, p: SphereParams) -> SphereArray:
    """Overlay differentiable fields onto the base scene (mat_kind stays
    discrete and fixed)."""
    return scene._replace(
        albedo=scene.albedo if p.albedo is None else p.albedo,
        mat_param=scene.mat_param if p.mat_param is None else p.mat_param,
        center=scene.center if p.center is None else p.center,
        radius=scene.radius if p.radius is None else p.radius)


def camera_from_params(p: Optional[CameraParams], base: Camera) -> Camera:
    return base if p is None else look_at_jnp(p)


class TriangleParams(NamedTuple):
    """Differentiable TriangleScene parameters: the per-MESH material table
    (the reference's scene_tris.rs:21-44 — BASELINE config 5's 'optimize
    material albedo/roughness' for Suzanne) plus, optionally, the VERTEX
    geometry itself.  When any vertex field is set, face normals are
    re-derived differentiably inside apply_tri_params with the reference
    BVH build's convention (normalize(cross(b-a, c-a)), tree.rs:67-70), so
    normals stay consistent with the moving surface.  Vertex optimization
    requires replay_color(..., frozen_geometry=False) — the frozen-geometry
    fast path deliberately detaches the triangle rows."""

    mat_albedo: Optional[jnp.ndarray] = None  # (K, 3)
    mat_param: Optional[jnp.ndarray] = None   # (K,)  fuzz / IOR
    a: Optional[jnp.ndarray] = None           # (m, 3) vertex 0
    b: Optional[jnp.ndarray] = None           # (m, 3) vertex 1
    c: Optional[jnp.ndarray] = None           # (m, 3) vertex 2

    @staticmethod
    def from_scene(scene, *, albedo=True, param=False,
                   vertices=False) -> "TriangleParams":
        return TriangleParams(
            mat_albedo=scene.mat_albedo if albedo else None,
            mat_param=scene.mat_param if param else None,
            a=scene.a if vertices else None,
            b=scene.b if vertices else None,
            c=scene.c if vertices else None)


def apply_tri_params(scene, p: TriangleParams):
    sc = scene._replace(
        mat_albedo=scene.mat_albedo if p.mat_albedo is None else p.mat_albedo,
        mat_param=scene.mat_param if p.mat_param is None else p.mat_param,
        a=scene.a if p.a is None else p.a,
        b=scene.b if p.b is None else p.b,
        c=scene.c if p.c is None else p.c)
    if p.a is not None or p.b is not None or p.c is not None:
        e1 = sc.b - sc.a
        e2 = sc.c - sc.a
        n = jnp.cross(e1, e2)
        # clamp the norm: a triangle collapsed to zero area (degenerate
        # input, or transiently mid vertex-optimization) would otherwise
        # yield 0/0 = NaN and poison the whole loss/gradient through
        # image_mse; bit-identical for any non-degenerate triangle
        # (real face normals have |n| >> 1e-20)
        n = n / jnp.maximum(
            jnp.sqrt(jnp.sum(n * n, axis=-1, keepdims=True)), 1e-20)
        sc = sc._replace(normal=n)
    return sc
