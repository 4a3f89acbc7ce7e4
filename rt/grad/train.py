"""Inverse-rendering optimizer loop (BASELINE.json config 5): recover
camera / material parameters from a golden image by gradient descent.

The "training step" of this framework: render differentiably → image loss →
grads → optax update.  Under a device mesh (rt.dist) the render is pixel-
sharded, the loss mean triggers a cross-device psum, and parameters stay
replicated — classic data-parallel training with pixels as the batch.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import optax

from rt.config import RenderConfig
from rt.grad.diff_render import render_image_diff
from rt.grad.loss import image_mse
from rt.grad.params import (CameraParams, SphereParams, TriangleParams,
                            apply_params, apply_tri_params,
                            camera_from_params)


class TrainStep(NamedTuple):
    params: Any
    opt_state: Any
    loss: jnp.ndarray


def _tri_scene_params(base_scene, scene_fields) -> TriangleParams:
    """Map the sphere-flavored ``scene_fields`` keys onto
    TriangleParams.from_scene so the knob is honored (not silently ignored)
    for triangle scenes; unknown keys raise."""
    key_map = {"albedo": "albedo", "mat_param": "param", "param": "param",
               "vertices": "vertices"}
    kwargs = {}
    for k, v in scene_fields.items():
        if k not in key_map:
            if v:  # a requested-but-unsupported field must not freeze silently
                raise ValueError(
                    f"scene_fields key {k!r} is not supported for triangle "
                    f"scenes (supported: albedo, mat_param/param, vertices)")
            continue
        kwargs[key_map[k]] = bool(v)
    return TriangleParams.from_scene(base_scene, **kwargs)


def make_train_step(base_scene, base_camera, config: RenderConfig,
                    times: Sequence[int], optimizer: optax.GradientTransformation,
                    *, remat: bool = True) -> Callable:
    """Build the jitted step:  (params, opt_state, target) -> TrainStep.

    ``params`` is a dict with optional keys "scene" (SphereParams) and
    "camera" (CameraParams); absent keys stay frozen at the base values.
    """
    times = tuple(int(t) for t in times)

    def loss_fn(params, target):
        scene = base_scene
        if "scene" in params:
            sp = params["scene"]
            scene = (apply_tri_params(base_scene, sp)
                     if isinstance(sp, TriangleParams)
                     else apply_params(base_scene, sp))
        camera = camera_from_params(params.get("camera"), base_camera)
        img = render_image_diff(scene, camera, config, times, remat=remat)
        return image_mse(img, target)

    @jax.jit
    def step(params, opt_state, target) -> TrainStep:
        loss, grads = jax.value_and_grad(loss_fn)(params, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return TrainStep(params, opt_state, loss)

    return step


def fit(base_scene, base_camera, config: RenderConfig, target,
        *, times: Sequence[int] = (1000,), steps: int = 200,
        learning_rate: float = 2e-2, optimize_scene: bool = True,
        optimize_camera: bool = False,
        scene_fields=dict(albedo=True, mat_param=False),
        init_params: Optional[dict] = None, remat: bool = True,
        log_every: int = 0):
    """Run the recovery loop; returns (params, losses)."""
    params = {}
    if init_params:
        params.update(init_params)
    if optimize_scene and "scene" not in params:
        from rt.core.sphere import SphereArray
        if isinstance(base_scene, SphereArray):
            params["scene"] = SphereParams.from_scene(base_scene,
                                                      **scene_fields)
        else:
            params["scene"] = _tri_scene_params(base_scene, scene_fields)
    if optimize_camera and "camera" not in params:
        raise ValueError("optimize_camera requires init_params['camera'] "
                         "(a CameraParams initial guess)")

    optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(params)
    step = make_train_step(base_scene, base_camera, config, times, optimizer,
                           remat=remat)

    target = jnp.asarray(target, jnp.float32)
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, target)
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            print(f"  step {i+1}/{steps}: loss {losses[-1]:.6g}")
    return params, losses


def recorder_for(config: RenderConfig, recorder: str = "auto"):
    """The hit recorder ``fit_replay`` uses: ``"oracle"`` (pure JAX),
    ``"pallas"`` (the recording kernels, in interpret mode only when
    ``config.interpret`` asks for it), or ``"auto"``, which follows
    ``config.backend``: ``"jax"`` records with the oracle, a pallas backend
    with the kernels."""
    from rt.grad.replay import record_hits_oracle, record_hits_pallas

    if recorder == "auto":
        recorder = "oracle" if config.backend == "jax" else "pallas"
    if recorder == "oracle":
        return record_hits_oracle
    if recorder == "pallas":
        return partial(record_hits_pallas, interpret=config.interpret)
    raise ValueError(f"unknown recorder {recorder!r}")


def fit_replay(base_scene, base_camera, config: RenderConfig, target,
               *, time: int = 1000, steps: int = 120,
               rerecord_every: int = 20, learning_rate: float = 2e-2,
               scene_fields=dict(albedo=True, mat_param=False),
               init_params: Optional[dict] = None,
               gather_mode: str = "auto", frozen_geometry: bool = True,
               recorder: str = "auto", log_every: int = 0, mesh=None,
               loss_weight=None):
    """Path-replay inverse rendering — the PRODUCTION loop (fast path).

    Outer loop: re-record the Monte-Carlo path structure at the current
    parameters (``recorder_for``: the recording kernels when
    ``config.backend`` is a pallas backend, the pure-JAX oracle for
    ``"jax"``).  Inner loop: ``rerecord_every`` optimizer steps on the
    frozen-path replay objective, chained on device in ONE ``lax.scan``
    dispatch — a single scalar-stream readback per outer block.
    Returns (params dict, losses list).

    ``mesh``: an optional ``jax.sharding.Mesh`` — the BASELINE config-5
    multi-device form.  The recorded hit stream, target, and pre-gathered
    replay rows are sharded by image row over the mesh's first axis;
    parameters and optimizer state stay replicated, and the scalar loss
    mean makes XLA psum the parameter gradients over the mesh (NVLink
    between GPUs) — classic data parallelism with pixels as the batch.
    Results match the unsharded loop up to reduction order.

    ``loss_weight``: optional (H, W) per-pixel weights on the image MSE.
    The soft-then-polish pose pipeline uses an EDGE-DOWNWEIGHTED mask:
    after pose recovery a ~1 px residual misalignment concentrates the
    image mismatch in silhouette bands, and an unweighted fit drags
    materials off-truth to absorb it — interiors alone identify albedo.
    """
    import numpy as np

    from rt.core.sphere import SphereArray
    from rt.grad.gather import gather_rows_auto
    from rt.grad.loss import image_mse
    from rt.grad.replay import _tris_replay_tables, replay_color

    is_tris = not isinstance(base_scene, SphereArray)
    params = dict(init_params) if init_params else {}
    if "scene" not in params:
        if is_tris:
            params["scene"] = _tri_scene_params(base_scene, scene_fields)
        else:
            params["scene"] = SphereParams.from_scene(base_scene,
                                                      **scene_fields)
    sp = params["scene"]
    if (is_tris and frozen_geometry and isinstance(sp, TriangleParams)
            and (sp.a is not None or sp.b is not None or sp.c is not None)):
        raise ValueError("vertex optimization needs frozen_geometry=False: "
                         "the frozen-geometry fast path detaches the "
                         "triangle rows, so vertex gradients would be "
                         "silently zero")

    optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(params)
    target = jnp.asarray(target, jnp.float32)
    t_u32 = jnp.uint32(time)

    row_s = rep_s = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        ax = mesh.axis_names[0]
        rep_s = NamedSharding(mesh, P())
        row_s = lambda ndim, axis: NamedSharding(      # noqa: E731
            mesh, P(*(ax if i == axis else None for i in range(ndim))))
        target = jax.device_put(target, row_s(target.ndim, 0))
        params = jax.device_put(params, rep_s)
        opt_state = jax.device_put(opt_state, rep_s)

    rec_fn = recorder_for(config, recorder)

    def apply_scene(p):
        sp = p["scene"]
        return (apply_tri_params(base_scene, sp)
                if isinstance(sp, TriangleParams)
                else apply_params(base_scene, sp))

    # ONE jitted chain for the whole fit, with hits (and the frozen-geometry
    # pre-gathered triangle rows) as TRACED arguments: re-jitting per
    # re-record block would pay a full retrace + XLA compile every
    # `rerecord_every` steps and bake the (bounces, H, W) hits array into
    # the executable as a constant.  Only the final short block (different
    # static k) compiles a second executable.
    lw = None
    if loss_weight is not None:
        lw = jnp.asarray(loss_weight, jnp.float32)
        if mesh is not None:
            lw = jax.device_put(lw, row_s(lw.ndim, 0))
        lw_norm = jnp.sum(lw) * 3.0 + 1e-9

    def loss_of(p, hits, pre_rows):
        sc = apply_scene(p)
        cam = camera_from_params(p.get("camera"), base_camera)
        img = replay_color(sc, cam, config, t_u32, hits,
                           gather_mode=gather_mode,
                           frozen_geometry=frozen_geometry,
                           _pre_rows=pre_rows)
        if lw is None:
            return image_mse(img, target)
        d = img - target
        return jnp.sum(d * d * lw[..., None]) / lw_norm

    @partial(jax.jit, static_argnames=("k",))
    def chain(params, opt_state, hits, pre_rows, k):
        def body(c, _):
            p, s = c
            l, g = jax.value_and_grad(loss_of)(p, hits, pre_rows)
            upd, s = optimizer.update(g, s, p)
            return (optax.apply_updates(p, upd), s), l
        (p, s), ls = jax.lax.scan(body, (params, opt_state), None,
                                  length=k)
        return p, s, ls

    pre_tab = (_tris_replay_tables(base_scene)[0]
               if is_tris and frozen_geometry else None)

    @jax.jit
    def prep_rows(hits):
        i = jnp.clip(hits, 0, base_scene.m - 1)
        return jax.lax.stop_gradient(gather_rows_auto(pre_tab, i,
                                                      gather_mode))

    losses = []
    done = 0
    while done < steps:
        k = min(rerecord_every, steps - done)
        scene_now = apply_scene(params)
        cam_now = camera_from_params(params.get("camera"), base_camera)
        _, hits = rec_fn(scene_now, cam_now, config, t_u32)
        pre_rows = prep_rows(hits) if pre_tab is not None else None
        if mesh is not None:
            # hit stream (bounces, H, W) and pre-gathered rows shard by
            # image row; the replay graph is pixel-elementwise plus
            # replicated-table gathers, so XLA needs no other hints
            hits = jax.device_put(hits, row_s(hits.ndim, 1))
            if pre_rows is not None:
                pre_rows = jax.device_put(pre_rows, row_s(pre_rows.ndim, 1))
        params, opt_state, ls = chain(params, opt_state, hits, pre_rows, k)
        losses.extend(np.asarray(ls).tolist())
        done += k
        if log_every:
            print(f"  step {done}/{steps}: loss {losses[-1]:.6g}")
    return params, losses
