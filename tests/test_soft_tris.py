"""Triangle-scene soft surrogate (rt/grad/soft_tris.py) — the mesh pose
recovery path that closes BASELINE config 5's camera clause.

Mirrors tests/test_grad.py's sphere-surrogate coverage: FD-verified pose
gradients, albedo gradients, tau->0 consistency with the hard renderer's
first bounce, and end-to-end pose recovery against an EXACT-render target.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt.grad import (CameraParams, finite_difference_check, look_at_jnp,
                     make_soft_tris_loss, recover_camera_tris,
                     soft_render_tris)
from rt.scene import scenes


def small(builder, w=64, h=48, bounces=2, spp=1):
    sd = builder(w, h)
    return dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=bounces,
                                       samples_per_frame=spp))


def cube_cp():
    # scene_cube's camera (scene_tris.rs:160-180): eye (0,1,3)->(0,0,0),
    # fl 3.5, blur 0, fov 0.25*pi  (see rt/scene/scenes.py:scene_cube)
    sd = scenes.scene_cube(8, 8)
    eye = np.asarray(sd.camera.eye[:3])
    return CameraParams.create(eye, (0.0, 0.0, 0.0),
                               float(sd.camera.focal_length),
                               float(sd.camera.focal_blur),
                               float(sd.camera.fov))


def test_soft_tris_fd_camera():
    """Pose gradients of the mesh surrogate agree with central differences
    — including across silhouettes (where the hard renderer's are zero)."""
    sd = small(scenes.scene_cube)
    true_cp = cube_cp()
    target = soft_render_tris(sd.scene, look_at_jnp(true_cp), sd.config,
                              jnp.uint32(1000), tau=0.08)
    off = true_cp._replace(eye=true_cp.eye + jnp.asarray([0.07, -0.05, 0.0]),
                           fov=true_cp.fov + 0.01)
    loss = make_soft_tris_loss(sd.scene, sd.config, target, tau=0.08)
    max_rel, checks = finite_difference_check(loss, off, eps=1e-3,
                                              num_coords=8, rtol=0.08)
    # gradients must be alive, not vacuously matching zeros
    g = jax.grad(loss)(off)
    assert float(jnp.max(jnp.abs(g.eye))) > 1e-4
    assert abs(float(g.fov)) > 1e-4


def test_soft_tris_fd_albedo():
    """Joint albedo gradients (the config-5 'jointly with materials' leg)."""
    sd = small(scenes.scene_cube)
    cp = cube_cp()
    target = soft_render_tris(sd.scene, look_at_jnp(cp), sd.config,
                              jnp.uint32(1000), tau=0.08)
    loss0 = make_soft_tris_loss(sd.scene, sd.config, target, tau=0.08)
    bad = sd.scene.mat_albedo.at[0, 0].add(0.2)
    loss = lambda alb: loss0(cp, alb)
    max_rel, _ = finite_difference_check(loss, bad, eps=1e-2, num_coords=4,
                                         rtol=0.08)
    assert float(jnp.max(jnp.abs(jax.grad(loss)(bad)))) > 1e-5


def test_soft_tris_approaches_hard_first_bounce():
    """tau -> 0 limit: on a single-bounce lambertian scene the surrogate
    converges to the exact transport (albedo*0.7*sky on hits, sky on
    misses) except in the AA-jitter edge band."""
    from rt.render.renderer import render_color

    sd = small(scenes.scene_quad, bounces=1)
    hard = np.asarray(render_color(sd.scene, sd.camera, sd.config,
                                   jnp.uint32(1000)))
    soft = np.asarray(soft_render_tris(sd.scene, sd.camera, sd.config,
                                       jnp.uint32(1000), tau=0.003,
                                       tau_depth=0.2))
    mean_diff = np.abs(hard - soft).mean()
    assert mean_diff < 0.02, f"mean diff {mean_diff}"


def test_soft_tris_chunking_invariant():
    """The streamed chunk scan is exactly the unchunked sum."""
    sd = small(scenes.scene_cube)
    cam = look_at_jnp(cube_cp())
    t = jnp.uint32(1000)
    full = soft_render_tris(sd.scene, cam, sd.config, t, chunk=128)
    chunked = soft_render_tris(sd.scene, cam, sd.config, t, chunk=5)
    np.testing.assert_allclose(np.asarray(full), np.asarray(chunked),
                               atol=2e-6, rtol=0)


def test_cube_free_eye_recovery_is_gauge_limited():
    """Free 3-dof eye recovery on a mesh scene converges in LOSS but not
    necessarily in eye position: dolly-along-view and translate-vs-tilt are
    near-degenerate at surrogate fidelity (measured: loss down 22x, eye
    error only ~2x on a 1.8-degree tangential perturbation).  This is why
    the production mesh pose path is ORBIT-coordinate recovery
    (recover_orbit_tris — the reference camera's own dof, with the radius
    gauge axis explicit and freezable); free-eye stays supported for
    sphere scenes (rt/grad/soft.py) where silhouette curvature pins it."""
    from rt.render.renderer import render_color

    sd = small(scenes.scene_cube, w=96, h=72, bounces=2, spp=4)
    true_cp = cube_cp()
    target = render_color(sd.scene, look_at_jnp(true_cp), sd.config,
                          jnp.uint32(1000))

    eye = np.asarray(true_cp.eye)
    v = eye  # target is the origin for cube_cp
    a = np.deg2rad(1.8)
    c, s = np.cos(a), np.sin(a)
    v2 = np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]],
                  np.float32)
    init = true_cp._replace(eye=jnp.asarray(v2))
    rec, _, losses = recover_camera_tris(
        sd.scene, sd.config, target, init, steps=160, learning_rate=8e-3,
        taus=(0.06, 0.02, 0.008), optimize_fields=("eye",))

    err0 = float(jnp.max(jnp.abs(init.eye - true_cp.eye)))
    err1 = float(jnp.max(jnp.abs(rec.eye - true_cp.eye)))
    assert losses[-1] < losses[0] / 5, f"loss {losses[0]} -> {losses[-1]}"
    assert err1 < err0, f"eye error {err0} -> {err1}"


def test_orbit_params_roundtrip():
    """from_eye(to_camera_params(op).eye) == op (the reference's
    update_position spherical convention, camera_controller.rs:59-70)."""
    from rt.grad.soft_tris import OrbitParams

    op = OrbitParams.create(9.26, 1.57, 1.33, 0.9)
    cp = op.to_camera_params((0.0, 0.0, -4.5), 5.6, 0.0)
    back = OrbitParams.from_eye(np.asarray(cp.eye), (0.0, 0.0, -4.5), 0.9)
    np.testing.assert_allclose(
        [float(back.radius), float(back.theta), float(back.phi)],
        [9.26, 1.57, 1.33], atol=1e-5)


@pytest.mark.slow
def test_suzanne_lp_config5_pipeline():
    """BASELINE config 5 at MESH scale, end-to-end in the suite: the full
    soft-pose + replay-albedo recipe on a low-poly Suzanne
    flagship scene (225-face suzanne_lp in the scene_tris.rs:119-159 room,
    all three material kinds) small enough for CPU —

      1. exact 4-spp target + same-seed 1-spp observation at the true pose;
      2. orbit-coordinate perturbation (dtheta 2 deg, dphi 1 deg,
         dfov 0.02 rad — the full-scale setup);
      3. soft pose stage: annealed orbit recovery with the image-GRADIENT
         loss, pooled-uv full-res rays, and grad_pool=2 (hand-tuned
         pipeline elements — this test is what keeps them from regressing
         silently), then a short full-res refinement;
      4. edge-downweighted replay albedo polish at the recovered pose
         against the seed-matched observation.

    Guards >=10x reduction on theta/phi, >=2x on fov, >=5x on albedo."""
    import dataclasses

    from rt.core.camera import look_at
    from rt.grad.soft_tris import (OrbitParams, downsample,
                                   recover_orbit_tris)
    from rt.grad.train import fit_replay
    from rt.render.renderer import render_color
    from rt.scene import bvh as bvh_mod
    from rt.scene.objloader import load_asset
    from rt.scene.scenes import _tris_scene

    w, h = 192, 108
    cam = look_at((0.0, 2.2, 4.5), (0.0, 0.0, -4.5), 5.6, 0.0, np.pi * 0.3)
    meshes = [
        load_asset("suzanne_lp.obj",
                   bvh_mod.material_lambertian((0.3, 0.4, 0.6))),
        load_asset("ico_sphere.obj", bvh_mod.material_dielectric(0.2)),
        load_asset("cube_s.obj", bvh_mod.material_metal((0.5, 0.5, 0.6), 0.2)),
        load_asset("cube_m.obj", bvh_mod.material_dielectric(0.1)),
        load_asset("cube_l.obj", bvh_mod.material_lambertian((0.5, 0.5, 0.6))),
    ]
    sd = _tris_scene("suzanne_lp", meshes, cam, w, h)
    cfg = dataclasses.replace(sd.config, samples_per_frame=4)

    look_target = np.array([0.0, 0.0, -4.5], np.float32)
    fl, blur = float(cam.focal_length), float(cam.focal_blur)
    true_op = OrbitParams.from_eye(np.asarray(cam.eye[:3]), look_target,
                                   float(cam.fov))

    target = jnp.asarray(np.asarray(
        render_color(sd.scene, cam, cfg, jnp.uint32(1000))))
    cfg1 = dataclasses.replace(cfg, samples_per_frame=1)
    target1 = jnp.asarray(np.asarray(
        render_color(sd.scene, cam, cfg1, jnp.uint32(1000))))

    dth0, dph0, dfv0 = float(np.deg2rad(2.0)), float(np.deg2rad(1.0)), 0.02
    init_op = OrbitParams.create(float(true_op.radius),
                                 float(true_op.theta) + dth0,
                                 float(true_op.phi) + dph0,
                                 float(true_op.fov) + dfv0)
    true_alb = sd.scene.mat_albedo
    bad_alb = true_alb.at[0].set(jnp.asarray([0.55, 0.25, 0.35], jnp.float32))
    bad_scene = sd.scene._replace(mat_albedo=bad_alb)

    soft_cfg = dataclasses.replace(cfg, width=w // 2, height=h // 2,
                                   backend="jax")
    rec_op, losses = recover_orbit_tris(
        bad_scene, soft_cfg, downsample(target, 2), init_op, look_target,
        focal_length=fl, focal_blur=blur, steps=160, learning_rate=4e-3,
        taus=(0.02, 0.008, 0.003, 0.0012),
        optimize_fields=("theta", "phi", "fov"), loss_mode="grad",
        grad_pool=2, full_res=(h, w), chunk=128)
    rec_op, losses2 = recover_orbit_tris(
        bad_scene, dataclasses.replace(cfg, backend="jax"), target, rec_op,
        look_target, focal_length=fl, focal_blur=blur, steps=40,
        learning_rate=6e-4, taus=(0.001, 0.0004),
        optimize_fields=("theta", "phi", "fov"), loss_mode="grad",
        grad_pool=2, full_res=(h, w), chunk=128)

    dth1 = abs(float(rec_op.theta) - float(true_op.theta))
    dph1 = abs(float(rec_op.phi) - float(true_op.phi))
    dfv1 = abs(float(rec_op.fov) - float(true_op.fov))
    assert dth1 < dth0 / 10, f"theta {np.rad2deg(dth0)} -> {np.rad2deg(dth1)}"
    assert dph1 < dph0 / 10, f"phi {np.rad2deg(dph0)} -> {np.rad2deg(dph1)}"
    assert dfv1 < dfv0 / 2, f"fov {dfv0} -> {dfv1}"

    # No edge-downweighting here, deliberately: the tool's stage-4 mask
    # exists because a ~1 px pose residual at 1920x1080 concentrates
    # mismatch in silhouette bands.  At this 1/10 resolution the same
    # angular residual is ~0.1 px (no bands), and the mask instead starves
    # the 225-face subject's few interior pixels (measured: masked fit
    # stalls at 0.05 on mat 0 / drifts the dielectric; unmasked reaches
    # 0.01 on every material even 0.05 deg off-pose).
    rec_camera = look_at_jnp(rec_op.to_camera_params(look_target, fl, blur))
    params, plosses = fit_replay(
        bad_scene, rec_camera, cfg1, target1, steps=32, rerecord_every=8,
        learning_rate=5e-2)
    err0 = float(jnp.abs(bad_alb - true_alb).max())
    err1 = float(jnp.abs(params["scene"].mat_albedo - true_alb).max())
    assert err1 < err0 / 5, f"albedo {err0} -> {err1}"


def test_cube_orbit_recovery_from_exact_target():
    """Orbit-coordinate pose recovery (theta/phi/fov, radius pinned) on the
    cube against the exact renderer — the unit-scale config-5 camera
    clause."""
    from rt.grad.soft_tris import OrbitParams, recover_orbit_tris
    from rt.render.renderer import render_color

    sd = small(scenes.scene_cube, w=96, h=72, bounces=2, spp=4)
    # scene_cube's camera looks at (0, 0.1, -3.0), NOT the origin
    # (scene_tris.rs:160-180); the orbit sphere is centered there
    look_target = (0.0, 0.1, -3.0)
    fl, blur = float(sd.camera.focal_length), float(sd.camera.focal_blur)
    true_op = OrbitParams.from_eye(np.asarray(sd.camera.eye[:3]),
                                   look_target, float(sd.camera.fov))
    target = render_color(sd.scene, sd.camera, sd.config, jnp.uint32(1000))

    init = OrbitParams.create(float(true_op.radius),
                              float(true_op.theta) + np.deg2rad(2.5),
                              float(true_op.phi) - np.deg2rad(1.5),
                              float(true_op.fov) + 0.03)
    rec, losses = recover_orbit_tris(
        sd.scene, sd.config, target, init, look_target, focal_length=fl,
        focal_blur=blur, steps=200, learning_rate=8e-3,
        taus=(0.06, 0.02, 0.008, 0.003))

    def errs(op):
        return (abs(float(op.theta) - float(true_op.theta)),
                abs(float(op.phi) - float(true_op.phi)),
                abs(float(op.fov) - float(true_op.fov)))

    e0, e1 = errs(init), errs(rec)
    # measured on this config: theta 71x, phi 51x, fov 3.4x (fov is
    # pixel-limited at 96x72 — ~1 px of edge scale; the full-scale tool
    # runs at 480x270 where the floor is ~4x lower)
    assert e1[0] < e0[0] / 10, f"theta {e0[0]} -> {e1[0]}"
    assert e1[1] < e0[1] / 10, f"phi {e0[1]} -> {e1[1]}"
    assert e1[2] < e0[2] / 2, f"fov {e0[2]} -> {e1[2]}"
    assert losses[-1] < losses[0]
