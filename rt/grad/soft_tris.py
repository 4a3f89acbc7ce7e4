"""Soft-visibility relaxation for TRIANGLE scenes — pose recovery on meshes.

The sphere surrogate (rt/grad/soft.py) owns pose/geometry recovery for
sphere scenes; this is its mesh twin, closing BASELINE config 5's camera
clause for Suzanne: the hard renderer's pose gradients are FD-correct but
useless for RECOVERY (the visible mismatch under a pose error is discrete
pixel reassignment), so pose is recovered on a
SMOOTH first-bounce approximation and materials are then polished with the
exact path-replay objective (rt/grad/train.fit_replay).

Per ray (soft rasterization in ray space, one Möller–Trumbore per
(ray, triangle) pair — shader_tris.wgsl:161-202's t/u/v reused as the
smooth quantities):

  margin_i = min((1-u-v)·h_A, u·h_B, v·h_C) / t   ANGULAR edge distance
             (h_X = altitude from vertex X, so w_X·h_X is the WORLD
             distance to the opposite edge; dividing by the hit depth
             makes the softness screen-space — tau is in radians, the
             same edge width for a 1000x-bigger floor quad as for a
             Suzanne ear.  Barycentric margins measured a broken loss:
             big triangles' soft bands span half the image and their
             bias gradient overwhelms the pose signal.)
  cov_i    = sigmoid(margin_i / tau) * sigmoid(t_i / tau_depth)
  w_i      = cov_i * exp(-(t_i - shift) / tau_depth)   occlusion softmin
  color    = total_cov * (Σ w_i albedo_i / Σ w_i) * 0.7 * sky(d)
             + (1 - total_cov) * sky(d),   total_cov = clip(Σ cov_i, 0, 1)

As tau -> 0 this approaches the hard renderer's first bounce with the
scatter chain replaced by its sky factor — the same limit structure as the
sphere surrogate.  Defocus blur is ignored (shared eye origin): with a
single origin every M-T term factors into per-triangle constants dotted
with the ray direction, so a triangle chunk costs 3 einsums over (C, H, W)
— matmul-shaped work — instead of per-pixel cross products.

Differentiable everywhere w.r.t. camera pose/fov AND material albedos
(jointly), and vertices if made parameters.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rt.config import RenderConfig
from rt.core.trace import sky_color
from rt.core.triangle import TriangleScene


def soft_render_tris(scene: TriangleScene, camera, config: RenderConfig,
                     time, tau: float = 0.02, tau_depth: float = 0.5,
                     chunk: int = 128, return_aux: bool = False,
                     full_res=None):
    """Smooth (H, W, 3) render of a triangle scene — differentiable w.r.t.
    camera and material albedos, everywhere.

    tau: silhouette softness in RADIANS of viewing angle (screen-space);
    ~0.02 coarse, ~0.003 is a couple of pixels at 480-wide / fov 0.9.

    chunk: triangles per scan step — bounds the live (chunk, H, W) planes
    (memory), with the sums streamed across steps.

    Rays are CLEAN pixel-center rays — no AA jitter, no defocus: the
    reference's unit-length per-pixel jitter (shader_sphere.wgsl:254-255)
    scrambles adjacent rays by +-1 px, which turns the surrogate's own
    silhouettes into noise; measured on Suzanne it erased the pose signal
    entirely (the image-gradient loss was flat to 0.04% over +-3 degrees).  The surrogate is a smooth model, not
    a Monte-Carlo estimator; its rays should be deterministic.
    """
    h, w = config.height, config.width
    o = camera.eye[:3]                            # shared origin (no blur)
    # pixel-center uv -> make_ray directions (the deterministic core of
    # tc.generate_rays / camera.make_ray, minus jitter and defocus).
    # +0.6478: the reference's AA jitter normalize(rng_vec2) is a UNIT
    # first-quadrant vector — NOT zero-mean — so every target image's
    # expected sample position is pixel + 0.5 + E[jitter] ~ 0.6478 in both
    # axes; without this constant the recovered pose carries a systematic
    # ~1 px (~0.6 deg) offset (measured: the cube landscape minimum sat at
    # -0.6 deg for every loss mode).
    jm = jnp.float32(0.6478)
    if full_res is not None:
        # the target is a FULL-RES render average-pooled to (h, w): the
        # reference's uv mapping pos/(res-1) does NOT commute with
        # pooling (479*4 != 1919), which showed up as a ~0.2 deg theta +
        # ~0.1% scale (fov) landscape bias at scale 4.  Generate rays at
        # the mean of each pooled block's FULL-RES sample positions.
        hf, wf = full_res
        fy, fx = hf // h, wf // w
        y = (jnp.arange(h, dtype=jnp.float32) * fy + (fy - 1) * 0.5
             + 0.5 + jm)[:, None]
        x = (jnp.arange(w, dtype=jnp.float32) * fx + (fx - 1) * 0.5
             + 0.5 + jm)[None, :]
        uvx = (2.0 * x / jnp.float32(wf - 1) - 1.0) * (jnp.float32(wf)
                                                       / jnp.float32(hf))
        uvy = -(2.0 * y / jnp.float32(hf - 1) - 1.0)
    else:
        y = (jnp.arange(h, dtype=jnp.float32) + 0.5 + jm)[:, None]
        x = (jnp.arange(w, dtype=jnp.float32) + 0.5 + jm)[None, :]
        uvx = (2.0 * x / jnp.float32(w - 1) - 1.0) * (jnp.float32(w)
                                                      / jnp.float32(h))
        uvy = -(2.0 * y / jnp.float32(h - 1) - 1.0)
    k = jnp.tan(camera.fov * 0.5)
    d4 = (camera.right[None, None, :] * (uvx * k)[..., None]
          + camera.up[None, None, :] * (uvy * k)[..., None]
          + camera.direction[None, None, :])      # (H, W, 4) with live w
    d4 = d4 / jnp.sqrt(jnp.sum(d4 * d4, axis=-1, keepdims=True))
    d = d4[..., :3]                               # (H, W, 3)

    # per-triangle constants (all M-T terms with a shared origin reduce to
    # dots of d against these):
    #   det = -d . n_raw;  u = -(d . se2)/det;  v = (d . q)/det;
    #   t = t_num/det   with  n_raw = e1 x e2, s = o - a,
    #                        se2 = s x e2, q = s x e1, t_num = e2 . q
    a = scene.a.astype(jnp.float32)
    e1 = scene.b.astype(jnp.float32) - a
    e2 = scene.c.astype(jnp.float32) - a
    n_raw = jnp.cross(e1, e2)
    # DIELECTRIC surfaces are (near-)transparent in the real transport —
    # the target shows the refracted background through them — but an
    # opaque-visibility surrogate would paint them solid, and their
    # phantom silhouettes bias pose alignment (measured: a +0.2-0.5 deg
    # theta/fov landscape offset on Suzanne, whose scene holds two large
    # dielectric cubes).  Zeroing n_raw makes det = 0 -> cov = 0: the
    # surrogate simply does not see them (shape-static masking).
    from rt.config import MAT_DIELECTRIC
    kind_tri = scene.mat_kind[
        jnp.clip(scene.mat_id, 0, scene.mat_kind.shape[0] - 1)]
    opaque = (kind_tri != MAT_DIELECTRIC).astype(jnp.float32)[:, None]
    n_raw = n_raw * opaque
    s = o[None, :] - a
    se2 = jnp.cross(s, e2)
    q = jnp.cross(s, e1)
    t_num = jnp.sum(e2 * q, axis=-1)
    alb = scene.mat_albedo[
        jnp.clip(scene.mat_id, 0, scene.mat_albedo.shape[0] - 1)]
    # altitudes: w_A*h_A (etc.) is the world distance from the hit point to
    # the edge opposite vertex A — 2*area / opposite-edge length
    area2 = jnp.sqrt(jnp.sum(n_raw * n_raw, axis=-1))      # 2*area
    elen = lambda e: jnp.sqrt(jnp.sum(e * e, axis=-1) + 1e-20)
    alt = jnp.stack([area2 / elen(e2 - e1),                # h_A (|C-B|)
                     area2 / elen(e2),                     # h_B (|C-A|)
                     area2 / elen(e1)], axis=-1)           # h_C (|B-A|)

    m = a.shape[0]
    pad = (-m) % chunk
    if pad:
        z3 = jnp.zeros((pad, 3), jnp.float32)
        # padding triangles have n_raw = 0 -> det = 0 -> masked invalid
        n_raw = jnp.concatenate([n_raw, z3])
        se2 = jnp.concatenate([se2, z3])
        q = jnp.concatenate([q, z3])
        t_num = jnp.concatenate([t_num, jnp.zeros((pad,), jnp.float32)])
        alb = jnp.concatenate([alb, z3])
        alt = jnp.concatenate([alt, z3])
    n_chunks = (m + pad) // chunk
    xs = tuple(v.reshape(n_chunks, chunk, -1)
               for v in (n_raw, se2, q, t_num[:, None], alb, alt))

    # occlusion weights are exp(-(t - shift)/tau_depth); the constant shift
    # cancels in the normalization and keeps magnitudes ~e^{+-few} around
    # the subject distance instead of underflowing at scene scale
    shift = camera.focal_length
    inv_tau = 1.0 / tau
    inv_td = 1.0 / tau_depth

    def body(carry, x):
        wsum, csum, covsum = carry
        n_c, se2_c, q_c, tn_c, alb_c, alt_c = x
        det = -jnp.einsum("hwk,ck->chw", d, n_c)
        valid = jnp.abs(det) > 1e-12
        inv = 1.0 / jnp.where(valid, det, 1.0)
        u = -jnp.einsum("hwk,ck->chw", d, se2_c) * inv
        v = jnp.einsum("hwk,ck->chw", d, q_c) * inv
        t = tn_c[:, 0, None, None] * inv
        # angular edge distance: min over the three edges of (barycentric
        # weight x altitude) / depth — scale-free screen-space margin
        margin = jnp.minimum(
            jnp.minimum(u * alt_c[:, 1, None, None],
                        v * alt_c[:, 2, None, None]),
            (1.0 - u - v) * alt_c[:, 0, None, None]
        ) / jnp.maximum(t, 1e-2)
        cov = (jax.nn.sigmoid(margin * inv_tau)
               * jax.nn.sigmoid(t * inv_td)
               * valid.astype(jnp.float32))
        # clip the depth logit: near-parallel rays produce huge |t| whose
        # exp would inf/underflow; the clamp only binds far from any
        # optimum (cov there is ~0 anyway)
        wgt = cov * jnp.exp(jnp.clip(-(t - shift) * inv_td, -30.0, 30.0))
        return (wsum + jnp.sum(wgt, axis=0),
                csum + jnp.einsum("chw,cz->hwz", wgt, alb_c),
                covsum + jnp.sum(cov, axis=0)), None

    h, w = config.height, config.width
    zero = jnp.zeros((h, w), jnp.float32)
    # remat: the scan's VJP would otherwise save every chunk step's
    # (chunk, H, W) intermediates — 2.4 GB at 540x960/18 chunks (measured
    # OOM); recomputing the einsums in the backward pass is cheap
    (wsum, csum, covsum), _ = jax.lax.scan(
        jax.checkpoint(body), (zero, jnp.zeros((h, w, 3), jnp.float32),
                               zero), xs)

    sky = sky_color(d)
    total_cov = jnp.clip(covsum, 0.0, 1.0)
    mean_alb = csum / (wsum[..., None] + 1e-9)
    surf = mean_alb * 0.7 * sky * total_cov[..., None]
    img = surf + (1.0 - total_cov)[..., None] * sky
    if return_aux:
        # total_cov doubles as a soft foreground mask when the scene passed
        # in holds only the subject meshes — the ROI builder's input
        return img, total_cov
    return img


def downsample(img, factor: int):
    """Average-pool (H, W, 3) by ``factor`` — the pose stage runs at reduced
    resolution (silhouettes don't need 1080p) and pooling also denoises the
    Monte-Carlo target."""
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape[0] // factor * factor, img.shape[1] // factor * factor
    img = img[:h, :w]
    return img.reshape(h // factor, factor, w // factor, factor,
                       img.shape[-1]).mean(axis=(1, 3))


def _image_grads(img):
    """Horizontal/vertical finite differences of an (H, W, 3) image."""
    return img[:, 1:] - img[:, :-1], img[1:] - img[:-1]


def subject_roi(scene: TriangleScene, camera, config: RenderConfig, *,
                subject_mat_ids, tau: float = 0.05, threshold: float = 0.2,
                dilate: int = 31):
    """(H, W) 0/1 region-of-interest mask: soft coverage of the SUBJECT
    meshes (by material id) at the given (initial-guess) camera, dilated by
    ``dilate`` pixels.  In enclosed scenes the full-frame loss is dominated
    by wall-color bias and target gradient noise (measured flat/biased
    landscapes on Suzanne); restricting the
    loss to the subject's silhouette neighbourhood is the standard pose-
    estimation answer, and the dilation covers the whole perturbation
    basin (2 deg ~ 35 px at 480 wide)."""
    ids = jnp.asarray(list(subject_mat_ids))
    keep = jnp.isin(scene.mat_id, ids)
    idx = jnp.nonzero(keep)[0]
    # bmin/bmax (the BVH planes) are intentionally left at the FULL scene's
    # values: soft_render_tris never traverses the BVH (it scans the
    # triangle list), so the filtered scene is only valid for the soft
    # path — do not hand it to a BVH-walking renderer.
    fg = scene._replace(a=scene.a[idx], b=scene.b[idx], c=scene.c[idx],
                        normal=scene.normal[idx], mat_id=scene.mat_id[idx])
    _, cov = soft_render_tris(fg, camera, config, jnp.uint32(1000), tau=tau,
                              return_aux=True)
    mask = (cov > threshold).astype(jnp.float32)
    k = dilate
    return jax.lax.reduce_window(mask, -jnp.inf, jax.lax.max, (k, k), (1, 1),
                                 "SAME")


def make_soft_tris_loss(scene: TriangleScene, config: RenderConfig, target,
                        time=1000, tau: float = 0.02, tau_depth: float = 0.5,
                        chunk: int = 128, loss_mode: str = "mse",
                        grad_pool: int = 1, weight=None, full_res=None):
    """loss(camera_params, mat_albedo|None) -> scalar vs an (H, W, 3) target
    (typically the exact render at the true pose, downsampled to the soft
    resolution).

    loss_mode:
      "mse"  — raw image MSE (fine for open scenes);
      "grad" — MSE of image FINITE DIFFERENCES.  In enclosed scenes
               (Suzanne sits inside a lambertian room, scene_tris.rs:119+)
               the surrogate's smooth color bias against the multi-bounce
               target dominates a raw MSE and drags pose AWAY from truth
               (measured: loss down 1.8x while pose error grew 9x); edges
               are where the surrogate is faithful, and spatial gradients
               suppress the smooth bias while keeping silhouette
               alignment.
      "mse+grad" — sum of both.

    grad_pool: average-pool both images by this factor before the
    finite differences (grad modes only) — suppresses the target's
    Monte-Carlo gradient noise and widens the alignment basin.

    weight: optional (H, W) loss weights (e.g. subject_roi) — normalized
    weighted means replace the plain means."""
    from rt.grad.params import look_at_jnp

    target = jnp.asarray(target, jnp.float32)
    tpool = downsample(target, grad_pool) if grad_pool > 1 else target
    tdx, tdy = _image_grads(tpool)
    t = jnp.uint32(time)
    if weight is not None:
        weight = jnp.asarray(weight, jnp.float32)
        wpool = downsample(weight[..., None], grad_pool)[..., 0] \
            if grad_pool > 1 else weight

    def wmean(sq, wgt):
        if wgt is None:
            return jnp.mean(sq)
        return (jnp.sum(sq * wgt[..., None])
                / (jnp.sum(wgt) * sq.shape[-1] + 1e-9))

    @jax.jit
    def loss(cp, mat_albedo=None):
        sc = scene if mat_albedo is None else scene._replace(
            mat_albedo=mat_albedo)
        img = soft_render_tris(sc, look_at_jnp(cp), config, t, tau=tau,
                               tau_depth=tau_depth, chunk=chunk,
                               full_res=full_res)
        out = 0.0
        if loss_mode in ("mse", "mse+grad"):
            out = out + wmean((img - target) ** 2,
                              None if weight is None else weight)
        if loss_mode in ("grad", "mse+grad"):
            ipool = downsample(img, grad_pool) if grad_pool > 1 else img
            dx, dy = _image_grads(ipool)
            wx = wy = None
            if weight is not None:
                wx, wy = wpool[:, 1:], wpool[1:]
            out = (out + wmean((dx - tdx) ** 2, wx)
                   + wmean((dy - tdy) ** 2, wy))
        return out

    return loss


class OrbitParams(NamedTuple):
    """The reference's OrbitCamera dof (src/camera_controller.rs:5-29):
    eye = target + radius * (sin(phi)cos(theta), cos(phi), sin(phi)sin(theta))
    (update_position, :59-70).  Optimizing pose in THESE coordinates matches
    the parameters a user of the reference actually controls — and makes the
    radius/fov dolly-zoom gauge direction an explicit, freezable axis."""

    radius: jnp.ndarray   # () f32
    theta: jnp.ndarray    # () f32
    phi: jnp.ndarray      # () f32
    fov: jnp.ndarray      # () f32

    @staticmethod
    def create(radius, theta, phi, fov) -> "OrbitParams":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return OrbitParams(f(radius), f(theta), f(phi), f(fov))

    @staticmethod
    def from_eye(eye, target, fov) -> "OrbitParams":
        import numpy as np
        v = np.asarray(eye, np.float64) - np.asarray(target, np.float64)
        r = float(np.linalg.norm(v))
        phi = float(np.arccos(np.clip(v[1] / r, -1.0, 1.0)))
        theta = float(np.arctan2(v[2], v[0]))
        return OrbitParams.create(r, theta, phi, fov)

    def to_camera_params(self, look_target, focal_length, focal_blur):
        from rt.grad.params import CameraParams
        t = jnp.asarray(look_target, jnp.float32)
        sp, cp = jnp.sin(self.phi), jnp.cos(self.phi)
        st, ct = jnp.sin(self.theta), jnp.cos(self.theta)
        eye = t + self.radius * jnp.stack([sp * ct, cp, sp * st])
        return CameraParams(eye, t, jnp.asarray(focal_length, jnp.float32),
                            jnp.asarray(focal_blur, jnp.float32), self.fov)


def recover_orbit_tris(scene: TriangleScene, config: RenderConfig, target,
                       init_orbit: OrbitParams, look_target, *,
                       focal_length, focal_blur=0.0, steps: int = 160,
                       learning_rate: float = 1e-2,
                       taus=(0.06, 0.02, 0.008, 0.003), time=1000,
                       tau_depth: float = 0.5,
                       optimize_fields=("theta", "phi", "fov"),
                       chunk: int = 128, loss_mode: str = "mse",
                       grad_pool: int = 1, weight=None, full_res=None,
                       return_best: bool = True, log_every: int = 0):
    """Annealed pose recovery in ORBIT coordinates (the reference camera's
    own dof).  Returns (OrbitParams, losses).

    Freezing ``radius`` (the default field set) pins the dolly-zoom gauge
    direction — radius-vs-fov is the classic near-degenerate pair; include
    "radius" in optimize_fields to recover all four axes."""
    import optax

    fields = set(optimize_fields)
    mask = OrbitParams(**{f: (f in fields) for f in OrbitParams._fields})

    op = init_orbit
    losses = []
    best = None
    for stage, tau in enumerate(taus):
        loss0 = make_soft_tris_loss(scene, config, target, time=time,
                                    tau=tau, tau_depth=tau_depth,
                                    chunk=chunk, loss_mode=loss_mode,
                                    grad_pool=grad_pool, weight=weight,
                                    full_res=full_res)
        loss = jax.jit(lambda o: loss0(
            o.to_camera_params(look_target, focal_length, focal_blur)))
        opt = optax.adam(learning_rate)
        st = opt.init(op)
        grad = jax.jit(jax.value_and_grad(loss))
        for i in range(max(1, steps // len(taus))):
            l, g = grad(op)
            losses.append(float(l))
            # near the optimum adam oscillates at sub-pixel scale: keep the
            # best-loss iterate of the FINAL tau stage (losses are only
            # comparable within one tau).  `l` was evaluated at the
            # PRE-update `op`, so record that iterate — pairing it with the
            # post-update one would discard the params that achieved it.
            if (return_best and stage == len(taus) - 1
                    and (best is None or losses[-1] < best[0])):
                best = (losses[-1], op)
            g = jax.tree_util.tree_map(
                lambda gi, mi: gi if mi else jnp.zeros_like(gi), g, mask)
            upd, st = opt.update(g, st, op)
            op = optax.apply_updates(op, upd)
            if log_every and (i + 1) % log_every == 0:
                print(f"  tau={tau} step {i+1}: loss {losses[-1]:.3e}")
    if return_best and best is not None:
        op = best[1]
    return op, losses


def recover_camera_tris(scene: TriangleScene, config: RenderConfig, target,
                        init_params, *, steps: int = 150,
                        learning_rate: float = 2e-2,
                        taus=(0.06, 0.02, 0.008), time=1000,
                        tau_depth: float = 0.5,
                        optimize_fields=("eye", "fov"),
                        optimize_albedo: bool = False, chunk: int = 128,
                        log_every: int = 0):
    """Annealed mesh-scene pose recovery: coarse-to-fine tau on the soft
    surrogate; optionally recovers material albedos jointly.  Returns
    (CameraParams, mat_albedo or None, losses).

    ``optimize_fields`` freezes the rest of the pose (the full camera
    parameterization is gauge-ambiguous — same policy as the sphere
    surrogate's recover_camera)."""
    import optax

    fields = set(optimize_fields)
    mask = type(init_params)(
        **{f: (f in fields) for f in init_params._fields})

    cp = init_params
    albedo = scene.mat_albedo if optimize_albedo else None
    losses = []
    for tau in taus:
        loss = make_soft_tris_loss(scene, config, target, time=time, tau=tau,
                                   tau_depth=tau_depth, chunk=chunk)
        params = (cp, albedo) if optimize_albedo else (cp,)
        opt = optax.adam(learning_rate)
        st = opt.init(params)
        grad = jax.jit(jax.value_and_grad(
            lambda p: loss(*p) if optimize_albedo else loss(p[0])))
        for i in range(max(1, steps // len(taus))):
            l, g = grad(params)
            gcp = jax.tree_util.tree_map(
                lambda gi, mi: gi if mi else jnp.zeros_like(gi), g[0], mask)
            g = (gcp,) + g[1:]
            upd, st = opt.update(g, st, params)
            params = optax.apply_updates(params, upd)
            losses.append(float(l))
            if log_every and (i + 1) % log_every == 0:
                print(f"  tau={tau} step {i+1}: loss {losses[-1]:.3e}")
        cp = params[0]
        if optimize_albedo:
            albedo = params[1]
    return cp, albedo, losses
