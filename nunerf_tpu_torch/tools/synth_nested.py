"""Synthetic nested-transparent-object scene generator; the port's copy of
``nunerf_tpu/tools/synth_nested.py`` (numpy; images written by
``data/image_io.py`` in place of OpenCV, the same PNG pixels).

The reference repo ships no data (scenes live on an external drive link,
``README.md:16-24``), so end-to-end validation needs a scene whose ground
truth we control.  This renders a *solid glass sphere with an opaque object
inside* — the exact problem class NU-NeRF targets — with an analytic path
tracer (numpy, no external renderer):

* outer surface: glass sphere, radius ``r_outer``, IoR ``ior`` (Snell +
  Fresnel at every interface, total internal reflection handled);
* inner object: lambertian union of two spheres (a "snowman"), lit by the
  environment plus a fixed key light;
* environment: procedural sky gradient + gaussian light blobs, evaluated by
  direction — so reflections carry structure for the stage-1 shader to latch
  onto.

Output is a blender-format dataset (``transforms_{train,test}.json`` + RGBA
PNGs, alpha = outer-surface hit mask) consumed by ``nerf/<scene>`` databases
(reference ``dataset/database.py:542-651``), plus ``gt_outer.npy`` /
``gt_inner.npy`` point samples of the two ground-truth surfaces for Chamfer
evaluation of extracted meshes.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nunerf_tpu_torch.data import image_io
from nunerf_tpu_torch.data.colmap import Camera, Image, rotmat_to_qvec, write_model
from nunerf_tpu_torch.data.database import write_ply_points


# ----------------------------------------------------------------------------
# scene definition (fixed ground truth)

R_OUTER = 0.5
IOR = 1.5
# thick-shell variant: hollow glass shell of thickness SHELL_TAU with an air
# core.  The reference's thickness map saturates at 0.01 world units
# (renderer.py:1741 ``x*0.01`` with sigmoid x), so the GT shell must sit
# inside that range; 0.008 -> thickness-net target 0.8, IoR-net target 0.9
# (eta = 1/(x+0.6), renderer.py:1727).
SHELL_TAU = 0.008
# Beer-Lambert absorption inside the shell glass (per world unit, RGB).
# Round-4 finding: with perfectly clean tint-free glass the hollow scene's
# outer surface is photometrically weightless (the thin shell barely bends
# light, the sharp inner object is the better photometric optimum, and
# stage-1's transmission pathway makes "no surface" equivalent to T=1), so
# the SDF dissolves the ball and wraps the snowman instead (outer chamfer
# 0.050@20k -> 0.082@30k, mesh 68% interior junk).  Real glass absorbs;
# the colored kappa gives a grazing-angle rim tint that anchors the surface
# exactly where real captures (the reference's target regime) have signal.
GLASS_KAPPA = np.array([8.0, 2.0, 6.0])
INNER_SPHERES = (
    # (center, radius, base color)
    (np.array([0.02, 0.0, -0.10]), 0.24, np.array([0.75, 0.25, 0.15])),
    (np.array([0.02, 0.0, 0.16]), 0.16, np.array([0.20, 0.45, 0.80])),
)


def env_color(d: np.ndarray) -> np.ndarray:
    """Procedural environment radiance by direction [..., 3]."""
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    t = 0.5 * (d[..., 2:3] + 1.0)
    sky = (1.0 - t) * np.array([0.35, 0.30, 0.28]) + t * np.array([0.55, 0.70, 0.95])
    # HDRI-like environment: sharp HDR emitters AND broad bright "windows".
    # Real captures (and the reference's blender scenes with room HDRIs) have
    # bright regions over large solid angles, so the ~4% Fresnel reflection
    # carries signal across the WHOLE glass surface as the camera orbits —
    # with only small sharp emitters, surface patches between highlight
    # sweeps get no reflection constraint and the SDF caves toward the inner
    # object (observed: left-side pinch at 22k steps on scene v2).
    blobs = [
        # sharp emitters (clipped highlights)
        (np.array([0.5, 0.5, 0.7]), 60.0, np.array([16.0, 15.0, 13.0])),
        (np.array([-0.8, 0.2, 0.4]), 40.0, np.array([12.0, 5.0, 3.0])),
        (np.array([0.1, -0.9, 0.3]), 50.0, np.array([3.0, 10.0, 5.0])),
        (np.array([-0.2, 0.4, -0.85]), 45.0, np.array([8.0, 8.0, 11.0])),
        # broad windows (reflection signal over large solid angles)
        (np.array([-0.6, -0.6, 0.25]), 10.0, np.array([5.0, 4.5, 3.5])),
        (np.array([0.9, -0.3, 0.1]), 8.0, np.array([2.5, 3.5, 5.0])),
        (np.array([-0.3, 0.9, -0.2]), 9.0, np.array([4.0, 2.5, 2.0])),
        (np.array([0.3, 0.2, -0.95]), 12.0, np.array([2.0, 3.0, 2.5])),
    ]
    out = sky.copy()
    for center, sharp, col in blobs:
        center = center / np.linalg.norm(center)
        w = np.exp(sharp * (np.sum(d * center, -1, keepdims=True) - 1.0))
        out = out + w * col
    return out


def _sphere_hit(o, d, center, radius):
    """Nearest positive intersection t (inf on miss)."""
    oc = o - center
    b = np.sum(oc * d, -1)
    c = np.sum(oc * oc, -1) - radius * radius
    disc = b * b - c
    ok = disc > 0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0, t1 = -b - sq, -b + sq
    t = np.where(t0 > 1e-5, t0, t1)
    return np.where(ok & (t > 1e-5), t, np.inf)


def _refract(d, n, eta):
    """Snell refraction of d through normal n (n opposes d); eta = n1/n2.
    Returns (dir, tir_mask)."""
    cos_i = -np.sum(d * n, -1, keepdims=True)
    sin2_t = eta**2 * np.maximum(0.0, 1.0 - cos_i**2)
    tir = sin2_t[..., 0] > 1.0
    cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin2_t))
    refr = eta * d + (eta * cos_i - cos_t) * n
    refl = d + 2.0 * cos_i * n
    out = np.where(tir[..., None], refl, refr)
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-9), tir


def _fresnel(cos_i, n1, n2):
    """Exact dielectric Fresnel reflectance (unpolarized)."""
    cos_i = np.clip(cos_i, 0.0, 1.0)
    sin2_t = (n1 / n2) ** 2 * (1.0 - cos_i**2)
    tir = sin2_t > 1.0
    cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin2_t))
    rs = ((n1 * cos_i - n2 * cos_t) / np.maximum(n1 * cos_i + n2 * cos_t, 1e-9)) ** 2
    rp = ((n1 * cos_t - n2 * cos_i) / np.maximum(n1 * cos_t + n2 * cos_i, 1e-9)) ** 2
    return np.where(tir, 1.0, 0.5 * (rs + rp))


def _inner_hit(o, d):
    """Nearest hit among the inner spheres: (t, normal, albedo)."""
    best_t = np.full(o.shape[:-1], np.inf)
    normal = np.zeros_like(o)
    albedo = np.zeros_like(o)
    for center, radius, col in INNER_SPHERES:
        t = _sphere_hit(o, d, center, radius)
        closer = t < best_t
        p = o + np.where(np.isfinite(t), t, 0.0)[..., None] * d
        n = (p - center) / radius
        best_t = np.where(closer, t, best_t)
        normal = np.where(closer[..., None], n, normal)
        albedo = np.where(closer[..., None], col, albedo)
    return best_t, normal, albedo


def _shade_inner(p, n, albedo):
    """Lambertian with a fixed key light + ambient from the env gradient."""
    key = np.array([0.5, 0.5, 0.7])
    key /= np.linalg.norm(key)
    lam = np.clip(np.sum(n * key, -1, keepdims=True), 0.0, 1.0)
    amb = 0.25 * env_color(n)
    return np.clip(albedo * (0.9 * lam + amb), 0.0, 1.0)


def trace_rays(o: np.ndarray, d: np.ndarray):
    """Path-trace rays through the glass ball.  Returns (rgb, outer_hit_mask).

    Light model (per ray):
      miss outer sphere -> env
      hit: Fresnel split at entry; reflected branch -> env; refracted branch
      travels in glass, hits the inner object (lambertian, dimmed by the
      glass) or reaches the far interface where it Fresnel-splits again:
      transmitted -> env along exit dir; internally-reflected residual gets
      one more inner-object chance, then env.  TIR at the exit interface is
      handled exactly (reflectance 1).
    """
    t_out = _sphere_hit(o, d, np.zeros(3), R_OUTER)
    hit = np.isfinite(t_out)
    t_safe = np.where(hit, t_out, 0.0)

    p1 = o + t_safe[..., None] * d
    n1 = p1 / R_OUTER
    cos_i = np.clip(-np.sum(d * n1, -1, keepdims=True), 0.0, 1.0)
    r1 = _fresnel(cos_i[..., 0], 1.0, IOR)[..., None]
    refl_dir = d + 2.0 * cos_i * n1
    refl_col = env_color(refl_dir)

    # refracted branch: entry Snell (never TIR entering denser medium)
    d2, _ = _refract(d, n1, 1.0 / IOR)
    trans_col = np.zeros_like(refl_col)
    weight = np.ones(o.shape[:-1] + (1,))
    pos, dirs = p1 + 1e-5 * d2, d2
    for _bounce in range(3):
        ti, ni, alb = _inner_hit(pos, dirs)
        tg = _sphere_hit(pos, dirs, np.zeros(3), R_OUTER)
        hits_inner = ti < tg
        # inner-object shading (absorb, path ends)
        pi = pos + np.where(np.isfinite(ti), ti, 0.0)[..., None] * dirs
        inner_col = _shade_inner(pi, ni, alb)
        trans_col = trans_col + np.where(hits_inner[..., None], weight * inner_col, 0.0)
        weight = np.where(hits_inner[..., None], 0.0, weight)
        # far interface: Fresnel split glass->air
        pg = pos + np.where(np.isfinite(tg), tg, 0.0)[..., None] * dirs
        ng = pg / R_OUTER  # outward normal; ray leaves, so normal opposing = -ng... handled via cos
        cos_g = np.clip(np.sum(dirs * ng, -1, keepdims=True), 0.0, 1.0)
        rg = _fresnel(cos_g[..., 0], IOR, 1.0)[..., None]
        d_exit, tir = _refract(dirs, -ng, IOR)
        exit_col = env_color(d_exit)
        t_w = np.where(tir[..., None], 0.0, (1.0 - rg))
        trans_col = trans_col + weight * t_w * exit_col
        # internal reflection continues inside the glass
        d_refl = dirs - 2.0 * cos_g * ng
        weight = weight * np.where(tir[..., None], 1.0, rg)
        pos = pg + 1e-5 * d_refl
        dirs = d_refl
    # whatever weight survives 3 internal bounces: approximate with env
    trans_col = trans_col + weight * env_color(dirs)

    color = r1 * refl_col + (1.0 - r1) * trans_col
    color = np.where(hit[..., None], color, env_color(d))
    return np.clip(color, 0.0, 1.0), hit


def trace_rays_hollow(o: np.ndarray, d: np.ndarray, tau: float = SHELL_TAU):
    """Path-trace through a HOLLOW glass sphere (shell thickness ``tau``,
    air core) — analytic ground truth for the curvature-shell stage-2 mode
    (models/stage2_shell.py; reference renderer.py:1610-2009).

    Per ray the dominant transmission chain is traced exactly through the
    four interfaces (outer entry, inner-shell entry, inner-shell far side,
    outer exit) with exact Fresnel weights; every split's reflected residual
    terminates into the environment along its reflected direction (the
    shell renderer itself only models the transmission chain and masks TIR
    lanes out of the loss, so sub-branch truncation is invisible to it).
    Grazing rays whose refracted chord misses the air core traverse the
    shell and exit on the far side.  Returns (rgb, outer_hit_mask).
    """
    zeros = np.zeros(3)
    r_in = R_OUTER - tau
    t1 = _sphere_hit(o, d, zeros, R_OUTER)
    hit = np.isfinite(t1)
    t_safe = np.where(hit, t1, 0.0)

    p1 = o + t_safe[..., None] * d
    n1 = p1 / R_OUTER
    cos1 = np.clip(-np.sum(d * n1, -1, keepdims=True), 0.0, 1.0)
    F1 = _fresnel(cos1[..., 0], 1.0, IOR)[..., None]
    col = F1 * env_color(d + 2.0 * cos1 * n1)
    w = 1.0 - F1
    d1, _ = _refract(d, n1, 1.0 / IOR)
    pos = p1 + 1e-6 * d1

    # inner-shell entry (glass -> air core), or grazing chord through the shell
    t2 = _sphere_hit(pos, d1, zeros, r_in)
    chord = ~np.isfinite(t2)

    # --- chord branch: exit the outer sphere on the far side of the shell
    t2b = _sphere_hit(pos, d1, zeros, R_OUTER)
    p2b = pos + np.where(np.isfinite(t2b), t2b, 0.0)[..., None] * d1
    n2b = p2b / R_OUTER
    cos2b = np.clip(np.sum(d1 * n2b, -1, keepdims=True), 0.0, 1.0)
    F2b = _fresnel(cos2b[..., 0], IOR, 1.0)[..., None]
    dout_b, _ = _refract(d1, -n2b, IOR)
    refl_b = d1 - 2.0 * cos2b * n2b
    w_chord = w * np.exp(-GLASS_KAPPA
                         * np.where(np.isfinite(t2b), t2b, 0.0)[..., None])
    col_chord = col + w_chord * ((1.0 - F2b) * env_color(dout_b)
                                 + F2b * env_color(refl_b))

    # --- core branch: refract into the air core
    p2 = pos + np.where(np.isfinite(t2), t2, 0.0)[..., None] * d1
    n2 = p2 / r_in
    cos2 = np.clip(-np.sum(d1 * n2, -1, keepdims=True), 0.0, 1.0)
    F2 = _fresnel(cos2[..., 0], IOR, 1.0)[..., None]  # ==1 on TIR
    # Beer-Lambert over the entry glass traversal
    att2 = np.exp(-GLASS_KAPPA * np.where(np.isfinite(t2), t2, 0.0)[..., None])
    w = w * att2
    # the inner-interface Fresnel reflection travels BACK through the glass
    # before exiting; attenuate its return chord too (approximated by the
    # entry chord — symmetric for the near-radial paths that dominate here)
    col = col + w * att2 * F2 * env_color(d1 + 2.0 * cos2 * n2)
    w = w * (1.0 - F2)
    d2, _ = _refract(d1, n2, IOR)
    pos2 = p2 + 1e-6 * d2

    # air core: the inner object, else cross to the far inner-shell wall
    ti, ni, alb = _inner_hit(pos2, d2)
    t3 = _sphere_hit(pos2, d2, zeros, r_in)
    hits_inner = (ti < t3)[..., None]
    pi = pos2 + np.where(np.isfinite(ti), ti, 0.0)[..., None] * d2
    col = col + w * np.where(hits_inner, _shade_inner(pi, ni, alb), 0.0)
    w = np.where(hits_inner, 0.0, w)

    # far inner-shell wall (air -> glass; never TIR)
    p3 = pos2 + np.where(np.isfinite(t3), t3, 0.0)[..., None] * d2
    n3 = -p3 / r_in  # opposes the outgoing ray
    cos3 = np.clip(-np.sum(d2 * n3, -1, keepdims=True), 0.0, 1.0)
    F3 = _fresnel(cos3[..., 0], 1.0, IOR)[..., None]
    col = col + w * F3 * env_color(d2 + 2.0 * cos3 * n3)
    w = w * (1.0 - F3)
    d3, _ = _refract(d2, n3, 1.0 / IOR)

    # outer sphere from inside (glass -> air)
    t4 = _sphere_hit(p3 + 1e-6 * d3, d3, zeros, R_OUTER)
    p4 = p3 + 1e-6 * d3 + np.where(np.isfinite(t4), t4, 0.0)[..., None] * d3
    n4 = p4 / R_OUTER
    cos4 = np.clip(np.sum(d3 * n4, -1, keepdims=True), 0.0, 1.0)
    F4 = _fresnel(cos4[..., 0], IOR, 1.0)[..., None]
    d4, _ = _refract(d3, -n4, IOR)
    refl4 = d3 - 2.0 * cos4 * n4
    # Beer-Lambert over the exit glass traversal
    w = w * np.exp(-GLASS_KAPPA * np.where(np.isfinite(t4), t4, 0.0)[..., None])
    col = col + w * ((1.0 - F4) * env_color(d4) + F4 * env_color(refl4))

    col = np.where(chord[..., None], col_chord, col)
    col = np.where(hit[..., None], col, env_color(d))
    return np.clip(col, 0.0, 1.0), hit


def _look_at(cam_pos: np.ndarray) -> np.ndarray:
    forward = -cam_pos / np.linalg.norm(cam_pos)
    z_axis = -forward
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z_axis)) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    x_axis = np.cross(up, z_axis)
    x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x_axis, y_axis, z_axis, cam_pos
    return c2w


def render_view(c2w: np.ndarray, h: int, w: int, focal: float, tracer=None):
    i, j = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal,
                     -np.ones_like(i)], -1)
    R, o = c2w[:3, :3], c2w[:3, 3]
    d = dirs @ R.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(o, d.shape)
    rgb, hit = (tracer or trace_rays)(o.reshape(-1, 3), d.reshape(-1, 3))
    rgba = np.concatenate([rgb.reshape(h, w, 3),
                           hit.reshape(h, w, 1).astype(np.float64)], -1)
    # round, don't truncate: truncation would bias every pixel ~0.5/255 dark
    # relative to the analytic float tracer used for PSNR-parity scoring
    return np.round(rgba * 255).astype(np.uint8)


def gt_surface_points(n: int = 20000, seed: int = 0):
    """(outer_pts [n,3], inner_pts [n,3]) uniform samples of the GT surfaces."""
    rs = np.random.RandomState(seed)

    def sphere_pts(center, radius, k):
        v = rs.randn(k, 3)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return center + radius * v

    outer = sphere_pts(np.zeros(3), R_OUTER, n)
    # inner: union of spheres — sample each proportional to area, drop points
    # inside the other sphere
    areas = np.array([r * r for _, r, _ in INNER_SPHERES])
    counts = (n * areas / areas.sum()).astype(int)
    parts = []
    for (c, r, _), k in zip(INNER_SPHERES, counts):
        p = sphere_pts(c, r, k)
        keep = np.ones(len(p), bool)
        for (c2, r2, _) in INNER_SPHERES:
            if np.allclose(c2, c):
                continue
            keep &= np.linalg.norm(p - c2, axis=-1) > r2
        parts.append(p[keep])
    inner = np.concatenate(parts, 0)
    return outer.astype(np.float32), inner.astype(np.float32)


def make_colmap_scene(root: str, n_views: int = 56, h: int = 200,
                      w: int = 264, cam_dist: float = 2.2,
                      shell: bool = True, fov_x: float = 0.65):
    """Write a synthetic *capture-style* scene in the real-pipeline layout
    (reference ``dataset/database.py:380-539`` CustomDatabase):

        root/images/<k>.png          full frames (env background, no alpha)
        root/colmap/sparse/0         COLMAP binary model (our own writer)
        root/object_point_cloud.ply  "COLMAP features" on the object + noise
        root/meta_info.txt           up / forward rows

    The scene lives in an arbitrary *capture frame* (random-ish rotation,
    scale and offset of the canonical nested-glass world), so the database's
    whole normalization path — up/forward alignment, object-cloud centering
    and scaling, crop-by-projected-points — does real work, exactly as on a
    COLMAP reconstruction of a phone capture.  Ground-truth surface samples
    are written **in the normalized database frame** (the frame extracted
    meshes live in) by replaying the same normalization math.
    """
    # normalization rescales the world by ~1.6 (see norm_scale below); the
    # reference thickness map saturates at 0.01 *normalized* units
    # (renderer.py:1741), so the capture-frame GT shell must be thinner than
    # the blender-format scene's SHELL_TAU for its normalized image to stay
    # on the map: 0.005 canonical -> ~0.008 normalized (net target x=0.8).
    tau_canon = 0.005
    if shell:
        def tracer(o, d):
            return trace_rays_hollow(o, d, tau=tau_canon)
    else:
        tracer = trace_rays
    os.makedirs(os.path.join(root, "images"), exist_ok=True)

    # capture frame: x_cap = S * R_w @ x_canon + C
    S, C = 2.4, np.array([1.3, -0.7, 0.9])
    ang = 0.35
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(ang), -np.sin(ang)],
                   [0, np.sin(ang), np.cos(ang)]])
    Rz = np.array([[np.cos(0.6), -np.sin(0.6), 0],
                   [np.sin(0.6), np.cos(0.6), 0],
                   [0, 0, 1]])
    R_w = Rz @ Rx
    up_cap = R_w @ np.array([0.0, 0.0, 1.0])
    fwd_cap = R_w @ np.array([1.0, 0.0, 0.0])

    focal = 0.5 * w / np.tan(0.5 * fov_x)
    cams = {1: Camera(1, "SIMPLE_PINHOLE", w, h,
                      np.array([focal, w / 2.0, h / 2.0], np.float64))}
    images = {}
    rs = np.random.RandomState(3)
    ii, jj = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    for k in range(n_views):
        phi = 2 * np.pi * k / n_views
        elev = -0.35 + 1.1 * rs.rand()
        p_canon = cam_dist * np.array([
            np.cos(phi) * np.cos(elev), np.sin(phi) * np.cos(elev),
            np.sin(elev)])
        pos = S * (R_w @ p_canon) + C
        # OpenCV look-at in the capture frame (z forward, y down)
        z = (C - pos)
        z = z / np.linalg.norm(z)
        x = np.cross(z, up_cap)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], 0)
        t = -R @ pos

        # render: pixel dirs -> capture world -> canonical
        d_cam = np.stack([(ii - w / 2) / focal, (jj - h / 2) / focal,
                          np.ones_like(ii)], -1)
        d_cap = d_cam @ R  # == (R.T @ d)^T rows
        d_can = d_cap @ R_w  # R_w^T applied rowwise
        d_can = d_can / np.linalg.norm(d_can, axis=-1, keepdims=True)
        o_can = R_w.T @ ((pos - C) / S)
        o_can = np.broadcast_to(o_can, d_can.shape)
        rgb, _hit = tracer(o_can.reshape(-1, 3), d_can.reshape(-1, 3))
        img = np.round(rgb.reshape(h, w, 3) * 255).astype(np.uint8)
        name = f"{k:04d}.png"
        image_io.imwrite(os.path.join(root, "images", name), img)
        images[k + 1] = Image(k + 1, rotmat_to_qvec(R), t.copy(), 1, name)
    write_model(cams, images, {}, os.path.join(root, "colmap/sparse/0"))

    # object point cloud: outer-surface samples + a noise halo (COLMAP
    # clouds are never tight — the halo sets the normalized object scale
    # to ~R_OUTER/0.625 = 0.8 instead of exactly 1.0)
    outer, inner = gt_surface_points()
    halo = rs.randn(300, 3)
    halo = 0.625 * halo / np.linalg.norm(halo, axis=-1, keepdims=True)
    cloud_canon = np.concatenate([outer[:4000], halo], 0)
    cloud_cap = (cloud_canon @ R_w.T) * S + C
    write_ply_points(os.path.join(root, "object_point_cloud.ply"),
                     cloud_cap.astype(np.float32))
    np.savetxt(os.path.join(root, "meta_info.txt"),
               np.stack([up_cap, fwd_cap], 0))

    # GT surfaces in the normalized database frame: replay _normalize
    # (data/database.py:387-409) on the cloud we just wrote
    center = (cloud_cap.max(0) + cloud_cap.min(0)) * 0.5
    scale = 1.0 / np.max(np.linalg.norm(cloud_cap - center, axis=-1))
    u = up_cap / np.linalg.norm(up_cap)
    f = fwd_cap / np.linalg.norm(fwd_cap)
    yv = np.cross(u, f)
    xv = np.cross(yv, u)
    xv, yv = xv / np.linalg.norm(xv), yv / np.linalg.norm(yv)
    R_rec = np.stack([xv, yv, u], 0)

    def to_norm(p_canon):
        p_cap = (p_canon @ R_w.T) * S + C
        return (scale * (p_cap - center)) @ R_rec.T

    np.save(os.path.join(root, "gt_outer.npy"),
            to_norm(outer).astype(np.float32))
    np.save(os.path.join(root, "gt_inner.npy"),
            to_norm(inner).astype(np.float32))
    # GT parameters in the NORMALIZED frame — the frame the trained fields
    # and extracted meshes live in (eval_shell samples at meta r_outer)
    norm_scale = float(scale * S)
    meta = {"mode": "shell" if shell else "solid", "ior": IOR,
            "r_outer": R_OUTER * norm_scale, "norm_scale": norm_scale,
            "layout": "colmap"}
    if shell:
        meta["tau"] = tau_canon * norm_scale
        meta["glass_kappa"] = [float(k) for k in GLASS_KAPPA]
    with open(os.path.join(root, "meta.json"), "w") as fjs:
        json.dump(meta, fjs)
    return root


def make_nested_scene(root: str, n_train: int = 80, n_test: int = 8,
                      h: int = 128, w: int = 128, cam_dist: float = 2.2,
                      camera_angle_x: float = 0.65, shell: bool = False):
    """Write the blender-format dataset + GT surface samples under ``root``.

    ``shell=True`` renders the hollow-glass variant (``trace_rays_hollow``)
    and records the GT shell parameters in ``meta.json`` so shell-mode
    training can be scored against them."""
    tracer = trace_rays_hollow if shell else trace_rays
    os.makedirs(root, exist_ok=True)
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        rs = np.random.RandomState(0 if split == "train" else 1)
        for k in range(n):
            phi = 2 * np.pi * (k + (0.5 if split == "test" else 0.0)) / n
            # full elevation coverage incl. below the equator — a one-sided
            # orbit leaves the unseen bottom of the object unconstrained
            elev = -0.45 + 1.3 * rs.rand()
            pos = cam_dist * np.array([
                np.cos(phi) * np.cos(elev), np.sin(phi) * np.cos(elev),
                np.sin(elev)])
            c2w = _look_at(pos)
            rgba = render_view(c2w, h, w, focal, tracer=tracer)
            fp = f"./{split}/r_{k}"
            image_io.imwrite(os.path.join(root, f"{split}/r_{k}.png"), rgba)
            frames.append({"file_path": fp, "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)

    outer, inner = gt_surface_points()
    np.save(os.path.join(root, "gt_outer.npy"), outer)
    np.save(os.path.join(root, "gt_inner.npy"), inner)
    meta = {"mode": "shell" if shell else "solid", "ior": IOR,
            "r_outer": R_OUTER}
    if shell:
        meta["tau"] = SHELL_TAU
        meta["glass_kappa"] = [float(k) for k in GLASS_KAPPA]
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    return root
