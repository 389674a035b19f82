"""Stage-2 renderer, non-zero-thickness mode: curvature-aware shell
refraction; counterpart of ``nunerf_tpu/models/stage2_shell.py`` (reference
thick-glass ``Stage2Renderer``, ``network/renderer.py:907-2404``).

Each interface crossing traverses a thin shell: the local surface is
approximated by a sphere of radius ``1/sqrt(|K|)`` from the interpolated
Gaussian curvature, and the shell exit point is found analytically on the
offset sphere (entry Snell -> shell chord -> exit Snell), with a learned IoR
(``1/(x+0.6)``, renderer.py:1727) and a learned thickness (``x*0.01``,
:1741); the inner medium is air (:1732-1734).  The curvature-sign branches
(:1799-2009) are ``torch.where`` selects.

Differences from the zero-thickness mode (``models/stage2.py``):

* two Snell refractions per interface with shell displacement;
* an exiting ray first pulls the mesh hit back to the inner shell surface
  (:1880-1931) and records that as the interface point;
* outside segments take 64 samples, and on a miss stage 1's background law
  or the reference's inverse-depth law (:2101-2121);
* the inner shader is the SpecInner variant (field.py:1320-1570);
* interfaces after the first are internal (``i != 0``, :2272), and the rgb
  loss is also masked by the object mask (:1328);
* every bounce records the glass chord it crossed, which the renderer's
  Beer-Lambert term reads under ``learn_absorption``.

As in the JAX package, ``sphere_clip_outer`` is not read in shell mode: the
outer segments sample to the hit (ROADMAP.md section 3.4).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from nunerf_tpu_torch.config import merge_cfg
from nunerf_tpu_torch.fields.shading import AppShadingNetwork
from nunerf_tpu_torch.models.stage2 import Stage2Renderer, ZERO_THICK_DEFAULTS
from nunerf_tpu_torch.ops.geometry import normalize, safe_sqrt
from nunerf_tpu_torch.tracing.scene import Scene

SHELL_DEFAULTS = dict(
    ZERO_THICK_DEFAULTS,
    n_samples_outer=64,     # renderer.py:2068
    n_samples_inner=64,     # :2070 (+2x32 upsampled)
    inner_up_rounds=2,
    inner_up_each=32,
    n_bg_inverse=64,        # inverse-depth background samples (:2102)
    seg_far=4.5,
    thickness_scale=0.01,   # :1741-1742
    ior_offset=0.6,         # eta = 1/(x+0.6)  (:1727-1728)
)


def orient_to_ray(normal, direc, curvature):
    """The mesh normal turned to oppose the ray whatever the mesh's winding,
    and the curvature, which the same winding signs, flipped with it, so
    that an inward-wound mesh still puts the shell offset Q on the correct
    side: (normal, K)."""
    opposes = torch.sum(normal * -direc, dim=-1, keepdim=True) >= 0
    return torch.where(opposes, normal, -normal), torch.where(opposes, curvature, -curvature)


class Stage2ShellRenderer(Stage2Renderer):
    """The curvature-shell stage 2.  The same trainable fields as the
    zero-thickness renderer, with the SpecInner (or, under
    ``inner_diffuse_only``, DiffuseInner) inner shader; the scene's
    curvature is smoothed over 20 rings unless ``curv_smooth_iters`` says
    otherwise."""

    def __init__(self, cfg: Dict[str, Any], scene: Optional[Scene] = None,
                 stage1=None, device="cuda", seed: int = 0):
        super().__init__(merge_cfg(SHELL_DEFAULTS, cfg), scene=scene,
                         stage1=stage1, device=device, seed=seed)

    def _inner_shader(self, shader_cfg):
        """The SpecInner shader (field.py:1321-1330); inner_diffuse_only
        selects the DiffuseInner capacity instead (see models/stage2.py)."""
        return AppShadingNetwork(
            sphere_direction=bool(shader_cfg.get("sphere_direction", False)),
            human_light=False, light_pos_freq=8, refrac_freq=2,
            light_exp_max=5.0, refrac_exp_max=-0.2,
            dtype=torch.bfloat16 if self.cfg.get("mixed_precision", True) else None,
            diffuse_only=bool(self.cfg.get("inner_diffuse_only", False)),
            device=self.device)

    # interfaces after the first are internal (renderer.py:2272)
    @staticmethod
    def _is_internal(i: int) -> bool:
        return i != 0

    # ------------------------------------------------------------------
    @staticmethod
    def _shell_cross(P, n, d_in, cos_t, r, thickness, curv_pos):
        """Chord through the shell on the osculating sphere.

        P: interface point; n: interface normal (toward the incoming side);
        d_in: refracted direction inside the shell; cos_t: cos of the
        refracted angle; r: curvature radius; curv_pos: bool mask of
        positive-curvature lanes.  Returns (exit point Q, exit normal, glass
        chord length L).  Implements renderer.py:1819-1848 (entry) and
        :1944-1983 (exit legs)."""
        ctr = r * cos_t
        # positive curvature: inner sphere radius r - thickness
        delta_pos = safe_sqrt(ctr * ctr - 2 * r * thickness + thickness * thickness, 1e-4)
        # negative curvature: inner sphere radius r + thickness
        delta_neg = safe_sqrt(ctr * ctr + 2 * r * thickness + thickness * thickness, 1e-4)
        L = torch.where(curv_pos, torch.abs(ctr - delta_pos), torch.abs(ctr - delta_neg))
        center = torch.where(curv_pos, P - n * r, P + n * r)
        Q = P + d_in * (L + 0.001)
        n_after = torch.where(curv_pos, Q - center, center - Q)
        return Q, normalize(n_after), L

    @staticmethod
    def _exit_snell(d_in, n_after, eta2):
        """The second refraction, out of the shell at ``n_after``: (next
        direction, TIR mask)."""
        cos2 = torch.sum(n_after * -d_in, dim=-1, keepdim=True)
        sin2_2 = 1.0 - cos2 * cos2
        tir2 = (sin2_2 * eta2 * eta2)[..., 0] > 0.999
        sin2_t2 = torch.clamp(sin2_2 * eta2 * eta2, 0.0, 0.999)
        next_dir = normalize(eta2 * d_in
                             + (eta2 * cos2 - safe_sqrt(1 - sin2_t2, 1e-4)) * n_after)
        return next_dir, tir2

    def ray_trace(self, rays_o, rays_d, step=None):
        """3 bounces with shell refraction (renderer.py:1610-2009).  The IoR
        and thickness fields are held at their init by ``freeze_ior_*`` and
        ``freeze_thickness_*`` (see ``Stage2Renderer._freeze_flag``)."""
        cfg = self.cfg
        frozen_ior = self._freeze_flag(step, "freeze_ior_step", "freeze_ior_inv_s")
        # the thickness field collapses towards 0 while the inner NeuS is
        # still fog (a zero-thickness shell is a no-op slab whose bending the
        # inner light field paints): hold the init until geometry is ready
        frozen_th = self._freeze_flag(step, "freeze_thickness_step",
                                      "freeze_thickness_inv_s")
        rn, dev = rays_o.shape[0], rays_o.device
        zero = torch.zeros((), device=dev)
        ior_frozen = zero if frozen_ior is None else frozen_ior.to(torch.float32)
        th_frozen = zero if frozen_th is None else frozen_th.to(torch.float32)
        bounces = []
        start, direc = rays_o, normalize(rays_d)
        active = torch.ones(rn, dtype=torch.bool, device=dev)
        tir_bad = torch.zeros(rn, dtype=torch.bool, device=dev)

        for i in range(cfg["max_bounces"]):
            outside = (i % 2 == 0)
            res = self.scene.dintersect(start, direc)
            hit = res["hit"] & active
            normal, K = orient_to_ray(res["normal"] if outside else -res["normal"], direc,
                                      res["curvature"])  # K [R,1]
            r = torch.nan_to_num(1.0 / safe_sqrt(torch.abs(K), 1e-6), nan=0.1)

            ior = self._maybe_freeze(self.ior_net(res["pos"]), frozen_ior)
            eta1 = 1.0 / (ior + cfg["ior_offset"])
            # inner medium assumed air (renderer.py:1732-1734)
            eta2 = torch.full_like(eta1, 1.0 / 1.0001) / eta1
            thickness = self._maybe_freeze(self.thickness_net(res["pos"]),
                                           frozen_th) * cfg["thickness_scale"]
            if not outside:
                eta1, eta2 = 1.0 / eta2, 1.0 / eta1

            P = res["pos"]
            iface_pt = P
            cos_i = torch.sum(normal * -direc, dim=-1, keepdim=True)
            if outside:
                curv_pos = K >= 0
                sin2_i = 1.0 - cos_i * cos_i
                tir1 = (eta1 * eta1 * sin2_i)[..., 0] > 0.999
                sin2_t = torch.clamp(eta1 * eta1 * sin2_i, 0.0, 0.999)
                cos_t = safe_sqrt(1.0 - sin2_t, 1e-4)
                d_in = normalize(eta1 * direc + (eta1 * cos_i - cos_t) * normal)
                Q, n_after, chord = self._shell_cross(P, normal, d_in, cos_t, r,
                                                      thickness, curv_pos)
            else:
                # exiting: pull the outer-mesh hit back to the inner shell
                # (renderer.py:1880-1931); the interface keeps the mesh normal
                curv_pos = K <= 0
                ctr_i = r * cos_i
                delta_pos = safe_sqrt(ctr_i * ctr_i - 2 * r * thickness
                                      + thickness * thickness, 1e-4)
                delta_neg = safe_sqrt(ctr_i * ctr_i + 2 * r * thickness
                                      + thickness * thickness, 1e-4)
                L_back = torch.where(curv_pos, torch.abs(ctr_i - delta_pos),
                                     torch.abs(ctr_i - delta_neg))
                center0 = torch.where(curv_pos, P - normal * r, P + normal * r)
                P_inner = P - L_back * direc
                n_mod = normalize(torch.where(curv_pos, P_inner - center0,
                                              center0 - P_inner))
                iface_pt = P_inner

                cos_mod = torch.sum(n_mod * -direc, dim=-1, keepdim=True)
                sin2_mod = 1.0 - cos_mod * cos_mod
                tir1 = (sin2_mod * eta1 * eta1)[..., 0] > 0.999
                sin2_t1 = torch.clamp(sin2_mod * eta1 * eta1, 0.0, 0.999)
                d_in = normalize(eta1 * direc
                                 + (eta1 * cos_mod - safe_sqrt(1 - sin2_t1, 1e-4)) * n_mod)
                cos_t = safe_sqrt(1.0 - sin2_t1, 1e-4)
                Q, n_after, chord = self._shell_cross(P_inner, n_mod, d_in, cos_t, r,
                                                      thickness, curv_pos)
            next_dir, tir2 = self._exit_snell(d_in, n_after, eta2)
            tir_here = tir1 | tir2

            conv = hit & ~tir_here
            tir_bad = tir_bad | (hit & tir_here)
            bounces.append({
                "start": start, "dir": direc, "active": active,
                "hit": hit, "conv": conv, "pos": iface_pt,
                "normal": normal, "eta": eta1,
                "next_dir": next_dir, "ior_raw": ior,
                "ior_frozen": ior_frozen,
                "thickness": thickness,
                "thickness_frozen": th_frozen,
                # the glass path crossed at this interface, for the
                # Beer-Lambert term of Stage2Renderer.render
                "chord": chord + 0.001,
            })
            start, direc, active = Q, next_dir, conv

        # reference fixup (renderer.py:1660-1670): bounce-0 convergence is
        # revoked when the refracted ray fails to exit the mesh
        if len(bounces) >= 2:
            bounces[0]["conv"] = bounces[0]["conv"] & bounces[1]["hit"]
            bounces[1]["active"] = bounces[0]["conv"]

        return bounces, ~tir_bad

    # ------------------------------------------------------------------
    def _sample_outer_segment(self, b, seg_index: int = 0):
        """``n_samples_outer`` uniform to the hit; on a miss, stage 1's exact
        background law (default, see ``Stage2Renderer._stage1_bg_z``) or,
        with ``bg_sampling`` anything else, the reference's inverse-depth law
        (renderer.py:2067-2121)."""
        cfg = self.cfg
        n = cfg["n_samples_outer"]
        start, direc = b["start"], b["dir"]
        dt, dev = start.dtype, start.device

        z_frac = torch.linspace(0.0, 1.0, n, device=dev, dtype=dt)[None, :, None]
        pts_hit = start[:, None, :] + (b["pos"] - start)[:, None, :] * z_frac

        if cfg.get("bg_sampling", "stage1_exact") == "stage1_exact":
            near = cfg["bg_near0"] if seg_index == 0 else 1e-3
            z_out = self._stage1_bg_z(n, near, dt)
        else:
            z_out = torch.linspace(1e-3, 1.0 - 1.0 / (n + 1.0), n, device=dev, dtype=dt)
            z_out = 1.0 / torch.flip(z_out, dims=[-1]) + 1.0 / n  # inverse depth (:2114)
        pts_miss = start[:, None, :] + direc[:, None, :] * z_out[None, :, None]
        return torch.where(b["hit"][:, None, None], pts_hit, pts_miss)

    def _masked_rgb_loss(self, outputs, batch):
        """The rgb loss under the TIR mask and, where the batch has one, the
        object mask (renderer.py:1328)."""
        tm = outputs["tir_mask"]
        if "masks" in batch:
            tm = tm * batch["masks"][:, None]
        outputs["loss_rgb"] = self.compute_rgb_loss(outputs["ray_rgb"] * tm,
                                                    batch["rgbs"] * tm)
        return outputs

    def train_outputs(self, batch, step: int, generator=None):
        outputs = self.render(batch["rays_o"], normalize(batch["rays_d"]), step,
                              cos_anneal_ratio=self.get_anneal_val(step),
                              is_train=True)
        return self._masked_rgb_loss(outputs, batch)

    def test_outputs(self, batch, step: int, generator=None):
        outputs = self.render(batch["rays_o"], normalize(batch["rays_d"]), step,
                              cos_anneal_ratio=1.0, is_train=False,
                              with_inter=True)
        return self._masked_rgb_loss(outputs, batch)
