"""Stage-1 renderer: outer transparent surface as a NeuS SDF + NeRF++
background; counterpart of ``nunerf_tpu/models/stage1.py`` (reference
``network/renderer.py:102-903``).

Differences of form from the JAX package, not of result:
* the networks are submodules of one ``nn.Module`` (``sdf_net``, ``var_net``,
  ``outer_nerf``, ``color_net``, ``inf_out``: the JAX parameter tree's
  ``sdf``, ``var``, ``nerf``, ``shade``, ``inf_out``);
* step gates (init-SDF regulariser < 1000, occlusion loss >= occ_loss_step)
  are Python ``if``s on the integer step;
* random draws come from a ``torch.Generator`` on the renderer's device;
  the occlusion-loss subset is a random-priority ``torch.topk``;
* the value-only SDF sweeps run under ``torch.no_grad`` (the reference's
  ``no_grad``, the JAX package's ``stop_gradient``) and go through the fused
  chain kernel K1 on CUDA.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nunerf_tpu_torch.config import SHADER_DEFAULTS, STAGE1_DEFAULTS, merge_cfg
from nunerf_tpu_torch.device import resolve_device
from nunerf_tpu_torch.fields.aux import InfOutNetwork
from nunerf_tpu_torch.fields.nerf import NeRFNetwork
from nunerf_tpu_torch.fields.sdf import (
    SDFNetwork,
    fused_sdf_apply,
    sdf_value_feature_grad,
)
from nunerf_tpu_torch.fields.shading import AppShadingNetwork
from nunerf_tpu_torch.fields.variance import SingleVarianceNetwork
from nunerf_tpu_torch.ops.fused_mlp import use_fused_sdf_value
from nunerf_tpu_torch.ops.geometry import normalize
from nunerf_tpu_torch.ops.sampling import get_intersection, merge_z_vals, neus_upsample
from nunerf_tpu_torch.ops.srgb import linear_to_srgb
from nunerf_tpu_torch.ops.volume import alpha_to_weights

# JAX parameter-tree key -> submodule name
PARAM_KEYS = {"sdf": "sdf_net", "var": "var_net", "nerf": "outer_nerf",
              "shade": "color_net", "inf_out": "inf_out"}


def masked_mean(x, mask, eps: float = 1e-8):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=eps)


class ShapeRenderer(nn.Module):
    """Stage-1 renderer.  Runs on ``device`` ("cuda" unless the caller asks
    for the CPU); weights come from ``seed`` through ``init_params``."""

    def __init__(self, cfg: Dict[str, Any], device="cuda", seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        defaults = dict(STAGE1_DEFAULTS)
        if (cfg or {}).get("zero_thickness", False):
            defaults["train_ray_num"] = 512
            defaults["downsample_ratio"] = 0.5
        self.cfg = merge_cfg(defaults, cfg)
        if self.cfg.get("fused_sdf") or self.cfg.get("fused_mlp"):
            raise NotImplementedError(
                "fused_sdf (K4/K5) and fused_mlp on the NeRF/predictor heads "
                "are not ported yet")
        shader_cfg = merge_cfg(SHADER_DEFAULTS, self.cfg.get("shader_config") or {})
        self.shader_cfg = shader_cfg
        dev = self.device
        sdf_dtype = torch.bfloat16 if self.cfg.get("sdf_mixed_precision") else None
        self.sdf_net = SDFNetwork(
            d_out=self.cfg["sdf_d_out"], n_layers=self.cfg["sdf_n_layers"],
            skip_in=(self.cfg["sdf_n_layers"] // 2,), multires=self.cfg["sdf_freq"],
            bias=self.cfg["sdf_bias"], geometric_init=self.cfg["geometry_init"],
            dtype=sdf_dtype, device=dev)
        self.var_net = SingleVarianceNetwork(
            init_val=self.cfg["inv_s_init"], activation=self.cfg["std_act"],
            device=dev)
        dtype = torch.bfloat16 if self.cfg.get("mixed_precision", True) else None
        fsv = self.cfg.get("fused_sdf_value")
        if fsv is None:
            fsv = use_fused_sdf_value(dev)
        self.fused_sdf_value = bool(fsv)
        self.outer_nerf = NeRFNetwork(rgb_bias_init=float(np.log(0.5)),
                                      dtype=dtype, device=dev)
        self.color_net = AppShadingNetwork(
            human_light=shader_cfg["human_light"],
            sphere_direction=shader_cfg["sphere_direction"],
            light_pos_freq=shader_cfg["light_pos_freq"],
            inner_init=shader_cfg["inner_init"],
            roughness_init=shader_cfg["roughness_init"],
            metallic_init=shader_cfg["metallic_init"],
            light_exp_max=shader_cfg["light_exp_max"],
            refrac_freq=shader_cfg["refrac_freq"],
            dtype=dtype, device=dev)
        self.inf_out = InfOutNetwork(device=dev)
        self.init_params(torch.Generator().manual_seed(seed))
        self.generator = torch.Generator(device=dev).manual_seed(seed)

    def init_params(self, generator: torch.Generator):
        """Re-draw every parameter from a CPU ``generator``."""
        for key in PARAM_KEYS.values():
            getattr(self, key).reset_parameters(generator)

    # ----- field evaluation helpers -----------------------------------
    def sdf(self, x):
        """SDF value only [..., 1]: the sampling sweeps, the occlusion march
        and the init-SDF regulariser.  Fused kernel behind the gate."""
        if self.fused_sdf_value:
            return fused_sdf_apply(self.sdf_net, x, value_only=True)
        return self.sdf_net(x)[..., :1]

    def sdf_all(self, x):
        """(sdf [N], feats [N,256], grad [N,3]) with a differentiable grad."""
        return sdf_value_feature_grad(self.sdf_net, x)

    def inv_s(self, x):
        return self.var_net(x)

    def _rand(self, shape, generator):
        return torch.rand(shape, generator=generator, device=self.device)

    # ----- sampling ----------------------------------------------------
    def _bg_tail(self, far, rn, perturb, generator):
        n_bg = self.cfg["n_bg_samples"]
        z_out = torch.linspace(1e-3, 1.0 - 1.0 / (n_bg + 1.0), n_bg,
                               device=self.device)
        if perturb > 0:
            mids = 0.5 * (z_out[1:] + z_out[:-1])
            upper = torch.cat([mids, z_out[-1:]])
            lower = torch.cat([z_out[:1], mids])
            z_out = lower[None, :] + (upper - lower)[None, :] * self._rand((rn, n_bg), generator)
        else:
            z_out = z_out[None, :].expand(rn, n_bg)
        return far / torch.flip(z_out, dims=[-1]) + 1.0 / n_bg

    @torch.no_grad()
    def sample_ray(self, rays_o, rays_d, near, far, perturb: float, generator):
        """Hierarchical NeuS sampling (renderer.py:585-625): z_vals
        [R, n_samples+n_importance+n_bg_samples]."""
        rn = rays_o.shape[0]
        z_out = self._bg_tail(far, rn, perturb, generator)
        z_vals = self._hierarchical_inner(rays_o, rays_d, near, far, perturb,
                                          generator, abs_jitter=True)
        return torch.cat([z_vals, z_out], dim=-1)

    @torch.no_grad()
    def sample_ray_partitioned(self, rays_o, rays_d, near, far, perturb: float,
                               generator):
        """Sphere-clipped sampling, a static partition of the sample axis:
        (z_vals [R, F+I+B], sphere_hit [R]) with (F, I) = (n_front,
        n_samples + n_importance)."""
        cfg = self.cfg
        n_front, n_back = cfg["n_front_samples"], cfg["n_back_samples"]
        rn = rays_o.shape[0]

        a = torch.sum(rays_d * rays_d, dim=-1, keepdim=True)
        b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
        c = torch.sum(rays_o * rays_o, dim=-1, keepdim=True) - 1.0
        disc = b * b - 4.0 * a * c
        hit = disc[..., 0] > 0.0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        mid = -b / (2.0 * a)
        t0 = torch.where(hit[:, None], (-b - sq) / (2.0 * a), mid)
        t1 = torch.where(hit[:, None], (-b + sq) / (2.0 * a), mid)
        t0 = torch.minimum(torch.maximum(t0, near), far)
        t1 = torch.minimum(torch.maximum(t1, near), far)
        sphere_hit = hit & (t1[..., 0] > t0[..., 0])

        def gap_fractions(n):
            base = (torch.arange(n, dtype=torch.float32, device=self.device) + 0.5) / n
            if perturb > 0:
                return base[None, :] + (self._rand((rn, n), generator) - 0.5) / n
            return base[None, :].expand(rn, n)

        z_front = near + (t0 - near) * gap_fractions(n_front)
        z_back = t1 + (far - t1) * gap_fractions(n_back)
        z_out = self._bg_tail(far, rn, perturb, generator)

        z_in = self._hierarchical_inner(rays_o, rays_d, t0, t1, perturb, generator)
        z_in = torch.minimum(torch.maximum(z_in, t0), t1)
        return torch.cat([z_front, z_in, z_back, z_out], dim=-1), sphere_hit

    @torch.no_grad()
    def _hierarchical_inner(self, rays_o, rays_d, near, far, perturb: float,
                            generator, abs_jitter: bool = False):
        """The hierarchical NeuS rounds over [near, far]: [R, n_s + n_imp]
        sorted ascending."""
        cfg = self.cfg
        n_samples, n_imp = cfg["n_samples"], cfg["n_importance"]
        steps = cfg["up_sample_steps"]
        rn = rays_o.shape[0]

        z_vals = torch.linspace(0.0, 1.0, n_samples, device=self.device)[None, :]
        z_vals = near + (far - near) * z_vals
        if perturb > 0:
            t_rand = self._rand((rn, 1), generator) - 0.5
            amp = 2.0 if abs_jitter else 2.0 * (far - near)
            z_vals = z_vals + t_rand * amp / n_samples

        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        sdf = self.sdf(pts.reshape(-1, 3)).reshape(rn, n_samples)
        for i in range(steps):
            sn = z_vals.shape[1]
            if cfg["clip_sample_variance"]:
                inv_s = self.inv_s(torch.zeros((1, 3), device=self.device))[0, 0]
                inv_s = torch.clamp(inv_s, max=64 * 2 ** i) * torch.ones(
                    (rn, sn - 1), device=self.device)
            else:
                inv_s = torch.ones((rn, sn - 1), device=self.device) * 64 * 2 ** i
            new_z = neus_upsample(rays_o, rays_d, z_vals, sdf, n_imp // steps, inv_s)
            if i + 1 < steps:
                new_pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z[..., None]
                new_sdf = self.sdf(new_pts.reshape(-1, 3)).reshape(rn, new_z.shape[1])
                z_vals, sdf = merge_z_vals(z_vals, new_z, sdf, new_sdf)
            else:
                z_vals, _ = merge_z_vals(z_vals, new_z, sdf, None)
        return z_vals

    # ----- shading branches --------------------------------------------
    def compute_density_alpha(self, points, dists, dirs):
        """NeRF++ background alpha/color (renderer.py:700-706)."""
        norm = torch.clamp(torch.linalg.norm(points, dim=-1, keepdim=True), min=1e-3)
        pts4 = torch.cat([points / norm, 1.0 / norm], dim=-1)
        density, color = self.outer_nerf(pts4, dirs)
        alpha = 1.0 - torch.exp(-F.softplus(density[..., 0]) * dists)
        color = linear_to_srgb(torch.exp(torch.clamp(color, max=5.0)))
        return alpha, color

    def compute_sdf_alpha(self, points, dists, dirs, cos_anneal_ratio, step):
        """NeuS alpha from SDF (renderer.py:670-698)."""
        sdf, feats, grads = self.sdf_all(points)
        inv_s = torch.clamp(self.inv_s(points), 1e-6, 1e6)[..., 0]
        freeze = self.cfg.get("freeze_inv_s_step")
        if freeze is not None and step < freeze:
            inv_s = inv_s.detach()
        true_cos = torch.sum(dirs * grads, dim=-1)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                     + torch.relu(-true_cos) * cos_anneal_ratio)
        est_next = sdf + iter_cos * dists * 0.5
        est_prev = sdf - iter_cos * dists * 0.5
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        next_cdf = torch.sigmoid(est_next * inv_s)
        alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
        return alpha, grads, feats, inv_s, sdf

    # ----- losses ------------------------------------------------------
    def _occ_loss(self, points, sdf, grads, dirs, occ_prob, reflective,
                  valid_mask, generator):
        """Occlusion loss (renderer.py:708-736) on a fixed-K random subset."""
        k = min(int(self.cfg["occ_loss_max_pn"]), points.shape[0])
        inner = torch.linalg.norm(points, dim=-1) < 0.999
        sdf_ok = torch.abs(sdf) < self.cfg["occ_sdf_thresh"]
        facing = torch.sum(grads * dirs, dim=-1) < 0
        mask = (inner & sdf_ok & facing & valid_mask).detach()

        pri = self._rand(mask.shape, generator)
        pri = torch.where(mask, pri, torch.full_like(pri, -1.0))
        idx = torch.topk(pri, k).indices
        sel_valid = mask[idx]
        sel_pts = points[idx].detach()
        sel_ref = occ_prob[idx]
        sel_dirs = reflective[idx].detach()

        _, inter_prob, _ = get_intersection(self.sdf, self.inv_s, sel_pts,
                                            sel_dirs, sn0=64, sn1=16)
        occ_gt = torch.sum(inter_prob, dim=-1, keepdim=True)
        return masked_mean(torch.abs(sel_ref - occ_gt)[..., 0], sel_valid)

    @staticmethod
    def _init_sdf_reg(points, sdf, step: float):
        """InitSDFRegLoss (network/loss.py:115-149), masked fixed-shape."""
        norm = torch.linalg.norm(points, dim=-1)
        small_mask = norm < 0.1
        bounds_s = norm - 0.1
        small_v = torch.clamp(sdf - bounds_s, min=0.0) * small_mask
        small_mean = masked_mean(small_v, small_mask)
        small_loss = small_mean / ((small_mean > 1e-5).float() + 1e-3)

        large_mask = norm > 1.05
        bounds_l = norm - 1.05
        large_v = torch.clamp(bounds_l - sdf, min=0.0) * large_mask
        cnt = torch.sum((large_v > 1e-5).float())
        large_loss = torch.sum(large_v) / (cnt + 1e-3)

        anneal = (np.cos((step / 1000.0) * np.pi) + 1.0) / 2.0
        return small_loss * anneal, large_loss * anneal

    def compute_rgb_loss(self, rgb_pr, rgb_gt):
        """renderer.py:514-526."""
        mode = self.cfg["rgb_loss"]
        if mode == "l2":
            return torch.sum((rgb_pr - rgb_gt) ** 2, -1)
        if mode == "l1":
            return torch.sum(torch.abs(rgb_pr - rgb_gt), -1)
        if mode == "charbonier":
            return torch.sqrt(torch.sum((rgb_gt - rgb_pr) ** 2, dim=-1) + 0.001)
        raise NotImplementedError(mode)

    def _zero(self):
        return torch.zeros((), device=self.device)

    # ----- the core ----------------------------------------------------
    def _sample_points(self, rays_o, rays_d, z_vals):
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        dists = torch.cat([dists, dists[:, -1:]], dim=-1)
        mid_z = z_vals + dists * 0.5
        points = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
        dirs = normalize(rays_d)[:, None, :].expand(points.shape)
        return dists, points, dirs

    def _color_spec(self, pts_cand, dirs_cand, cand_inner):
        safe_cand = torch.where(cand_inner[:, None], pts_cand, torch.zeros_like(pts_cand))
        return linear_to_srgb(self.color_net.outer_light_for_dir(safe_cand, dirs_cand))

    def render_core(self, rays_o, rays_d, z_vals, human_poses, cos_anneal_ratio,
                    step, generator, is_train: bool, is_nerf: bool,
                    with_inter: bool = False):
        """renderer.py:738-859, both branches at every sample, merged."""
        rn, sn = z_vals.shape
        dists, points, dirs = self._sample_points(rays_o, rays_d, z_vals)
        inner_mask = torch.linalg.norm(points, dim=-1) <= 1.0
        flat_pts = points.reshape(-1, 3)
        flat_dirs = dirs.reshape(-1, 3)
        flat_dists = dists.reshape(-1)
        flat_inner = inner_mask.reshape(-1)

        alpha_nerf, color_nerf = self.compute_density_alpha(
            flat_pts, flat_dists, -flat_dirs)
        alpha_sdf, grads, feats, inv_s, sdf = self.compute_sdf_alpha(
            flat_pts, flat_dists, flat_dirs, cos_anneal_ratio, step)
        hp = None
        if human_poses is not None:
            hp = human_poses[:, None].expand(rn, sn, 3, 4).reshape(-1, 3, 4)
        color_sdf, occ_info = self.color_net(flat_pts, grads, -flat_dirs, feats, hp)

        zero = torch.zeros_like(alpha_nerf)
        alpha = torch.where(flat_inner, alpha_sdf, alpha_nerf).reshape(rn, sn)
        sampled_color = torch.where(flat_inner[:, None], color_sdf,
                                    color_nerf).reshape(rn, sn, 3)
        alpha_bkgr = torch.where(flat_inner, zero, alpha_nerf).reshape(rn, sn)
        color_bkgr_s = torch.where(flat_inner[:, None], torch.zeros_like(color_nerf),
                                   color_nerf).reshape(rn, sn, 3)

        weights = alpha_to_weights(alpha)
        color = torch.sum(sampled_color * weights[..., None], dim=1)
        weights_bkgr = alpha_to_weights(alpha_bkgr)
        color_bkgr = torch.sum(color_bkgr_s * weights_bkgr[..., None], dim=1)

        grad_norm = torch.linalg.norm(grads, dim=-1)
        gradient_error = masked_mean((grad_norm - 1.0) ** 2, flat_inner)
        normal_dir = torch.clamp(torch.sum(grads * flat_dirs, dim=-1), min=0.0) * flat_inner
        normal_ori_loss = torch.sum(normal_dir.reshape(rn, sn) * weights, dim=1)

        cand_idx = min(self.cfg["n_samples"], sn - 1)
        pts_cand = points[:, cand_idx, :]
        cand_inner = torch.linalg.norm(pts_cand, dim=-1) <= 1.0
        color_spec = self._color_spec(pts_cand, dirs[:, 0, :], cand_inner)

        acc = torch.sum(weights, dim=-1)
        acc_sdf = torch.sum(weights * inner_mask, dim=-1)
        if is_nerf:
            color = color + (1.0 - acc[..., None])

        outputs: Dict[str, Any] = {
            "ray_rgb": torch.clamp(color, 0.0, 1.0),
            "gradient_error": gradient_error,
            "loss_normal": torch.mean(normal_ori_loss),
            "acc": acc,
            "acc_sdf": acc_sdf,
            "color_bkgr": color_bkgr,
            "color_spec": color_spec,
            "spec_mask": cand_inner,
            "std": torch.mean(1.0 / inv_s),
        }

        if step < 1000:
            reg_mask = torch.linalg.norm(flat_pts, dim=-1) < 1.2
            small, large = self._init_sdf_reg(
                torch.where(reg_mask[:, None], flat_pts, 2.0 * torch.ones_like(flat_pts)),
                torch.where(reg_mask, sdf, torch.full_like(sdf, 10.0)), float(step))
        else:
            small, large = self._zero(), self._zero()
        outputs["loss_sdf_small"] = small
        outputs["loss_sdf_large"] = large

        if self.cfg["apply_occ_loss"]:
            outputs["loss_occ"] = (
                self._occ_loss(flat_pts, sdf, grads, flat_dirs, occ_info["occ_prob"],
                               occ_info["reflective"], flat_inner, generator)
                if step >= self.cfg["occ_loss_step"] else self._zero())

        outputs["transmission"] = masked_mean(
            occ_info["transmission_weight"][..., 0], flat_inner)
        outputs["metallic"] = masked_mean(occ_info["metallic"][..., 0], flat_inner)

        if not is_train:
            outputs.update(self.compute_validation_info(
                z_vals, rays_o, rays_d, weights, human_poses, step,
                with_inter=with_inter))
        return outputs

    def render_core_partitioned(self, rays_o, rays_d, z_vals, sphere_hit,
                                human_poses, cos_anneal_ratio, step, generator,
                                is_train: bool, is_nerf: bool,
                                with_inter: bool = False):
        """``render_core`` over the static sample partition of
        ``sample_ray_partitioned``: SDF + shading on the inner slice only,
        the NeRF++ background on the outer slices only."""
        cfg = self.cfg
        F_ = cfg["n_front_samples"]
        I = cfg["n_samples"] + cfg["n_importance"]
        rn, sn = z_vals.shape
        B = sn - F_ - I

        dists, points, dirs = self._sample_points(rays_o, rays_d, z_vals)
        pts_in = points[:, F_:F_ + I].reshape(-1, 3)
        dirs_in = dirs[:, F_:F_ + I].reshape(-1, 3)
        dists_in = dists[:, F_:F_ + I].reshape(-1)
        pts_out = torch.cat([points[:, :F_], points[:, F_ + I:]], 1)
        dirs_out = torch.cat([dirs[:, :F_], dirs[:, F_ + I:]], 1)
        dists_out = torch.cat([dists[:, :F_], dists[:, F_ + I:]], 1)

        alpha_nerf, color_nerf = self.compute_density_alpha(
            pts_out.reshape(-1, 3), dists_out.reshape(-1), -dirs_out.reshape(-1, 3))
        alpha_nerf = alpha_nerf.reshape(rn, F_ + B)
        color_nerf = color_nerf.reshape(rn, F_ + B, 3)

        alpha_sdf, grads, feats, inv_s, sdf = self.compute_sdf_alpha(
            pts_in, dists_in, dirs_in, cos_anneal_ratio, step)
        hp = None
        if human_poses is not None:
            hp = human_poses[:, None].expand(rn, I, 3, 4).reshape(-1, 3, 4)
        color_sdf, occ_info = self.color_net(pts_in, grads, -dirs_in, feats, hp)
        # rays missing the sphere carry a degenerate chord: no absorption
        alpha_sdf = alpha_sdf.reshape(rn, I) * sphere_hit[:, None]
        color_sdf = color_sdf.reshape(rn, I, 3)

        zeros_a = torch.zeros((rn, I), dtype=alpha_sdf.dtype, device=self.device)
        alpha = torch.cat([alpha_nerf[:, :F_], alpha_sdf, alpha_nerf[:, F_:]], dim=1)
        sampled_color = torch.cat(
            [color_nerf[:, :F_], color_sdf, color_nerf[:, F_:]], dim=1)
        alpha_bkgr = torch.cat([alpha_nerf[:, :F_], zeros_a, alpha_nerf[:, F_:]], dim=1)
        color_bkgr_s = torch.cat(
            [color_nerf[:, :F_], torch.zeros((rn, I, 3), dtype=alpha.dtype,
                                             device=self.device),
             color_nerf[:, F_:]], dim=1)

        weights = alpha_to_weights(alpha)
        color = torch.sum(sampled_color * weights[..., None], dim=1)
        weights_bkgr = alpha_to_weights(alpha_bkgr)
        color_bkgr = torch.sum(color_bkgr_s * weights_bkgr[..., None], dim=1)

        flat_inner = ((torch.linalg.norm(pts_in, dim=-1) <= 1.0)
                      & torch.repeat_interleave(sphere_hit, I))
        grad_norm = torch.linalg.norm(grads, dim=-1)
        gradient_error = masked_mean((grad_norm - 1.0) ** 2, flat_inner)
        normal_dir = torch.clamp(torch.sum(grads * dirs_in, dim=-1), min=0.0) * flat_inner
        normal_ori_loss = torch.sum(
            normal_dir.reshape(rn, I) * weights[:, F_:F_ + I], dim=1)

        cand_idx = F_ + min(cfg["n_samples"], I - 1)
        pts_cand = points[:, cand_idx, :]
        cand_inner = (torch.linalg.norm(pts_cand, dim=-1) <= 1.0) & sphere_hit
        color_spec = self._color_spec(pts_cand, dirs[:, 0, :], cand_inner)

        acc = torch.sum(weights, dim=-1)
        acc_sdf = torch.sum(weights[:, F_:F_ + I], dim=-1)
        if is_nerf:
            color = color + (1.0 - acc[..., None])

        outputs: Dict[str, Any] = {
            "ray_rgb": torch.clamp(color, 0.0, 1.0),
            "gradient_error": gradient_error,
            "loss_normal": torch.mean(normal_ori_loss),
            "acc": acc,
            "acc_sdf": acc_sdf,
            "color_bkgr": color_bkgr,
            "color_spec": color_spec,
            "spec_mask": cand_inner,
            "std": torch.mean(1.0 / inv_s),
        }

        # init SDF regulariser (first 1000 steps): the "large" half needs SDF
        # values at the outer points near the sphere, evaluated only here
        if step < 1000:
            out_flat = pts_out.reshape(-1, 3)
            reg_mask = torch.linalg.norm(out_flat, dim=-1) < 1.2
            safe_out = torch.where(reg_mask[:, None], out_flat,
                                   2.0 * torch.ones_like(out_flat))
            sdf_out = self.sdf(safe_out)[..., 0]
            all_pts = torch.cat([pts_in, safe_out], 0)
            all_sdf = torch.cat(
                [sdf, torch.where(reg_mask, sdf_out, torch.full_like(sdf_out, 10.0))], 0)
            small, large = self._init_sdf_reg(all_pts, all_sdf, float(step))
        else:
            small, large = self._zero(), self._zero()
        outputs["loss_sdf_small"] = small
        outputs["loss_sdf_large"] = large

        if cfg["apply_occ_loss"]:
            outputs["loss_occ"] = (
                self._occ_loss(pts_in, sdf, grads, dirs_in, occ_info["occ_prob"],
                               occ_info["reflective"], flat_inner, generator)
                if step >= cfg["occ_loss_step"] else self._zero())

        outputs["transmission"] = masked_mean(
            occ_info["transmission_weight"][..., 0], flat_inner)
        outputs["metallic"] = masked_mean(occ_info["metallic"][..., 0], flat_inner)

        if not is_train:
            outputs.update(self.compute_validation_info(
                z_vals, rays_o, rays_d, weights, human_poses, step,
                with_inter=with_inter))
        return outputs

    def compute_validation_info(self, z_vals, rays_o, rays_d, weights,
                                human_poses, step, with_inter=True):
        """renderer.py:649-668: surface-point channels for validation."""
        depth = torch.sum(weights * z_vals, dim=-1, keepdim=True)
        points = depth * rays_d + rays_o
        sdf, feats, grads = self.sdf_all(points)
        inner = (torch.linalg.norm(points, dim=-1, keepdim=True) <= 1.0)
        outputs = {
            "depth": depth,
            "normal": ((normalize(grads) + 1.0) * 0.5) * inner,
        }
        if not with_inter:
            return outputs
        _, occ_info, inter = self.color_net(
            points, grads, -normalize(rays_d), feats, human_poses,
            inter_results=True)
        _, occ_prob_hit, _ = get_intersection(
            self.sdf, self.inv_s, points, occ_info["reflective"], sn0=128, sn1=9)
        outputs["occ_prob_gt"] = torch.sum(occ_prob_hit, dim=-1, keepdim=True)
        for k, v in inter.items():
            outputs[k] = v * inner
        return outputs

    # ----- public entry points -----------------------------------------
    def render(self, rays_o, rays_d, near, far, human_poses, step,
               generator=None, cos_anneal_ratio=0.0, perturb_overwrite=-1.0,
               is_train=True, is_nerf=False, with_inter=False):
        """renderer.py:627-647."""
        generator = self.generator if generator is None else generator
        perturb = self.cfg["perturb"]
        if perturb_overwrite >= 0:
            perturb = perturb_overwrite
        if self.cfg["partition_samples"]:
            z_vals, sphere_hit = self.sample_ray_partitioned(
                rays_o, rays_d, near, far, perturb, generator)
            return self.render_core_partitioned(
                rays_o, rays_d, z_vals, sphere_hit, human_poses,
                cos_anneal_ratio, step, generator, is_train=is_train,
                is_nerf=is_nerf, with_inter=with_inter)
        z_vals = self.sample_ray(rays_o, rays_d, near, far, perturb, generator)
        return self.render_core(rays_o, rays_d, z_vals, human_poses,
                                cos_anneal_ratio, step, generator,
                                is_train=is_train, is_nerf=is_nerf,
                                with_inter=with_inter)

    def get_anneal_val(self, step):
        if self.cfg["anneal_end"] < 0:
            return 1.0
        return min(1.0, step / self.cfg["anneal_end"])

    def train_outputs(self, batch, step: int, generator=None):
        """One training forward: render + data losses.

        batch: rays_o, rays_d, near, far, rgbs, [masks], [human_poses] on
        the renderer's device."""
        is_nerf = self.cfg["is_nerf"]
        outputs = self.render(
            batch["rays_o"], batch["rays_d"], batch["near"], batch["far"],
            batch.get("human_poses"), step, generator,
            cos_anneal_ratio=self.get_anneal_val(step), is_train=True,
            is_nerf=is_nerf)
        outputs["loss_rgb"] = self.compute_rgb_loss(outputs["ray_rgb"], batch["rgbs"])
        if "masks" in batch and (is_nerf or self.cfg.get("use_mask_loss", False)):
            target = outputs["acc"] if is_nerf else outputs["acc_sdf"]
            outputs["loss_mask"] = torch.mean(torch.abs(batch["masks"] - target))
        return outputs

    def test_outputs(self, batch, step: int, generator=None):
        """Full-channel eval forward (renderer.py:414-461 per-chunk body)."""
        outputs = self.render(
            batch["rays_o"], batch["rays_d"], batch["near"], batch["far"],
            batch.get("human_poses"), step, generator, cos_anneal_ratio=1.0,
            perturb_overwrite=0.0, is_train=False, is_nerf=self.cfg["is_nerf"],
            with_inter=True)
        outputs["loss_rgb"] = self.compute_rgb_loss(outputs["ray_rgb"], batch["rgbs"])
        return outputs
