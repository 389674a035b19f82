"""NeRO-style split-sum shading network with NU-NeRF transmission terms;
counterpart of ``nunerf_tpu/fields/shading.py`` (reference
``network/field.py:557-783``, the diffuse-only inner variant
``field.py:1127-1283``, the stage-2 interface shader ``field.py:786-1016``).

  color = (diffuse + specular) * (1 - T)
        + (R_schlick * spec_light0 + (1 - R_schlick) * refrac_light) * T

``forward`` is the stage-1 shader and the stage-2 inner shader
(``diffuse_only`` selects the lambertian inner variant); ``s2_shade`` shades
a glass interface during stage-2 tracing with these same heads, frozen.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from nunerf_tpu_torch.fields.mlp import Predictor
from nunerf_tpu_torch.ops.embedder import posenc, posenc_dim
from nunerf_tpu_torch.ops.fg_lut import fg_lookup, get_fg_lut
from nunerf_tpu_torch.ops.geometry import (
    get_sphere_intersection,
    normalize,
    offset_points_to_sphere,
    schlick_weight,
)
from nunerf_tpu_torch.ops.ide import ide_dim, ipe, make_ide_fn
from nunerf_tpu_torch.ops.srgb import linear_to_srgb

LOG_HALF = float(np.log(0.5))


def camera_plane_intersection(pts, dirs, poses):
    """Intersection of rays with the camera XoY plane in "human" coordinates
    (field.py:411-430).  poses: [...,3,4] world->human transform."""
    R, t = poses[..., :, :3], poses[..., :, 3:]
    pts_h = (R @ pts[..., :, None] + t)[..., 0]
    dirs_h = (R @ dirs[..., :, None])[..., 0]
    hits = torch.abs(dirs_h[..., 2]) > 1e-4
    dirs_z = torch.where(hits, dirs_h[..., 2], torch.full_like(dirs_h[..., 2], 1e-4))
    dist = -pts_h[..., 2] / dirs_z
    inter = pts_h + dist[..., None] * dirs_h
    return inter, dist, hits


class AppShadingNetwork(nn.Module):
    def __init__(self, human_light: bool = False, sphere_direction: bool = False,
                 light_pos_freq: int = 6, inner_init: float = -0.95,
                 roughness_init: float = 0.0, metallic_init: float = 0.0,
                 light_exp_max: float = 3.0, refrac_freq: int = 6,
                 refrac_exp_max: Optional[float] = None,
                 feature_dim: int = 256, diffuse_only: bool = False,
                 dtype=None, fused: bool = False, device=None):
        super().__init__()
        self.diffuse_only = diffuse_only
        self.human_light = human_light
        self.sphere_direction = sphere_direction
        self.light_pos_freq = light_pos_freq
        self.refrac_freq = refrac_freq
        # ``fused``: every head but the human-light one goes through the
        # fused chain kernel, as in the JAX module
        kw = dict(dtype=dtype, fused=fused, device=device)
        fx = feature_dim + 3
        self.metallic = Predictor(
            fx, 1, final_bias=metallic_init if metallic_init != 0 else None, **kw)
        self.roughness = Predictor(
            fx, 1, final_bias=roughness_init if roughness_init != 0 else None, **kw)
        self.albedo = Predictor(fx, 3, **kw)
        self.sph_enc = make_ide_fn(5)
        ide = ide_dim(5)
        pos = posenc_dim(light_pos_freq)
        self.outer_light = Predictor(2 * ide if sphere_direction else ide, 3,
                                     activation="exp", exp_max=light_exp_max,
                                     final_bias=LOG_HALF, **kw)
        self.inner_light = Predictor(pos + ide, 3, activation="exp",
                                     exp_max=light_exp_max,
                                     final_bias=LOG_HALF, **kw)
        self.inner_weight = Predictor(pos + posenc_dim(6), 1, activation="none",
                                      final_bias=inner_init, **kw)
        self.transmission_weight = Predictor(fx, 1, **kw)
        # ``refrac_exp_max``: the SpecInner shader caps the refraction light
        # lower, at -0.2 (field.py:1374); None keeps ``light_exp_max``
        r_exp = light_exp_max if refrac_exp_max is None else refrac_exp_max
        self.refrac_light = Predictor(2 * posenc_dim(refrac_freq), 3,
                                      activation="exp", exp_max=r_exp,
                                      final_bias=LOG_HALF, **kw)
        if human_light:
            self.human_light_predictor = Predictor(
                24, 4, activation="exp", exp_max=0.0,
                final_bias=float(np.log(0.01)), device=device)
        self.register_buffer(
            "fg_lut", torch.as_tensor(get_fg_lut(256), device=device),
            persistent=False)

    def reset_parameters(self, generator):
        for m in self.children():
            m.reset_parameters(generator)

    # ----- sub-predictions -------------------------------------------------

    def predict_human_light(self, points, reflective, human_poses, roughness):
        """field.py:618-634."""
        inter, dists, hits = camera_plane_intersection(points, reflective, human_poses)
        scale = 0.3
        mean = inter[..., :2] * scale
        var = roughness * (dists[:, None] * scale) ** 2
        hits = hits & (torch.linalg.norm(mean, dim=-1) < 1.5) & (dists > 0)
        hits = hits.to(mean.dtype)[..., None]
        mean = mean * hits
        var = (var * hits).expand(mean.shape)
        enc = ipe(mean, var, 0, 6)
        hl = self.human_light_predictor(enc) * hits
        return hl[..., :3], torch.clamp(hl[..., 3:], 0.0, 1.0)

    def _sphere_dir_enc(self, points, direction, roughness):
        sph_points = offset_points_to_sphere(points)
        sph_points = normalize(
            sph_points + direction * get_sphere_intersection(sph_points, direction))
        return self.sph_enc(sph_points, roughness)

    def predict_specular_lights(self, points, reflective, roughness, human_poses):
        """field.py:636-667, with the zero-roughness light of the
        transmission term; the rows of each head stacked ([2N])."""
        n = points.shape[0]
        zero_r = torch.zeros_like(roughness)
        enc = self.sph_enc(torch.cat([reflective, reflective], 0),
                           torch.cat([roughness, zero_r], 0))
        pts = posenc(points, self.light_pos_freq)
        if self.sphere_direction:
            sph = self._sphere_dir_enc(points, reflective, roughness)
            direct = self.outer_light(torch.cat([enc, torch.cat([sph, sph], 0)], -1))
        else:
            direct = self.outer_light(enc)
        direct_light, direct_light_0 = direct[:n], direct[n:]

        human_light, human_weight = 0.0, 0.0
        if self.human_light:
            human_light, human_weight = self.predict_human_light(
                points, reflective, human_poses, roughness)

        inner = self.inner_light(torch.cat([torch.cat([pts, pts], 0), enc], -1))
        indirect_light, indirect_light_0 = inner[:n], inner[n:]
        ref_enc = posenc(reflective, 6)
        occ_prob = self.inner_weight(torch.cat([pts, ref_enc], -1).detach())
        occ_prob = occ_prob * 0.5 + 0.5
        occ_prob_ = torch.clamp(occ_prob, 0.0, 1.0)

        light = (indirect_light * occ_prob_
                 + (human_light * human_weight + direct_light * (1 - human_weight))
                 * (1 - occ_prob_))
        light_0 = (indirect_light_0 * occ_prob_
                   + (human_light * human_weight + direct_light_0 * (1 - human_weight))
                   * (1 - occ_prob_))
        return (light, light_0, occ_prob, indirect_light * occ_prob_,
                human_light * human_weight)

    def _lights_batched(self, points, normals, reflective, roughness, human_poses):
        """All light-head evaluations of the stage-1 forward with the rows of
        each head stacked (outer_light x3, inner_light x2)."""
        zero_r = torch.zeros_like(roughness)
        one_r = torch.ones_like(roughness)
        n = points.shape[0]
        enc = self.sph_enc(torch.cat([normals, reflective, reflective], 0),
                           torch.cat([one_r, roughness, zero_r], 0))
        if self.sphere_direction:
            sph_d = self._sphere_dir_enc(points, normals, one_r)
            sph_s = self._sphere_dir_enc(points, reflective, roughness)
            outer = self.outer_light(torch.cat(
                [enc, torch.cat([sph_d, sph_s, sph_s], 0)], -1))
        else:
            outer = self.outer_light(enc)
        diffuse_light = outer[:n]
        direct_light = outer[n:2 * n]
        direct_light_0 = outer[2 * n:]

        human_light, human_weight = 0.0, 0.0
        if self.human_light:
            human_light, human_weight = self.predict_human_light(
                points, reflective, human_poses, roughness)

        pts = posenc(points, self.light_pos_freq)
        inner = self.inner_light(torch.cat(
            [torch.cat([pts, pts], 0), torch.cat([enc[n:2 * n], enc[2 * n:]], 0)], -1))
        indirect_light, indirect_light_0 = inner[:n], inner[n:]

        ref_enc = posenc(reflective, 6)
        occ_prob = self.inner_weight(torch.cat([pts, ref_enc], -1).detach())
        occ_prob = occ_prob * 0.5 + 0.5
        occ_prob_ = torch.clamp(occ_prob, 0.0, 1.0)

        light = (indirect_light * occ_prob_
                 + (human_light * human_weight + direct_light * (1 - human_weight))
                 * (1 - occ_prob_))
        light_0 = (indirect_light_0 * occ_prob_
                   + (human_light * human_weight + direct_light_0 * (1 - human_weight))
                   * (1 - occ_prob_))
        return diffuse_light, (light, light_0, occ_prob,
                               indirect_light * occ_prob_,
                               human_light * human_weight)

    def predict_diffuse_lights(self, points, normals):
        """field.py:669-682: the outer light at roughness 1 (vMF prior)."""
        roughness = torch.ones((*normals.shape[:-1], 1), dtype=normals.dtype,
                               device=normals.device)
        ref = self.sph_enc(normals, roughness)
        if self.sphere_direction:
            sph = self._sphere_dir_enc(points, normals, roughness)
            return self.outer_light(torch.cat([ref, sph], -1))
        return self.outer_light(ref)

    def predict_materials(self, points, feature_vectors):
        fx = torch.cat([feature_vectors, points], -1)
        return self.metallic(fx), self.roughness(fx), self.albedo(fx)

    def outer_light_for_dir(self, points, dirs):
        """Direct outer light along ``dirs`` at zero roughness (the stage-1
        background/env consistency term, renderer.py:799-821)."""
        zero_r = torch.zeros((*dirs.shape[:-1], 1), dtype=dirs.dtype, device=dirs.device)
        dir_enc = self.sph_enc(dirs, zero_r)
        if self.sphere_direction:
            sph = self._sphere_dir_enc(points, dirs, zero_r)
            return self.outer_light(torch.cat([dir_enc, sph], -1))
        return self.outer_light(dir_enc)

    # ----- stage-1 / inner-shader forward ---------------------------------

    def forward(self, points, normals, view_dirs, feature_vectors,
                human_poses=None, inter_results: bool = False):
        normals = normalize(normals)
        view_dirs = normalize(view_dirs)
        reflective = torch.sum(view_dirs * normals, -1, keepdim=True) * normals * 2 - view_dirs
        no_v = torch.sum(normals * view_dirs, -1, keepdim=True)

        metallic, roughness, albedo = self.predict_materials(points, feature_vectors)
        transmission_weight = self.transmission_weight(
            torch.cat([feature_vectors, points], -1))

        if self.diffuse_only:
            # AppShadingNetwork_DiffuseInner (field.py:1245-1257): metallic
            # and transmission multiplied by 0, the colour pure diffuse.  The
            # parameter set is that of the full shader, so a checkpointed
            # run can resume with the flag flipped; the unused heads
            # (specular lights, refrac_light) are not evaluated and their
            # gradients are zero.  linear_to_srgb is applied once (the
            # reference applies it twice, field.py:1268-1270).
            diffuse_light, (_sl, _sl0, occ_prob, _il, _hl) = self._lights_batched(
                points, normals, reflective, roughness, human_poses)
            color = linear_to_srgb(albedo * diffuse_light)
            return color, {"reflective": reflective, "occ_prob": occ_prob,
                           "transmission_weight": transmission_weight * 0.0,
                           "metallic": metallic * 0.0}

        diffuse_albedo = (1 - metallic) * albedo
        diffuse_light, (specular_light, specular_light_0, occ_prob,
                        indirect_light, human_light) = self._lights_batched(
            points, normals, reflective, roughness, human_poses)
        diffuse_color = diffuse_albedo * diffuse_light
        specular_albedo = 0.04 * (1 - metallic) + metallic * albedo

        reflection_weight = schlick_weight(no_v)
        refraction_light = self.refrac_light(torch.cat(
            [posenc(points, self.refrac_freq), posenc(view_dirs, self.refrac_freq)], -1))

        fg = fg_lookup(self.fg_lut, torch.clamp(no_v, 0.0, 1.0),
                       torch.clamp(roughness, 0.0, 1.0))
        specular_ref = specular_albedo * fg[..., 0:1] + fg[..., 1:2]
        specular_color = specular_ref * specular_light

        color = ((diffuse_color + specular_color) * (1 - transmission_weight)
                 + (reflection_weight * specular_light_0
                    + (1 - reflection_weight) * refraction_light) * transmission_weight)

        diffuse_color_srgb = linear_to_srgb(diffuse_color)
        specular_color_srgb = linear_to_srgb(specular_color)
        color = linear_to_srgb(color)

        occ_info = {
            "reflective": reflective,
            "occ_prob": occ_prob,
            "transmission_weight": transmission_weight,
            "metallic": metallic,
        }
        if not inter_results:
            return color, occ_info

        inter = {
            "specular_albedo": specular_albedo,
            "specular_ref": torch.clamp(specular_ref, 0.0, 1.0),
            "specular_light": torch.clamp(linear_to_srgb(specular_light_0), 0.0, 1.0),
            "specular_color": torch.clamp(
                specular_color_srgb * (1 - transmission_weight)
                + reflection_weight * specular_light_0 * transmission_weight, 0.0, 1.0),
            "diffuse_albedo": diffuse_albedo,
            "diffuse_light": torch.clamp(linear_to_srgb(diffuse_light), 0.0, 1.0),
            "diffuse_color": torch.clamp(diffuse_color_srgb, 0.0, 1.0),
            "metallic": metallic,
            "transmission_weight": transmission_weight,
            "roughness": roughness,
            "occ_prob": torch.clamp(occ_prob, 0.0, 1.0),
            "indirect_light": indirect_light,
            "refraction_light": torch.clamp(
                linear_to_srgb((1 - reflection_weight) * refraction_light
                               * transmission_weight), 0.0, 1.0),
            "reflection_weight": reflection_weight,
        }
        if self.human_light:
            inter["human_light"] = linear_to_srgb(human_light)
        return color, occ_info, inter

    # ----- stage-2 interface shader (frozen stage-1 heads) -----------------

    def s2_shade(self, points, normals, view_dirs, feature_vectors,
                 is_internal: bool):
        """AppShadingNetwork_S2.forward (field.py:909-1010): shading at a
        glass interface during stage-2 tracing, with this network's heads.

        color = (diffuse+spec)(1-T) + R_schlick*spec_light0*T, zeroed when
        the interface is internal; also emits
        ``refraction_coefficient = (1-R_schlick)*T`` for transmittance
        chaining.  The encoding path follows this network's
        ``sphere_direction`` flag: parameter shapes exist only for it."""
        normals = normalize(normals)
        view_dirs = normalize(view_dirs)
        reflective = torch.sum(view_dirs * normals, -1, keepdim=True) * normals * 2 - view_dirs
        no_v = torch.sum(normals * view_dirs, -1, keepdim=True)

        metallic, roughness, albedo = self.predict_materials(points, feature_vectors)
        transmission_weight = self.transmission_weight(
            torch.cat([feature_vectors, points], -1))

        diffuse_albedo = (1 - metallic) * albedo
        roughness_one = torch.ones_like(roughness)
        ref_d = self.sph_enc(normals, roughness_one)
        if self.sphere_direction:
            sph = self._sphere_dir_enc(points, normals, roughness_one)
            diffuse_light = self.outer_light(torch.cat([ref_d, sph], -1))
        else:
            diffuse_light = self.outer_light(ref_d)
        diffuse_color = diffuse_albedo * diffuse_light
        specular_albedo = 0.04 * (1 - metallic) + metallic * albedo

        (specular_light, specular_light_0, occ_prob, _indirect,
         _human) = self.predict_specular_lights(points, reflective, roughness, None)

        reflection_weight = schlick_weight(no_v)
        fg = fg_lookup(self.fg_lut, torch.clamp(no_v, 0.0, 1.0),
                       torch.clamp(roughness, 0.0, 1.0))
        specular_ref = specular_albedo * fg[..., 0:1] + fg[..., 1:2]
        specular_color = specular_ref * specular_light

        color = ((diffuse_color + specular_color) * (1 - transmission_weight)
                 + reflection_weight * specular_light_0 * transmission_weight)
        if is_internal:
            color = color * 0
        color = linear_to_srgb(color)

        occ_info = {
            "reflective": reflective,
            "occ_prob": occ_prob,
            "transmission_weight": transmission_weight,
            "refraction_coefficient": (1 - reflection_weight) * transmission_weight,
        }
        return color, occ_info
