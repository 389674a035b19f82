"""Stage-2 renderer (zero-thickness): inner geometry through traced glass;
counterpart of ``nunerf_tpu/models/stage2.py`` (reference
``network/renderer_zerothick.py:868-2060``).

Camera rays refract through the extracted outer mesh (one Snell interface a
hit), and the inner object is a second NeuS SDF rendered along the refracted
path segments with transmittance chaining:

* ``ray_trace``: 3 bounces unrolled over ``Scene.dintersect`` with
  ``converged``/``tir`` masks carried per lane (fixed shapes, no compaction);
* per-segment sampling: outside segments get ``n_samples_outer`` samples to
  the hit, or background samples along the escaped ray on a miss; the
  inside-glass segment gets NeuS-upsampled samples from the inner SDF;
* ``render`` accumulates linear-space radiance with transmittance chaining
  across segments and shades each interface through the frozen stage-1 heads
  (``AppShadingNetwork.s2_shade``);
* TIR masks propagate through the converged chain and mask the rgb loss.

Differences of form from the JAX package, not of result:

* one ``nn.Module``: the trainable nets are submodules (``PARAM_KEYS`` maps
  the JAX tree's ``train`` keys to them), the stage-1 renderer is the
  submodule ``stage1`` with ``requires_grad_(False)`` (the JAX tree's
  ``frozen`` subtree under ``stop_gradient``).  Gradients still flow through
  the frozen shader and SDF to their inputs: positions, normals, and so the
  IoR field;
* ``step`` is a Python int; the freeze gates that read the live ``inv_s``
  stay tensors (``torch.where`` on a detached copy), so no step waits for
  the device;
* nothing in stage 2 draws random numbers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from nunerf_tpu_torch.config import STAGE2_DEFAULTS, load_cfg, merge_cfg
from nunerf_tpu_torch.device import resolve_device
from nunerf_tpu_torch.fields.aux import IoRNetwork, ThicknessNetwork
from nunerf_tpu_torch.fields.sdf import SDFNetwork, sdf_value_feature_grad
from nunerf_tpu_torch.fields.shading import AppShadingNetwork
from nunerf_tpu_torch.fields.variance import SingleVarianceNetwork
from nunerf_tpu_torch.models.stage1 import PARAM_KEYS as STAGE1_PARAM_KEYS
from nunerf_tpu_torch.models.stage1 import ShapeRenderer, masked_mean
from nunerf_tpu_torch.ops.geometry import normalize, safe_norm, safe_sqrt
from nunerf_tpu_torch.ops.sampling import merge_z_vals, neus_upsample, sample_pdf
from nunerf_tpu_torch.ops.srgb import linear_to_srgb, srgb_to_linear
from nunerf_tpu_torch.ops.volume import alpha_to_weights
from nunerf_tpu_torch.tracing.scene import Scene

ZERO_THICK_DEFAULTS = dict(
    STAGE2_DEFAULTS,
    n_samples_outer=256,      # outside segments (renderer_zerothick.py:1729)
    n_bg_importance=64,       # importance samples on miss (:1799)
    bg_z_max=64.0,            # coarse background range [0.1, 64] (:1767)
    bg_tail_samples=32,       # stage-1's n_bg_samples (renderer.py:126)
    bg_near0=0.8,             # stage-1's nerf-convention near (renderer.py:389)
    n_samples_inner=64,       # inside-glass base samples (:1734)
    inner_up_rounds=2,        # NeuS upsample rounds (:1752)
    inner_up_each=32,
    seg_far=4.5,              # miss-segment length (:1727)
    max_bounces=3,
)

# JAX ``train`` subtree key -> submodule or parameter name
PARAM_KEYS = {"sdf_inner": "sdf_inner", "var_inner": "var_inner",
              "shade_inner": "color_inner", "ior": "ior_net",
              "ior_int": "ior_int_net", "thickness": "thickness_net",
              "iors_vec": "iors_vec", "absorption": "absorption"}


def tree_keys():
    """Path prefixes of the JAX stage-2 tree -> the module's name prefixes,
    for ``convert.load_jax_params`` / ``convert.to_jax_tree``."""
    keys = {("train", k): v for k, v in PARAM_KEYS.items()}
    keys.update({("frozen", k): f"stage1.{v}" for k, v in STAGE1_PARAM_KEYS.items()})
    return keys


class Stage2Renderer(nn.Module):
    """Zero-thickness stage 2.  Trainable: inner SDF + deviation + inner
    shader + IoR field (+ the vestigial IoR-interior and thickness fields and
    the 10-vector IORs parameter, kept for checkpoint parity).

    ``stage1`` gives the frozen stage-1 weights: a ``ShapeRenderer`` (its
    state is copied), a JAX stage-1 parameter tree, or ``None`` to read the
    checkpoint ``cfg['stage1_ckpt_dir']``.  ``scene`` defaults to the mesh
    file ``cfg['stage1_mesh_dir']``.  Runs on ``device`` ("cuda" unless the
    caller asks for the CPU); trainable weights are drawn from ``seed``."""

    def __init__(self, cfg: Dict[str, Any], scene: Optional[Scene] = None,
                 stage1=None, device="cuda", seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        dev = self.device
        self.cfg = merge_cfg(ZERO_THICK_DEFAULTS, cfg)
        if self.cfg.get("fused_sdf"):
            raise NotImplementedError("fused_sdf (K4/K5) is not ported yet")
        shader_cfg = self.cfg.get("shader_config") or {}

        # frozen stage-1 stack.  It inherits stage 2's precision choice: bf16
        # compute on the frozen background NeRF is stage 2's main throughput
        # lever.
        s1_cfg = dict(self.cfg.get("stage1_cfg") or {})
        if self.cfg.get("stage1_cfg_dir"):
            s1_cfg = load_cfg(self.cfg["stage1_cfg_dir"])
        s1_cfg = dict(s1_cfg, mixed_precision=self.cfg.get("mixed_precision", True))
        self.stage1 = ShapeRenderer(s1_cfg, device=dev, seed=seed)
        if stage1 is None and self.cfg.get("stage1_ckpt_dir"):
            from nunerf_tpu_torch.convert import load_jax_checkpoint
            _, stage1, _ = load_jax_checkpoint(self.cfg["stage1_ckpt_dir"])
        if stage1 is None:
            raise ValueError("stage-2 requires stage-1 params "
                             "(stage1_ckpt_dir or stage1)")
        if isinstance(stage1, nn.Module):
            self.stage1.load_state_dict(stage1.state_dict())
        else:
            from nunerf_tpu_torch.convert import load_jax_params
            load_jax_params(self.stage1, stage1, STAGE1_PARAM_KEYS)
        self.stage1.requires_grad_(False)

        if scene is None:
            scene = Scene(self.cfg["stage1_mesh_dir"],
                          curv_smooth_iters=self.cfg.get(
                              "curv_smooth_iters",
                              0 if self.cfg.get("zero_thickness", True) else 20),
                          device=dev)
        if scene.device != dev:
            raise ValueError(f"scene on {scene.device}, renderer on {dev}")
        self.scene = scene

        # trainable modules
        self.sdf_inner = SDFNetwork(
            d_out=self.cfg["sdf_d_out"], n_layers=self.cfg["sdf_n_layers"],
            skip_in=(self.cfg["sdf_n_layers"] // 2,), multires=self.cfg["sdf_freq"],
            bias=self.cfg["sdf_bias"], geometric_init=self.cfg["geometry_init"],
            dtype=torch.bfloat16 if self.cfg.get("sdf_mixed_precision") else None,
            device=dev)
        self.var_inner = SingleVarianceNetwork(
            init_val=self.cfg["inv_s_init"], activation=self.cfg["std_act"],
            device=dev)
        dtype = torch.bfloat16 if self.cfg.get("mixed_precision", True) else None
        # cfg inner_diffuse_only selects the reference's DiffuseInner inner
        # shader (field.py:1127-1283): with an opaque lambertian inner object
        # the full shader's transmission and view-dependent refrac_light let
        # the inner surface fake the background seen through the glass.
        self.color_inner = AppShadingNetwork(
            sphere_direction=bool(shader_cfg.get("sphere_direction", False)),
            human_light=False, dtype=dtype,
            diffuse_only=bool(self.cfg.get("inner_diffuse_only", False)),
            device=dev)
        self.ior_net = IoRNetwork(device=dev)
        self.ior_int_net = IoRNetwork(device=dev)
        self.thickness_net = ThicknessNetwork(device=dev)
        self.iors_vec = nn.Parameter(torch.zeros(10, device=dev))  # vestigial (:929)
        if self.cfg.get("learn_absorption", False):
            # per-channel Beer-Lambert coefficient of the glass medium,
            # kappa = softplus(raw); init near zero absorption (raw -2 ->
            # kappa 0.127)
            self.absorption = nn.Parameter(torch.full((3,), -2.0, device=dev))
        self.init_params(torch.Generator().manual_seed(seed))

    def init_params(self, generator: torch.Generator):
        """Re-draw every trainable parameter from a CPU ``generator``."""
        for key in ("sdf_inner", "var_inner", "color_inner", "ior_net",
                    "ior_int_net", "thickness_net"):
            getattr(self, key).reset_parameters(generator)
        with torch.no_grad():
            self.iors_vec.zero_()
            if hasattr(self, "absorption"):
                self.absorption.fill_(-2.0)

    @staticmethod
    def _is_internal(i: int) -> bool:
        """Zero-thickness: odd interfaces are internal
        (renderer_zerothick.py:1934)."""
        return i % 2 != 0

    # ----- field helpers ------------------------------------------------
    def inner_sdf(self, pts):
        return self.sdf_inner(pts)[..., :1]

    def _inv_s_now(self):
        return self.var_inner(torch.zeros((1, 3), device=self.device))[0, 0]

    # ----- inv_s hardening floor -----------------------------------------
    def _inv_s_floor(self, step):
        """Scheduled lower bound on the inner NeuS inv_s, or None (= off).

        The floor ramps geometrically from ``inv_s_floor_base`` to
        ``inv_s_floor_max`` between ``inv_s_floor_start`` and
        ``inv_s_floor_end`` and is applied as ``max(learned, floor)``: the
        variance net can only sharpen further.  Default off (reference
        parity)."""
        fmax = self.cfg.get("inv_s_floor_max")
        if not fmax or step is None:
            return None
        start = self.cfg.get("inv_s_floor_start", 0)
        end = self.cfg.get("inv_s_floor_end", self.cfg.get("total_step", 30000))
        base = float(self.cfg.get("inv_s_floor_base", 32.0))
        if step < start:
            return 0.0
        t = min(max((step - start) / max(end - start, 1), 0.0), 1.0)
        return base * (float(fmax) / base) ** t

    # ----- freeze gates -------------------------------------------------
    def _freeze_flag(self, step, step_key, thr_key):
        """Bool tensor: hold a physical field (IoR / absorption) at its init.

        ``cfg[step_key]``: freeze while step < value; ``cfg[thr_key]``:
        also freeze until the inner NeuS has hardened (inv_s >= threshold).
        None when no gate is configured (the reference never freezes)."""
        fs = self.cfg.get(step_key, 0) or 0
        thr = self.cfg.get(thr_key)
        if step is None or (not fs and not thr):
            return None
        frozen = torch.tensor(bool(step < fs), device=self.device)
        if thr:
            inv_s_now = self._inv_s_now().detach()
            # the gate asks "has the rendered surface hardened?": under an
            # inv_s floor the rendering hardness is the floored value
            floor = self._inv_s_floor(step)
            if floor is not None:
                inv_s_now = torch.clamp(inv_s_now, min=floor)
            frozen = frozen | (inv_s_now < thr)
        return frozen

    @staticmethod
    def _maybe_freeze(val, frozen):
        if frozen is None:
            return val
        return torch.where(frozen, val.detach(), val)

    # ----- ray tracing --------------------------------------------------
    def ray_trace(self, rays_o, rays_d, step=None):
        """3-bounce Snell trace through the outer mesh
        (renderer_zerothick.py:1571-1703), fixed-shape.  Returns the
        per-bounce dicts and the combined tir mask.

        ``freeze_ior_step`` / ``freeze_ior_inv_s`` (cfg, default off): while
        the inner SDF is still soft nothing constrains the IoR field and it
        drifts towards eta = 1; freezing it at its init (sigmoid midpoint
        0.5 -> eta = 1/1.5) until the geometry hardens removes that failure
        mode."""
        frozen_ior = self._freeze_flag(step, "freeze_ior_step", "freeze_ior_inv_s")
        rn = rays_o.shape[0]
        bounces = []
        start, direc = rays_o, normalize(rays_d)
        active = torch.ones(rn, dtype=torch.bool, device=rays_o.device)
        tir_bad = torch.zeros(rn, dtype=torch.bool, device=rays_o.device)
        ior_frozen = (frozen_ior.to(torch.float32) if frozen_ior is not None
                      else torch.zeros((), device=rays_o.device))

        for i in range(self.cfg["max_bounces"]):
            outside = (i % 2 == 0)
            res = self.scene.dintersect(start, direc)
            hit = res["hit"] & active
            normal = res["normal"] if outside else -res["normal"]
            # robustness to mesh winding: the interface normal must oppose
            # the incoming ray
            opposes = torch.sum(normal * -direc, dim=-1, keepdim=True) >= 0
            normal = torch.where(opposes, normal, -normal)

            cos_i = torch.sum(normal * -direc, dim=-1, keepdim=True)
            sin2_i = 1.0 - cos_i * cos_i
            ior = self._maybe_freeze(self.ior_net(res["pos"]), frozen_ior)
            eta = 1.0 / (ior + 1.0)           # IoR map (:1642-1643)
            if not outside:
                eta = 1.0 / eta               # reciprocal when exiting (:1653)

            tir_here = (eta * eta * sin2_i)[..., 0] > 0.999
            conv = hit & ~tir_here
            tir_bad = tir_bad | (hit & tir_here)

            sin2_t = torch.clamp(eta * eta * sin2_i, 0.0, 1.0)
            next_dir_un = (eta * direc
                           + (eta * cos_i - safe_sqrt(1.0 - sin2_t)) * normal)
            next_start = res["pos"] + next_dir_un * 1e-5
            next_dir = next_dir_un / (safe_norm(next_dir_un, keepdims=True) + 1e-4)

            bounces.append({
                "start": start, "dir": direc, "active": active,
                "hit": hit, "conv": conv, "pos": res["pos"],
                "normal": normal, "eta": eta,
                "next_dir": next_dir, "ior_raw": ior,
                "ior_frozen": ior_frozen,
            })
            start, direc, active = next_start, next_dir, conv

        return bounces, ~tir_bad

    # ----- per-segment sampling ----------------------------------------
    def _bg_tail(self, n_tail: int, far: float, dtype):
        t = torch.linspace(1e-3, 1.0 - 1.0 / (n_tail + 1.0), n_tail,
                           device=self.device, dtype=dtype)
        return far / torch.flip(t, dims=[-1]) + 1.0 / n_tail

    def _stage1_bg_z(self, n_total: int, near: float, dtype=torch.float32):
        """Stage-1's exact background z-law from a segment origin: linear
        [near, far], then the inverse-depth tail stage 1 trained its NeRF++
        on (renderer.py:585-625, far = 4.5 for the nerf convention).  The
        frozen background's radiance mass lives where stage 1's sampling put
        it; any other law mis-integrates the frozen field."""
        far = self.cfg["seg_far"]
        n_tail = min(self.cfg["bg_tail_samples"], n_total // 2)
        z_near = torch.linspace(near, far, n_total - n_tail, device=self.device,
                                dtype=dtype)
        return torch.cat([z_near, self._bg_tail(n_tail, far, dtype)], -1)

    def _stage1_bg_z_lanes(self, n_total: int, near: torch.Tensor):
        """Per-lane variant of ``_stage1_bg_z`` (sphere_clip_outer): the
        linear head starts at each lane's own near; the inverse-depth tail is
        shared (it lives beyond ``far`` where no clip applies)."""
        far = self.cfg["seg_far"]
        n_tail = min(self.cfg["bg_tail_samples"], n_total // 2)
        frac = torch.linspace(0.0, 1.0, n_total - n_tail, device=self.device,
                              dtype=near.dtype)[None, :]
        z_near = near[:, None] + frac * torch.clamp(far - near[:, None], min=1e-3)
        z_tail = self._bg_tail(n_tail, far, near.dtype)[None, :].expand(near.shape[0], n_tail)
        return torch.cat([z_near, z_tail], -1)

    def _sample_outer_segment(self, b, seg_index: int = 0):
        """Outside segment (k != 1): uniform-to-hit on hit lanes; on a miss,
        background samples along the escaped ray.

        Miss-lane law (cfg bg_sampling):
          'stage1_exact' (default): stage-1's own z-law (``_stage1_bg_z``);
            escaped lanes then reproduce the frozen background exactly as
            stage 1 rendered it.  Deterministic, no importance round.
          'stage1': a heuristic law + a frozen-NeRF importance round.
          'linear64': the reference law, linspace(0.1, 64) + importance
            (renderer_zerothick.py:1764-1799), for exact parity runs."""
        cfg = self.cfg
        n = cfg["n_samples_outer"]
        n_imp = cfg["n_bg_importance"]
        start, direc = b["start"], b["dir"]
        rn, dt, dev = start.shape[0], start.dtype, start.device
        hit3 = b["hit"][:, None, None]

        end_hit = b["pos"]
        sphere_clip = bool(cfg.get("sphere_clip_outer", False))
        if sphere_clip and seg_index == 0:
            # Sphere-clipped z-law: outer-segment samples past the
            # unit-sphere entry are masked to zero in render() (the frozen
            # NeRF only counts outside the sphere), so clip the hit-lane
            # sample domain at the sphere entry.
            ob = torch.sum(start * direc, -1, keepdim=True)
            disc = ob * ob - (torch.sum(start * start, -1, keepdim=True) - 1.0)
            t_in = -ob - torch.sqrt(torch.clamp(disc, min=0.0))
            t_hit = torch.linalg.norm(end_hit - start, dim=-1, keepdim=True)
            t_end = torch.where((disc > 0) & (t_in > 0),
                                torch.minimum(t_in, t_hit), t_hit)
            end_hit = start + direc * t_end
        z_hit = torch.linspace(0.0, 1.0, n, device=dev, dtype=dt)[None, :, None]
        pts_hit = start[:, None, :] + (end_hit - start)[:, None, :] * z_hit

        mode = cfg.get("bg_sampling", "stage1_exact")
        if mode == "stage1_exact":
            # bounce-0 miss lanes are stage-1 rays: reuse stage-1's near
            near = cfg["bg_near0"] if seg_index == 0 else 1e-3
            if sphere_clip and seg_index != 0:
                # exit-segment miss lanes start on the mesh, inside the unit
                # sphere: per-lane near = the sphere-exit distance
                ob = torch.sum(start * direc, -1)
                disc = ob * ob - (torch.sum(start * start, -1) - 1.0)
                t_out = -ob + torch.sqrt(torch.clamp(disc, min=0.0))
                near_lane = torch.where((disc > 0) & (t_out > 0), t_out + 1e-3,
                                        torch.full_like(t_out, near))
                z_miss = self._stage1_bg_z_lanes(n, near_lane)
            else:
                z_miss = self._stage1_bg_z(n, near, dt)[None, :].expand(rn, n)
            pts_miss = start[:, None, :] + direc[:, None, :] * z_miss[..., None]
            return torch.where(hit3, pts_hit, pts_miss)

        # importance-sampled laws: coarse z + one round from the frozen
        # stage-1 background nerf weights (density-only fast path)
        n_coarse = n - n_imp
        if mode == "stage1":
            n_tail = n_coarse // 3
            z_near = torch.linspace(0.1, 4.5, n_coarse - n_tail, device=dev, dtype=dt)
            zc = torch.sort(torch.cat([z_near, torch.flip(
                self._bg_tail(n_tail, 4.5, dt), dims=[-1])], -1)).values
        else:
            zc = torch.linspace(0.1, cfg["bg_z_max"], n_coarse, device=dev, dtype=dt)
        zc = zc[None, :].expand(rn, n_coarse)
        pts_c = start[:, None, :] + direc[:, None, :] * zc[..., None]
        dists = torch.cat([zc[:, 1:] - zc[:, :-1], zc[:, -1:] - zc[:, -2:-1]], -1)
        with torch.no_grad():
            alpha = self._density_only_alpha(pts_c.reshape(-1, 3), dists.reshape(-1))
            weights = alpha_to_weights(alpha.reshape(rn, n_coarse))
            z_new = sample_pdf(zc, weights[:, :-1], n_imp, det=True)
        z_miss, _ = merge_z_vals(zc, z_new, None, None)
        pts_miss = start[:, None, :] + direc[:, None, :] * z_miss[..., None]
        return torch.where(hit3, pts_hit, pts_miss)

    def _sample_inner_segment(self, b):
        """Inside-glass segment (k == 1): NeuS-upsampled to the exit hit;
        uniform along seg_far on a miss (:1734-1760).

        cfg ``inner_upsample_parity_quirk`` (default off) replicates the
        reference's unit mix-up for exact-parity runs: its upsample rounds
        treat chord fractions as world-space z (renderer_zerothick.py:
        1739-1760); the default path keeps one world-unit z throughout."""
        cfg = self.cfg
        quirk = bool(cfg.get("inner_upsample_parity_quirk", False))
        n0 = cfg["n_samples_inner"]
        rounds = cfg["inner_up_rounds"]
        each = cfg["inner_up_each"]
        n_total = n0 + rounds * each
        start, direc = b["start"], b["dir"]
        rn, dt, dev = start.shape[0], start.dtype, start.device
        hit = b["hit"][:, None]

        seg_len = safe_norm(b["pos"] - start, keepdims=True)
        # z in world units toward the hit; miss lanes use the seg_far span
        safe_len = torch.where(hit, seg_len, torch.full_like(seg_len, cfg["seg_far"]))
        zf = torch.linspace(0.0, 1.0, n0, device=dev, dtype=dt)[None, :]  # chord fractions
        z = zf * (torch.ones_like(safe_len) if quirk else safe_len)  # [R,n0]

        def sdf_at(zz):
            with torch.no_grad():
                pts = start[:, None, :] + direc[:, None, :] * zz[..., None]
                return self.inner_sdf(pts.reshape(-1, 3)).reshape(rn, zz.shape[1])

        sdf = sdf_at(zf * safe_len)
        for i in range(rounds):
            sn = z.shape[1]
            ones = torch.ones((rn, sn - 1), device=dev, dtype=dt)
            if cfg.get("clip_sample_variance", True):
                inv_s = torch.clamp(self._inv_s_now().detach(), max=64 * 2 ** i) * ones
            else:
                inv_s = ones * 64 * 2 ** i
            new_z = neus_upsample(start, direc, z, sdf, each, inv_s)
            if i + 1 < rounds:
                z, sdf = merge_z_vals(z, new_z, sdf, sdf_at(new_z))
            else:
                z, _ = merge_z_vals(z, new_z, sdf, None)
        if quirk:
            z = z * safe_len  # fractions -> world

        # hit lanes: NeuS z (already spans [0, seg_len]); miss lanes: uniform
        z_miss = torch.linspace(0.0, 1.0, n_total, device=dev, dtype=dt)[None, :] * cfg["seg_far"]
        # the endpoint must be exactly the interface on hit lanes
        z_hit = torch.cat([z[:, :-1], seg_len], dim=-1)
        z_final = torch.where(hit, z_hit, z_miss)
        return start[:, None, :] + direc[:, None, :] * z_final[..., None]

    # ----- field helpers ------------------------------------------------
    @staticmethod
    def _nerf_pts4(points):
        norm = torch.clamp(torch.linalg.norm(points, dim=-1, keepdim=True), min=1e-3)
        return torch.cat([points / norm, 1.0 / norm], dim=-1)

    def _density_alpha(self, points, dists, dirs):
        """Frozen stage-1 NeRF++ background (renderer_zerothick.py:1536-1544)."""
        density, color = self.stage1.outer_nerf(self._nerf_pts4(points), dirs)
        alpha = 1.0 - torch.exp(-F.softplus(density[..., 0]) * dists)
        color = linear_to_srgb(torch.exp(torch.clamp(color, max=5.0)))
        return alpha, color

    def _density_only_alpha(self, points, dists):
        """Background alpha without the color head (for importance weights)."""
        density = self.stage1.outer_nerf.density(self._nerf_pts4(points))
        return 1.0 - torch.exp(-F.softplus(density[..., 0]) * dists)

    def _inner_sdf_alpha(self, points, dists, dirs, cos_anneal, step):
        """Inner NeuS alpha (renderer_zerothick.py:1490-1528)."""
        sdf, feats, grads = sdf_value_feature_grad(self.sdf_inner, points)
        inv_s = torch.clamp(self.var_inner(points), 1e-6, 1e6)[..., 0]
        freeze = self.cfg.get("freeze_inv_s_step")
        if freeze is not None and step < freeze:
            inv_s = inv_s.detach()
        floor = self._inv_s_floor(step)
        if floor is not None:
            inv_s = torch.clamp(inv_s, min=floor)
        true_cos = torch.sum(dirs * grads, dim=-1)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal)
                     + torch.relu(-true_cos) * cos_anneal)
        est_next = sdf + iter_cos * dists * 0.5
        est_prev = sdf - iter_cos * dists * 0.5
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        next_cdf = torch.sigmoid(est_next * inv_s)
        alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
        return alpha, grads, feats, inv_s, sdf

    def _stage1_sdf_feats(self, points):
        """Frozen stage-1 SDF features at interface points
        (renderer_zerothick.py:1530-1534 ``compute_sdf``)."""
        return self.stage1.sdf_net(points)[..., 1:]

    # ----- the core ------------------------------------------------------
    def render(self, rays_o, rays_d, step, cos_anneal_ratio=0.0,
               is_train=True, with_inter=False):
        cfg = self.cfg
        rn, dt, dev = rays_o.shape[0], rays_o.dtype, rays_o.device
        bounces, tir_mask = self.ray_trace(rays_o, rays_d, step)

        current_T = torch.ones((rn, 3), dtype=dt, device=dev)
        total_color = torch.zeros((rn, 3), dtype=dt, device=dev)
        outputs: Dict[str, Any] = {}
        normals_out = torch.zeros((rn, 3), dtype=dt, device=dev)
        spec_color_out = torch.zeros((rn, 3), dtype=dt, device=dev)
        spec_light_out = torch.zeros((rn, 3), dtype=dt, device=dev)
        spec_ref_out = torch.zeros((rn, 3), dtype=dt, device=dev)
        grad_err = torch.zeros((), dtype=dt, device=dev)
        std_out = torch.zeros((), dtype=dt, device=dev)

        # escaped lanes (active but no interface ahead) end at infinity: for
        # is_nerf scenes stage 1 closed every ray with a white (1-acc) fill
        # (renderer.py:843).  The reference's stage 2 drops that fill
        # (renderer_zerothick.py:1959), which starves escaped and
        # through-glass rays of radiance; cfg bg_infinity_fill (default on
        # for is_nerf) restores it.
        infinity_fill = bool(cfg.get("bg_infinity_fill", cfg.get("is_nerf", False)))
        color_net = self.stage1.color_net

        for i, b in enumerate(bounces):
            if i == 1:
                pts = self._sample_inner_segment(b)
            else:
                pts = self._sample_outer_segment(b, seg_index=i)
            # volume samples exclude the interface endpoint (:1866-1871)
            pn = pts[:, :-1, :]
            n_s = pn.shape[1]
            dists = safe_norm(pn[:, 1:] - pn[:, :-1])
            dists = torch.cat([dists, dists[:, -1:]], -1)
            dirs = b["dir"][:, None, :].expand(pn.shape)

            flat_p = pn.reshape(-1, 3)
            flat_d = dists.reshape(-1)
            flat_dir = dirs.reshape(-1, 3)
            alpha_nerf, color_nerf = self._density_alpha(flat_p, flat_d, -flat_dir)

            if i == 1:
                inner = torch.linalg.norm(flat_p, dim=-1) <= 1.0
                a_sdf, grads_in, feats_in, inv_s_in, _sdf = self._inner_sdf_alpha(
                    flat_p, flat_d, flat_dir, cos_anneal_ratio, step)
                c_sdf, _occ = self.color_inner(flat_p, grads_in, -flat_dir,
                                               feats_in, None)
                alpha = torch.where(inner, a_sdf, alpha_nerf)
                scolor = torch.where(inner[:, None], c_sdf, color_nerf)
                gnorm = torch.linalg.norm(grads_in, dim=-1)
                grad_err = masked_mean(
                    (gnorm - 1.0) ** 2,
                    inner & torch.repeat_interleave(b["active"], n_s))
                std_out = torch.mean(1.0 / inv_s_in)
            else:
                outer = torch.linalg.norm(flat_p, dim=-1) > 1.0
                alpha = torch.where(outer, alpha_nerf, torch.zeros_like(alpha_nerf))
                scolor = color_nerf

            escape = (b["active"] & ~b["hit"])[:, None]
            alpha = alpha.reshape(rn, n_s)
            weights = alpha_to_weights(alpha)
            scolor = scolor.reshape(rn, n_s, 3)
            fill = 0.0
            if infinity_fill:
                fill = (1.0 - torch.sum(weights, dim=-1, keepdim=True)) * escape
            if i != 1 and cfg.get("bg_srgb_composite", True):
                # frozen background segments: composite in sRGB space,
                # stage-1's convention, then add the is_nerf white fill on
                # escaped lanes, so that an escaped lane renders the frozen
                # field exactly as stage 1 did
                seg_color = srgb_to_linear(
                    torch.sum(scolor * weights[..., None], dim=1) + fill)
            else:
                # the trainable inner segment (and the background segments
                # in reference-parity mode): linear-space compositing
                # (renderer_zerothick.py:1948-1952)
                seg_color = torch.sum(srgb_to_linear(scolor) * weights[..., None],
                                      dim=1) + fill
            seg_T = torch.prod(1.0 - alpha + 1e-7, dim=-1, keepdim=True)
            # an escaped lane's radiance is fully accounted (fill): nothing
            # behind it may leak through
            if infinity_fill:
                seg_T = torch.where(escape, torch.zeros_like(seg_T), seg_T)

            act = b["active"][:, None]
            total_color = total_color + seg_color * current_T * act
            current_T = torch.where(act, current_T * seg_T, current_T)

            # interface shading on converged lanes (:1930-1948)
            iface_pts = b["pos"]
            feats1 = self._stage1_sdf_feats(iface_pts)
            conv = b["conv"][:, None]
            if i == 0 and not is_train:
                _, _, inter_if = color_net(iface_pts, b["normal"], -b["dir"],
                                           feats1, None, inter_results=True)
                zero3 = torch.zeros_like(normals_out)
                normals_out = torch.where(conv, (normalize(b["normal"]) + 1) * 0.5, zero3)
                spec_color_out = torch.where(conv, inter_if["specular_color"], zero3)
                spec_light_out = torch.where(conv, inter_if["specular_light"], zero3)
                spec_ref_out = torch.where(conv, inter_if["specular_ref"], zero3)
            c_if, occ_if = color_net.s2_shade(iface_pts, b["normal"], -b["dir"],
                                              feats1, self._is_internal(i))
            c_if_lin = srgb_to_linear(c_if)
            total_color = total_color + c_if_lin * current_T * conv
            current_T = torch.where(
                conv, current_T * occ_if["refraction_coefficient"], current_T)
            # Beer-Lambert absorption over the glass chord crossed at this
            # interface (only the curvature-shell mode records a chord)
            if "chord" in b and cfg.get("learn_absorption", False):
                # hold kappa at its init until the surface hardens (same
                # cure as for the IoR, see _freeze_flag)
                frozen_kap = self._freeze_flag(step, "freeze_absorption_step",
                                               "freeze_absorption_inv_s")
                raw = self._maybe_freeze(self.absorption, frozen_kap)
                att = torch.exp(-F.softplus(raw)[None, :] * b["chord"])
                current_T = torch.where(conv, current_T * att, current_T)

        ray_rgb = torch.clamp(linear_to_srgb(total_color), 0.0, 1.0)
        # training observability: mean glass IoR at the entry interface
        # (zero-thick map 1/(x+1) => n_glass = x+1) and whether the freeze
        # gate held this step
        b0 = bounces[0]
        hitf = b0["hit"].to(dt)
        ior_off = cfg.get("ior_offset", 1.0)
        ior_glass = (torch.sum((b0["ior_raw"][..., 0] + ior_off) * hitf)
                     / (torch.sum(hitf) + 1e-8)).detach()
        if cfg.get("learn_absorption", False):
            kappa_log = F.softplus(self.absorption).detach()
            outputs["kappa_r"] = kappa_log[0]
            outputs["kappa_g"] = kappa_log[1]
            outputs["kappa_b"] = kappa_log[2]
        outputs.update({
            "ray_rgb": ray_rgb,
            "gradient_error": grad_err,
            "std": std_out,
            "ior_glass": ior_glass,
            "ior_frozen": b0["ior_frozen"],
            "acc": torch.ones((rn,), dtype=dt, device=dev),
            "tir_mask": tir_mask[:, None].to(dt),
            "normal": normals_out,
            "specular_color": spec_color_out,
            "specular_light": spec_light_out,
            "specular_ref": spec_ref_out,
        })
        return outputs

    # ----- trainer entry points -----------------------------------------
    def get_anneal_val(self, step):
        if self.cfg["anneal_end"] < 0:
            return 1.0
        return min(1.0, step / self.cfg["anneal_end"])

    def compute_rgb_loss(self, rgb_pr, rgb_gt):
        mode = self.cfg["rgb_loss"]
        if mode == "l2":
            return torch.sum((rgb_pr - rgb_gt) ** 2, -1)
        if mode == "l1":
            return torch.sum(torch.abs(rgb_pr - rgb_gt), -1)
        if mode == "charbonier":
            return torch.sqrt(torch.sum((rgb_gt - rgb_pr) ** 2, dim=-1) + 0.001)
        raise NotImplementedError(mode)

    def _with_rgb_loss(self, outputs, batch):
        tm = outputs["tir_mask"]
        outputs["loss_rgb"] = self.compute_rgb_loss(
            outputs["ray_rgb"] * tm, batch["rgbs"] * tm)
        return outputs

    def train_outputs(self, batch, step: int, generator=None):
        """One training forward: render + the TIR-masked rgb loss.  batch:
        rays_o, rays_d, rgbs on the renderer's device.  ``generator`` is
        unused (stage 2 draws nothing) and kept for the trainer's call."""
        outputs = self.render(batch["rays_o"], normalize(batch["rays_d"]), step,
                              cos_anneal_ratio=self.get_anneal_val(step),
                              is_train=True)
        return self._with_rgb_loss(outputs, batch)

    def test_outputs(self, batch, step: int, generator=None):
        outputs = self.render(batch["rays_o"], normalize(batch["rays_d"]), step,
                              cos_anneal_ratio=1.0, is_train=False,
                              with_inter=True)
        return self._with_rgb_loss(outputs, batch)
