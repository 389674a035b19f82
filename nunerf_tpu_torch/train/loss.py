"""Loss registry: pure functions from the renderer outputs dict to scalars;
counterpart of ``nunerf_tpu/train/loss.py``.

Mirrors the reference registry (``network/loss.py:215-227``); each term is a
function ``(outputs, batch, step, cfg) -> dict[str, scalar]`` and the trainer
sums every returned entry whose key starts with ``loss`` (the reference
trainer does the same over module outputs, ``train/trainer.py:152-161``).

Step-gated terms (outer_reg after 15000) multiply by the gate, as in the
JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from nunerf_tpu_torch.models.stage1 import masked_mean


def nerf_render_loss(outputs, batch, step, cfg):
    out = {}
    for k in ("loss_rgb", "loss_rgb_fine", "loss_global_rgb", "loss_rgb_inner",
              "loss_rgb0", "loss_rgb1", "loss_masks"):
        if k in outputs:
            out[k] = torch.mean(outputs[k])
    return out


def eikonal_loss(outputs, batch, step, cfg):
    """network/loss.py:26-48 with optional anneal window."""
    w = cfg.get("eikonal_weight", 0.1)
    begin = cfg.get("eikonal_weight_anneal_begin", 0)
    end = cfg.get("eikonal_weight_anneal_end", 0)
    if end > begin:
        ramp = min(max((step - begin) / (end - begin), 0.0), 1.0)
        w = w * ramp
    return {"loss_eikonal": torch.mean(outputs["gradient_error"]) * w}


def std_recorder(outputs, batch, step, cfg):
    out = {}
    if "std" in outputs:
        out["std"] = outputs["std"]
        if cfg.get("apply_std_loss", False):
            out["loss_std"] = outputs["std"] * cfg.get("std_loss_weight", 0.01)
    for k in ("inner_std", "outer_std", "ior_glass", "ior_frozen",
              "thickness_mean", "thickness_frozen",
              "kappa_r", "kappa_g", "kappa_b"):
        if k in outputs:
            out[k] = outputs[k]
    return out


def init_sdf_reg_loss(outputs, batch, step, cfg):
    """network/loss.py:115-149 — terms already computed (and annealed) inside
    the renderer under lax.cond."""
    out = {}
    for k in ("loss_sdf_small", "loss_sdf_large"):
        if k in outputs:
            out[k] = outputs[k]
    return out


def occ_loss(outputs, batch, step, cfg):
    if "loss_occ" in outputs:
        return {"loss_occ": torch.mean(outputs["loss_occ"])}
    return {}


def mask_loss(outputs, batch, step, cfg):
    if "loss_mask" in outputs:
        return {"loss_mask": outputs["loss_mask"]
                * cfg.get("mask_loss_weight", 0.01)}
    return {}


def outer_reg_loss(outputs, batch, step, cfg):
    """network/loss.py:194-213: mse(color_bkgr, color_spec) after step 15000,
    over rays whose candidate sample is inside the sphere."""
    if "color_bkgr" not in outputs:
        return {}
    mask = outputs.get("spec_mask")
    diff = (outputs["color_bkgr"] - outputs["color_spec"]) ** 2
    if mask is not None:
        mse = masked_mean(torch.mean(diff, dim=-1), mask)
    else:
        mse = torch.mean(diff)
    gate = float(step >= cfg.get("outer_reg_step", 15000))
    return {"loss_outer_reg": mse * gate
            * cfg.get("outer_reg_loss_weight", 0.5)}


def transmission_reg_loss(outputs, batch, step, cfg):
    if "transmission" in outputs:
        return {"loss_trans_reg": torch.mean(outputs["transmission"] ** 2)
                * cfg.get("transmission_reg_loss_weight", 0.1)}
    return {}


def metallic_reg_loss(outputs, batch, step, cfg):
    if "metallic" in outputs:
        return {"loss_metal_reg": torch.mean(outputs["metallic"] ** 2)
                * cfg.get("metallic_reg_loss_weight", 0.1)}
    return {}


def normal_orientation_loss(outputs, batch, step, cfg):
    if "loss_normal" in outputs:
        return {"loss_normal": torch.mean(outputs["loss_normal"])}
    return {}


def material_reg_loss(outputs, batch, step, cfg):
    out = {}
    for k in ("loss_mat_reg", "loss_diffuse_light"):
        if k in outputs:
            out[k] = torch.mean(outputs[k])
    return out


name2loss_terms = {
    "nerf_render": nerf_render_loss,
    "eikonal": eikonal_loss,
    "std": std_recorder,
    "init_sdf_reg": init_sdf_reg_loss,
    "occ": occ_loss,
    "mask": mask_loss,
    "outer_reg": outer_reg_loss,
    "mat_reg": material_reg_loss,
    "transmission_reg": transmission_reg_loss,
    "metallic_reg": metallic_reg_loss,
    "normal_ori": normal_orientation_loss,
}


def compute_losses(outputs: Dict[str, Any], batch, step, cfg) -> Dict[str, Any]:
    """Evaluate the configured loss terms; returns the merged term dict plus
    ``loss_total`` = sum of all ``loss*`` entries."""
    terms: Dict[str, Any] = {}
    for name in cfg.get("loss", []):
        terms.update(name2loss_terms[name](outputs, batch, step, cfg))
    total = 0.0
    for k, v in terms.items():
        if k.startswith("loss"):
            total = total + torch.mean(v)
    terms["loss_total"] = total
    return terms
