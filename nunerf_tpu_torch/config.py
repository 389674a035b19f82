"""Config system: YAML -> one flat dict, default-merged per component.

The port's own copy of ``nunerf_tpu/config.py`` (renderer defaults).  Mirrors the
reference convention (``utils/base_utils.py:319-322`` +
``{**default_cfg, **cfg}`` merging everywhere) so reference YAML configs work
unchanged (keys per reference ``README.md:74-82``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict


def load_cfg(path: str) -> Dict[str, Any]:
    import yaml  # only configs from files need it

    with open(path, "r") as f:
        return yaml.safe_load(f)


def merge_cfg(default: Dict[str, Any], cfg: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(default)
    out.update(cfg or {})
    return out


# Stage-1 renderer defaults (reference network/renderer.py:103-150 /
# renderer_zerothick.py:89-127 — zero-thickness variant uses
# train_ray_num 512 and downsample_ratio 0.5).
STAGE1_DEFAULTS: Dict[str, Any] = {
    "std_act": "exp",
    "inv_s_init": 0.3,
    "freeze_inv_s_step": None,
    "sdf_activation": "none",
    "sdf_bias": 0.5,
    "sdf_n_layers": 8,
    "sdf_freq": 6,
    "sdf_d_out": 257,
    "geometry_init": True,
    "shader_config": {},
    "n_samples": 64,
    "n_bg_samples": 32,
    "inf_far": 1000.0,
    "n_importance": 64,
    "up_sample_steps": 4,
    # Sphere-clipped static sample partition (net-new TPU design, see
    # stage1.ShapeRenderer.sample_ray_partitioned): the SDF/shading branch
    # runs only on the unit-sphere chord samples and the NeRF++ background
    # only on the gap + tail samples.  False restores the round-1 behavior
    # (both branches at every sample, `where`-merged).
    "partition_samples": True,
    "n_front_samples": 16,
    "n_back_samples": 16,
    "perturb": 1.0,
    "anneal_end": 50000,
    "train_ray_num": 1024,
    "test_ray_num": 1024,
    "clip_sample_variance": True,
    "is_nerf": False,
    "database_name": "nerf/spherepot",
    "dataset_dir": "./datasets",
    "test_downsample_ratio": True,
    "downsample_ratio": 1.0,
    "val_geometry": False,
    "rgb_loss": "charbonier",
    "apply_occ_loss": True,
    "occ_loss_step": 20000,
    "occ_loss_max_pn": 2048,
    "occ_sdf_thresh": 0.01,
    "fixed_camera": False,
    "get_mask": False,
    "zero_thickness": False,
    # Mixed precision: bf16 matmuls (f32 params/accumulation) for the
    # shading stack and background NeRF.  Net-new vs the reference (which is
    # f32-only).
    "mixed_precision": False,
    # bf16 compute inside the SDF trunk matmuls (f32 accumulation + f32
    # final layer).  Separate gate from mixed_precision because the SDF
    # zero-crossing drives geometry quality; see fields/sdf.py.
    "sdf_mixed_precision": False,
}

SHADER_DEFAULTS: Dict[str, Any] = {
    "human_light": False,
    "sphere_direction": False,
    "light_pos_freq": 6,
    "inner_init": -0.95,
    "roughness_init": 0.0,
    "metallic_init": 0.0,
    "light_exp_max": 3.0,
    "refrac_freq": 6,
}


# Stage-2 renderer defaults (reference network/renderer.py:908-965 /
# renderer_zerothick.py:869-930).
STAGE2_DEFAULTS: Dict[str, Any] = {
    "std_act": "exp",
    "inv_s_init": 0.3,
    "freeze_inv_s_step": None,
    "sdf_activation": "none",
    "sdf_bias": 0.5,
    "sdf_n_layers": 8,
    "sdf_freq": 6,
    "sdf_d_out": 257,
    "geometry_init": True,
    "shader_config": {},
    "n_samples_inner": 64,
    "n_importance_inner": 32,
    "n_bg_samples": 64,
    "n_samples_segment": 64,
    "max_bounces": 3,
    "perturb": 1.0,
    "anneal_end": 50000,
    "train_ray_num": 1024,
    "test_ray_num": 1024,
    "is_nerf": False,
    "database_name": "nerf/spherepot",
    "dataset_dir": "./datasets",
    "downsample_ratio": 1.0,
    "test_downsample_ratio": True,
    "rgb_loss": "charbonier",
    "apply_occ_loss": True,
    "occ_loss_step": 20000,
    "get_mask": False,
    "zero_thickness": False,
    "stage1_mesh_dir": None,
    "stage1_ckpt_dir": None,
    "stage1_cfg_dir": None,
    "mixed_precision": True,
}
