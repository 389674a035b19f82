"""Split-sum environment BRDF lookup table (the "FG" term); counterpart of
``nunerf_tpu/ops/fg_lut.py`` with its own copy of ``compute_fg_lut``.

The table is computed with split-sum preintegration (GGX importance
sampling with alpha = roughness^2, Smith height-correlated visibility,
Schlick Fresnel weight), in float64 and on the card where there is one, at
first use, and cached under ``nunerf_tpu_torch/assets/`` (listed in
``.gitignore``).  Layout: rows (v) = roughness, cols (u) = NoV.  The lookup is
a bilinear gather with clamped borders (nvdiffrast's ``filter_mode='linear',
boundary_mode='clamp'``).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def _hammersley(n: int) -> np.ndarray:
    """n x 2 low-discrepancy points (van der Corput radical inverse base 2)."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | ((bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | ((bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | ((bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | ((bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    y = bits.astype(np.float64) * 2.3283064365386963e-10
    x = i.astype(np.float64) / n
    return np.stack([x, y], axis=-1)


def compute_fg_lut(res: int = 256, n_samples: int = 4096, device="cpu") -> np.ndarray:
    """Integrate the split-sum BRDF -> [res, res, 2] float32 (A, B), in
    float64 on ``device``.  Rows = roughness, cols = NoV."""
    f64 = dict(dtype=torch.float64, device=device)
    xi = torch.as_tensor(_hammersley(n_samples), **f64)          # [S,2]
    uv = (torch.arange(res, **f64) + 0.5) / res
    rough_g = uv[:, None].expand(res, res).reshape(-1, 1)        # [T,1]
    nov_g = uv[None, :].expand(res, res).reshape(-1, 1)          # [T,1]
    alpha2 = (rough_g ** 2) ** 2

    vx = torch.sqrt(torch.clamp(1.0 - nov_g ** 2, min=0.0))
    vz = nov_g
    a_sum = torch.zeros((res * res, 1), **f64)
    b_sum = torch.zeros((res * res, 1), **f64)
    chunk = 64
    for s0 in range(0, n_samples, chunk):
        x = xi[s0:s0 + chunk]
        phi = 2.0 * np.pi * x[None, :, 0]                        # [1,C]
        cos_th = torch.sqrt((1.0 - x[None, :, 1])
                            / (1.0 + (alpha2 - 1.0) * x[None, :, 1]))  # [T,C]
        sin_th = torch.sqrt(torch.clamp(1.0 - cos_th ** 2, min=0.0))
        hx = sin_th * torch.cos(phi)
        hz = cos_th
        voh = vx * hx + vz * hz
        lz = 2.0 * voh * hz - vz
        nol = torch.clamp(lz, min=0.0)
        noh = torch.clamp(hz, min=0.0)
        voh = torch.clamp(voh, min=0.0)
        valid = lz > 0

        # Smith height-correlated visibility V (includes 1/(4 NoV NoL));
        # sample weight = 4 V NoL VoH / NoH
        g_l = nol * torch.sqrt(torch.clamp(nov_g ** 2 * (1.0 - alpha2) + alpha2, min=1e-18))
        g_v = nov_g * torch.sqrt(torch.clamp(nol ** 2 * (1.0 - alpha2) + alpha2, min=1e-18))
        vis = 0.5 / torch.clamp(g_l + g_v, min=1e-9)
        g_vis = torch.where(valid, 4.0 * vis * nol * voh / torch.clamp(noh, min=1e-9),
                            torch.zeros_like(vis))
        fc = (1.0 - voh) ** 5
        a_sum += torch.sum((1.0 - fc) * g_vis, dim=-1, keepdim=True)
        b_sum += torch.sum(fc * g_vis, dim=-1, keepdim=True)

    lut = torch.cat([a_sum, b_sum], dim=-1) / n_samples
    return lut.reshape(res, res, 2).to(torch.float32).cpu().numpy()


@lru_cache(maxsize=None)
def get_fg_lut(res: int = 256) -> np.ndarray:
    path = os.path.join(_ASSET_DIR, f"fg_lut_{res}.npy")
    if os.path.exists(path):
        return np.load(path)
    lut = compute_fg_lut(res, device="cuda" if torch.cuda.is_available() else "cpu")
    os.makedirs(_ASSET_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, lut)
    os.replace(tmp, path)
    return lut


def fg_lookup(lut: torch.Tensor, no_v: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Bilinear LUT sample.  lut [R,R,2]; no_v/roughness [...,1] in [0,1]
    -> [..., 2].  Rows (v) = roughness, cols (u) = NoV (field.py:721-722)."""
    r = lut.shape[0]
    u = torch.clamp(no_v[..., 0], 0.0, 1.0) * r - 0.5
    v = torch.clamp(roughness[..., 0], 0.0, 1.0) * r - 0.5
    u0 = torch.clamp(torch.floor(u), 0, r - 1).long()
    v0 = torch.clamp(torch.floor(v), 0, r - 1).long()
    u1 = torch.clamp(u0 + 1, max=r - 1)
    v1 = torch.clamp(v0 + 1, max=r - 1)
    fu = torch.clamp(u - u0, 0.0, 1.0)[..., None]
    fv = torch.clamp(v - v0, 0.0, 1.0)[..., None]
    c00 = lut[v0, u0]
    c01 = lut[v0, u1]
    c10 = lut[v1, u0]
    c11 = lut[v1, u1]
    return ((1 - fv) * (1 - fu) * c00 + (1 - fv) * fu * c01
            + fv * (1 - fu) * c10 + fv * fu * c11)
