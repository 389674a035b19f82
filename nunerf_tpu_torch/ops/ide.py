"""Ref-NeRF integrated directional encoding (IDE) and mip-NeRF IPE;
counterpart of ``nunerf_tpu/ops/ide.py`` with its own copy of the numpy
coefficient tables.

Math follows Equations 6-8 of Ref-NeRF (arxiv.org/abs/2112.03907); the
reference implementation is ``utils/ref_utils.py:52-116``.  No complex
arithmetic: ``(x + i y)^m`` comes from a real/imaginary recurrence and the
encoding is two dense contractions.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def _generalized_binomial_coeff(a: float, k: int) -> float:
    return float(np.prod(a - np.arange(k)) / math.factorial(k))


def _assoc_legendre_coeff(l: int, m: int, k: int) -> float:
    """Coefficient of cos^k sin^m term in the associated Legendre P_l^m."""
    return ((-1) ** m * 2**l * math.factorial(l) / math.factorial(k)
            / math.factorial(l - k - m)
            * _generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def _sph_harm_coeff(l: int, m: int, k: int) -> float:
    return float(
        np.sqrt((2.0 * l + 1.0) * math.factorial(l - m)
                / (4.0 * np.pi * math.factorial(l + m)))
        * _assoc_legendre_coeff(l, m, k))


@lru_cache(maxsize=None)
def _ide_tables(deg_view: int):
    """Precompute (ml_array [2,C], coefficient matrix [l_max+1, C]) on host."""
    ml_list = []
    for i in range(deg_view):
        l = 2**i
        for m in range(l + 1):
            ml_list.append((m, l))
    ml_array = np.array(ml_list).T  # [2, C]
    l_max = 2 ** (deg_view - 1)
    mat = np.zeros((l_max + 1, ml_array.shape[1]))
    for i, (m, l) in enumerate(ml_list):
        for k in range(l - m + 1):
            mat[k, i] = _sph_harm_coeff(l, m, k)
    return ml_array.astype(np.int32), mat.astype(np.float32)


def ide_dim(deg_view: int) -> int:
    ml_array, _ = _ide_tables(deg_view)
    return 2 * ml_array.shape[1]


def make_ide_fn(deg_view: int):
    """Return ``ide(xyz [...,3], kappa_inv [...,1]) -> [..., 2*C]``;
    ``concat([real, imag], -1)`` of the attenuated spherical harmonics
    (72-dim for ``deg_view=5``)."""
    if deg_view > 5:
        raise ValueError("deg_view > 5 is numerically unstable")
    ml_array, mat_np = _ide_tables(deg_view)
    l_max = 2 ** (deg_view - 1)
    m_vals = torch.as_tensor(ml_array[0], dtype=torch.long)
    l_vals = ml_array[1].astype(np.float32)
    sigma_np = (0.5 * l_vals * (l_vals + 1.0)).astype(np.float32)
    m_max = int(ml_array[0].max())

    def ide(xyz, kappa_inv):
        x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
        vmz = torch.cat([z ** i for i in range(l_max + 1)], dim=-1)
        re_pows = [torch.ones_like(x)]
        im_pows = [torch.zeros_like(x)]
        for _ in range(m_max):
            re_p, im_p = re_pows[-1], im_pows[-1]
            re_pows.append(re_p * x - im_p * y)
            im_pows.append(re_p * y + im_p * x)
        mv = m_vals.to(xyz.device)
        vmxy_re = torch.cat(re_pows, dim=-1)[..., mv]
        vmxy_im = torch.cat(im_pows, dim=-1)[..., mv]
        mat = torch.as_tensor(mat_np, device=xyz.device, dtype=xyz.dtype)
        zpart = vmz @ mat
        sigma = torch.as_tensor(sigma_np, device=xyz.device, dtype=xyz.dtype)
        atten = torch.exp(-sigma * kappa_inv)
        return torch.cat([vmxy_re * zpart * atten, vmxy_im * zpart * atten], dim=-1)

    return ide


def expected_sin(mean, var):
    """Mean of sin(x) for x ~ N(mean, var) (reference ``field.py:433-435``)."""
    return torch.exp(-0.5 * var) * torch.sin(mean)


def ipe(mean, var, min_deg: int, max_deg: int):
    """mip-NeRF integrated positional encoding (reference ``field.py:438-444``)."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=mean.dtype,
                                 device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    scaled_mean = (mean[..., None, :] * scales[:, None]).reshape(shape)
    scaled_var = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(
        torch.cat([scaled_mean, scaled_mean + 0.5 * np.pi], dim=-1),
        torch.cat([scaled_var, scaled_var], dim=-1))
