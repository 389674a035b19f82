"""The port's ops against their JAX functions (CPU, f32), inputs from a numpy
seed.  Tolerances are stated per test: 1e-6 of the array's scale where both
sides do the same elementwise f32 arithmetic, 1e-5 where sums or
transcendentals of large arguments are taken in another order.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunerf_tpu import config as j_config
from nunerf_tpu.ops import embedder as j_emb
from nunerf_tpu.ops import fg_lut as j_fg
from nunerf_tpu.ops import geometry as j_geo
from nunerf_tpu.ops import ide as j_ide
from nunerf_tpu.ops import sampling as j_smp
from nunerf_tpu.ops import srgb as j_srgb
from nunerf_tpu.ops import volume as j_vol
from nunerf_tpu_torch import config
from nunerf_tpu_torch.ops import embedder, fg_lut, geometry, ide, sampling, srgb, volume
from port_helpers import assert_close, assert_close_calibrated, t


def _rs(seed):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("multires", [4, 10])
def test_posenc(multires):
    x = _rs(0).randn(50, 3).astype(np.float32)
    assert embedder.posenc_dim(multires) == j_emb.posenc_dim(multires)
    # sin/cos of arguments up to 2^9 |x|: 1e-5 of the scale
    assert_close(embedder.posenc(t(x), multires),
                 j_emb.posenc(jnp.asarray(x), multires), 1e-5)


def test_srgb_both_ways():
    x = np.concatenate([np.linspace(-0.1, 1.5, 200), [0.0031308, 0.04045]]).astype(np.float32)
    assert_close(srgb.linear_to_srgb(t(x)), j_srgb.linear_to_srgb(jnp.asarray(x)), 1e-6)
    assert_close(srgb.srgb_to_linear(t(x)), j_srgb.srgb_to_linear(jnp.asarray(x)), 1e-6)


def test_volume_weights():
    alpha = _rs(1).rand(7, 33).astype(np.float32)
    assert_close(volume.exclusive_cumprod(t(1 - alpha)),
                 j_vol.exclusive_cumprod(jnp.asarray(1 - alpha)), 1e-6)
    assert_close(volume.alpha_to_weights(t(alpha)),
                 j_vol.alpha_to_weights(jnp.asarray(alpha)), 1e-6)
    values = _rs(11).rand(7, 33, 3).astype(np.float32)
    # sums of 33 terms in another order: 1e-6 of the scale
    assert_close(volume.composite(t(alpha), t(values)),
                 j_vol.composite(jnp.asarray(alpha), jnp.asarray(values)), 1e-6)


def test_geometry():
    rs = _rs(2)
    pts = (rs.randn(40, 3) * 0.7).astype(np.float32)
    dirs = rs.randn(40, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for name, args in [("get_sphere_intersection", (pts * 0.5, dirs)),
                       ("offset_points_to_sphere", (pts * 2,)),
                       ("normalize", (pts,)),
                       ("schlick_weight", (pts[:, :1],))]:
        assert_close(getattr(geometry, name)(*[t(a) for a in args]),
                     getattr(j_geo, name)(*[jnp.asarray(a) for a in args]),
                     1e-6, what=name)
    zero_row = np.concatenate([pts, np.zeros((1, 3), np.float32)])
    assert_close(geometry.safe_norm(t(zero_row)), j_geo.safe_norm(jnp.asarray(zero_row)),
                 1e-6, what="safe_norm")
    assert_close(geometry.dot(t(pts), t(dirs)),
                 j_geo.dot(jnp.asarray(pts), jnp.asarray(dirs)), 1e-6, what="dot")
    for a, b in zip(geometry.near_far_from_sphere(t(pts), t(dirs)),
                    j_geo.near_far_from_sphere(jnp.asarray(pts), jnp.asarray(dirs))):
        assert_close(a, b, 1e-6)


def test_refraction_geometry():
    """safe_sqrt, reflect, refract, fresnel_dielectric, ray_sphere_hit: values
    to 1e-6 (the same few f32 operations), masks exact, TIR angles included,
    and the zero-safe gradients of safe_sqrt and safe_norm."""
    rs = _rs(20)
    n = rs.randn(64, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wi = rs.randn(64, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wi *= np.sign(np.sum(wi * n, -1, keepdims=True))  # on the normal's side
    assert_close(geometry.reflect(t(wi), t(n)), j_geo.reflect(jnp.asarray(wi), jnp.asarray(n)),
                 1e-6, what="reflect")
    for eta in (1.0 / 1.5, 1.5):  # entering; exiting, where grazing rays reflect totally
        wt, tir = geometry.refract(t(wi), t(n), eta)
        jwt, jtir = j_geo.refract(jnp.asarray(wi), jnp.asarray(n), eta)
        np.testing.assert_array_equal(tir.numpy(), np.asarray(jtir))
        assert bool(tir.any()) == (eta > 1.0)
        assert_close(wt, jwt, 1e-6, what="refract")
        assert not wt[tir].any()
    eta_row = np.full((64, 1), 1.5, np.float32)
    wt, tir = geometry.refract(t(wi), t(n), t(eta_row))
    jwt, jtir = j_geo.refract(jnp.asarray(wi), jnp.asarray(n), jnp.asarray(eta_row))
    assert_close(wt, jwt, 1e-6, what="refract, eta per ray")

    cos_i = np.linspace(-0.1, 1.1, 50, dtype=np.float32)
    for ei, et in ((1.0, 1.5), (1.5, 1.0)):
        fr = geometry.fresnel_dielectric(t(cos_i), ei, et)
        assert_close(fr, j_geo.fresnel_dielectric(jnp.asarray(cos_i), ei, et), 1e-6,
                     what="fresnel")
        assert float(fr.min()) >= 0.0 and float(fr.max()) <= 1.0
    assert float(geometry.fresnel_dielectric(t(cos_i), 1.5, 1.0)[5]) == 1.0  # TIR

    o = (rs.randn(64, 3) * 1.5).astype(np.float32)
    for radius in (1.0, 0.5):
        res = geometry.ray_sphere_hit(t(o), t(wi), radius)
        jres = j_geo.ray_sphere_hit(jnp.asarray(o), jnp.asarray(wi), radius)
        np.testing.assert_array_equal(res[2].numpy(), np.asarray(jres[2]))
        assert 0 < int(res[2].sum()) < 64
        assert_close(res[0], jres[0], 1e-6, what="t_near")
        assert_close(res[1], jres[1], 1e-6, what="t_far")

    x = np.array([0.0, 1e-14, 0.25, 4.0], np.float32)
    assert_close(geometry.safe_sqrt(t(x)), j_geo.safe_sqrt(jnp.asarray(x)), 1e-6)
    xt = t(x).requires_grad_(True)
    geometry.safe_sqrt(xt).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(j_geo.safe_sqrt(v)))(jnp.asarray(x))
    assert torch.isfinite(xt.grad).all() and float(xt.grad[0]) == 0.0
    assert_close(xt.grad, jg, 1e-6, what="safe_sqrt grad")
    v = t(np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 4.0]], np.float32)).requires_grad_(True)
    geometry.safe_norm(v).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(j_geo.safe_norm(a)))(jnp.asarray(v.detach().numpy()))
    assert torch.isfinite(v.grad).all() and not v.grad[0].any()
    assert_close(v.grad, jg, 1e-6, what="safe_norm grad")


def test_searchsorted_right_with_ties():
    cdf = np.array([[0.0, 0.2, 0.2, 0.5, 1.0]] * 3, np.float32)
    u = np.array([[0.0, 0.2, 0.3], [0.5, 0.99, 1.0], [0.1, 0.2, 0.7]], np.float32)
    np.testing.assert_array_equal(
        sampling._searchsorted_right(t(cdf), t(u)).numpy(),
        np.asarray(j_smp._searchsorted_right(jnp.asarray(cdf), jnp.asarray(u))))


def test_sample_pdf_det():
    rs = _rs(3)
    bins = np.sort(rs.rand(6, 17), axis=-1).astype(np.float32) * 3
    w = rs.rand(6, 16).astype(np.float32)
    w[0] = 0.0  # degenerate pdf row
    assert_close(sampling.sample_pdf(t(bins), t(w), 24, det=True),
                 j_smp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 24, det=True), 1e-5)


def _rays(n, seed):
    rs = _rs(seed)
    o = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (n, 1))
    d = rs.randn(n, 3).astype(np.float32) * 0.3 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def test_neus_upsample():
    o, d = _rays(9, 4)
    z = np.tile(np.linspace(0.8, 4.5, 32, dtype=np.float32), (9, 1))
    pts = o[:, None] + d[:, None] * z[..., None]
    sdf = (np.linalg.norm(pts, axis=-1) - 0.5).astype(np.float32)
    inv_s = np.full((9, 31), 64.0, np.float32)
    assert_close(sampling.neus_upsample(t(o), t(d), t(z), t(sdf), 16, t(inv_s)),
                 j_smp.neus_upsample(jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
                                     jnp.asarray(sdf), 16, jnp.asarray(inv_s)), 1e-5)


@pytest.mark.parametrize("rank", ["0", "1"])
def test_merge_z_vals_with_ties(rank, monkeypatch):
    """Both port branches (stable argsort, merged ranks) against the JAX
    default, with equal z in the two lists: z_vals' elements come first."""
    monkeypatch.setenv("NUNERF_MERGE_RANK", rank)
    rs = _rs(5)
    z1 = np.sort(rs.randint(0, 6, (4, 8)), axis=-1).astype(np.float32)
    z2 = np.sort(rs.randint(0, 6, (4, 5)), axis=-1).astype(np.float32)
    s1 = rs.randn(4, 8).astype(np.float32)
    s2 = rs.randn(4, 5).astype(np.float32)
    tz, ts = sampling.merge_z_vals(t(z1), t(z2), t(s1), t(s2))
    jz, js = j_smp.merge_z_vals(*[jnp.asarray(a) for a in (z1, z2, s1, s2)])
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tz2, none = sampling.merge_z_vals(t(z1), t(z2), t(s1), None)
    assert none is None
    np.testing.assert_array_equal(tz2.numpy(), np.asarray(jz))


def test_get_intersection():
    rs = _rs(6)
    pts = (rs.randn(30, 3) * 0.5).astype(np.float32)
    dirs = rs.randn(30, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    def j_sdf(x):
        return jnp.linalg.norm(x - 0.1, axis=-1, keepdims=True) - 0.3

    def t_sdf(x):
        return torch.linalg.norm(x - 0.1, dim=-1, keepdim=True) - 0.3

    out_t = sampling.get_intersection(t_sdf, lambda x: torch.full_like(x[:, :1], 50.0),
                                      t(pts), t(dirs), sn0=64, sn1=16)
    out_j = j_smp.get_intersection(j_sdf, lambda x: jnp.full_like(x[:, :1], 50.0),
                                   jnp.asarray(pts), jnp.asarray(dirs), sn0=64, sn1=16)
    for a, b, what in zip(out_t, out_j, ("z", "weights", "sdf")):
        assert_close(a, b, 1e-5, what=what)


def test_ide_and_ipe():
    """IDE at degree 5 reaches l = 16 with large alternating coefficients;
    held to 1e-5 plus ten times each side's f32 error against float64."""
    rs = _rs(7)
    xyz = rs.randn(64, 3)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    kappa = rs.rand(64, 1)
    kappa[:8] = 0.0
    f_t, f_j = ide.make_ide_fn(5), j_ide.make_ide_fn(5)
    out32 = f_t(t(xyz.astype(np.float32)), t(kappa.astype(np.float32)))
    out64 = f_t(t(xyz), t(kappa))
    j32 = f_j(jnp.asarray(xyz, jnp.float32), jnp.asarray(kappa, jnp.float32))
    with jax.enable_x64(True):
        j64 = np.asarray(f_j(jnp.asarray(xyz), jnp.asarray(kappa)))
    assert out32.shape == (64, ide.ide_dim(5)) == j32.shape
    assert_close_calibrated(out32, j32, out64, 1e-5, expected64=j64)

    mean = rs.randn(20, 2).astype(np.float32)
    var = rs.rand(20, 2).astype(np.float32)
    assert_close(ide.ipe(t(mean), t(var), 0, 6),
                 j_ide.ipe(jnp.asarray(mean), jnp.asarray(var), 0, 6), 1e-5)


def test_fg_lut_and_lookup():
    # the port's own copy of the integration, at a small size
    np.testing.assert_allclose(fg_lut.compute_fg_lut(16, 256),
                               j_fg.compute_fg_lut(16, 256), rtol=1e-6, atol=1e-7)
    rs = _rs(8)
    lut = rs.rand(32, 32, 2).astype(np.float32)
    nov = rs.uniform(-0.1, 1.1, (100, 1)).astype(np.float32)
    rough = rs.uniform(-0.1, 1.1, (100, 1)).astype(np.float32)
    assert_close(fg_lut.fg_lookup(t(lut), t(nov), t(rough)),
                 j_fg.fg_lookup(jnp.asarray(lut), jnp.asarray(nov), jnp.asarray(rough)),
                 1e-6)


def test_config_copy_matches_jax():
    """The port's own copy of the renderer defaults and of the YAML loader."""
    from nunerf_tpu.models.stage2 import ZERO_THICK_DEFAULTS as J_ZERO_THICK
    from nunerf_tpu_torch.models.stage2 import ZERO_THICK_DEFAULTS

    assert config.STAGE2_DEFAULTS == j_config.STAGE2_DEFAULTS
    assert ZERO_THICK_DEFAULTS == J_ZERO_THICK
    assert config.STAGE1_DEFAULTS == j_config.STAGE1_DEFAULTS
    assert config.SHADER_DEFAULTS == j_config.SHADER_DEFAULTS
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = sorted(glob.glob(os.path.join(root, "configs", "shape", "*", "*.yaml")))[0]
    cfg = config.load_cfg(path)
    assert cfg == j_config.load_cfg(path)
    merged = config.merge_cfg(config.STAGE1_DEFAULTS, cfg)
    assert merged == j_config.merge_cfg(j_config.STAGE1_DEFAULTS, cfg)
    # merging copies: the defaults stay as they were
    assert config.STAGE1_DEFAULTS == j_config.STAGE1_DEFAULTS
