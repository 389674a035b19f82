"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: inputs made with numpy from a seed, handed to both sides."""

import jax
import numpy as np
import torch


def jitter_tree(tree, seed: int, rel: float = 0.1):
    """The JAX parameter tree with every leaf moved by ``rel`` of its mean
    magnitude in a random direction (decouples ``g`` from ``||v||`` and moves
    the SDF off its init sphere, so the comparisons are strict)."""
    rs = np.random.RandomState(seed)

    def f(x):
        x = np.asarray(x, np.float32)
        noise = np.asarray(rs.randn(*x.shape), np.float32)
        return x + rel * (np.abs(x).mean() + 1e-3) * noise

    return jax.tree_util.tree_map(f, tree)


def t(x):
    """numpy -> CPU torch tensor (copied, writable)."""
    return torch.as_tensor(np.array(x))


def assert_close(actual, expected, rtol, atol=0.0, what=""):
    """|actual - expected| <= atol + rtol * max|expected| elementwise: a
    tolerance relative to the array's scale, since sums taken in another
    order differ by a multiple of the largest term's rounding."""
    a = actual.detach().cpu().numpy() if torch.is_tensor(actual) else np.asarray(actual)
    e = np.asarray(expected)
    assert a.shape == e.shape, (what, a.shape, e.shape)
    err = np.abs(a.astype(np.float64) - e.astype(np.float64)).max() if e.size else 0.0
    bound = atol + rtol * (np.abs(e).max() if e.size else 0.0)
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"


def assert_trees_close(actual_leaves, expected_leaves, rtol, atol=0.0):
    assert sorted(actual_leaves) == sorted(expected_leaves)
    for k, e in expected_leaves.items():
        assert_close(actual_leaves[k], e, rtol, atol, what=k)


def assert_close_calibrated(actual, expected, ref64, rtol, k=10.0, what="",
                            expected64=None):
    """``actual`` (the port in f32) against ``expected`` (JAX in f32) within
    ``rtol * max|ref64| + k * (max|actual - ref64| + max|expected -
    expected64|)``, where ``ref64`` / ``expected64`` are the port / JAX in
    float64: the conditioning terms measure the f32 error of each side, which
    no f32 evaluation escapes."""
    def arr(x):
        return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x, np.float64)

    a, r, e = arr(actual), arr(ref64), arr(expected)
    assert a.shape == e.shape == r.shape, (what, a.shape, e.shape, r.shape)
    cond = np.abs(a - r).max()
    if expected64 is not None:
        cond += np.abs(e - arr(expected64)).max()
    bound = rtol * np.abs(r).max() + k * cond
    err = np.abs(a - e).max()
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"
