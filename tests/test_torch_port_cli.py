"""The port's pipeline through ``nunerf_tpu_torch.cli`` on the CPU, against
the JAX package's functions on the same files.

On a ``make_test_scene`` scene (a sphere of radius 0.5), in a temporary
working directory: ``train`` of stage 1 (3 steps), ``extract-mesh-stage1``
at 32^3, a curvature-shell ``train`` of 2 steps with a validation,
``extract-mesh-stage2``, ``postprocess-stage2 --largest-component`` (and
with every face dropped), ``eval-geometry`` and ``eval-images``; then the
tools on the same files: ``render-mask``, ``mask-erosion``,
``postprocess-outer``, ``hull-mesh``, ``render-orbit``, and ``synth-scene
--colmap --shell`` followed by ``silhouette-prior``, ``hull-mesh`` and
``render-mask`` on its capture-layout database (``relight`` goes through
``cli.main`` in ``tests/test_torch_port_relight.py``).

The meshes are held to the JAX package's extraction over the JAX renderers'
SDFs with the same checkpoints (f32 on the CPU on both sides): the same
triangles in the same order, over vertices that match one to one within
1e-5.  The SDF values are f32 sums in another order (1.4e-6 apart), a vertex
interpolates between two of them (5.4e-6 apart at most, measured), and the
dedup numbers vertices in the order of their rounded coordinates, which such
a difference can swap.  The postprocess keeps the same faces as the JAX
command, and ``eval-geometry`` reads the chamfer of the JAX function on the
same points to 1e-6 of itself.
Printed lines have the JAX commands' formats.  ``render-orbit``'s views are
held to the JAX ``nvs`` of the same checkpoint, f32 on both sides, within
1e-5 (per-ray sums of a few dozen samples in another order).
"""

import json
import os
import re

import numpy as np
import pytest
import torch
import yaml

from nunerf_tpu.ops.chamfer import chamfer_distance_np
from nunerf_tpu.tracing import mesh_ops as jm
from nunerf_tpu_torch import cli
from nunerf_tpu_torch.tracing.mesh_ops import load_ply, save_ply
from scene_utils import make_test_scene


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S1 = {
    "name": "tiny", "network": "shape", "database_name": "nerf/tiny", "is_nerf": True,
    "loss": ["nerf_render", "eikonal", "std"],
    "n_samples": 8, "n_importance": 8, "up_sample_steps": 2,
    "n_bg_samples": 4, "n_front_samples": 2, "n_back_samples": 2,
    "sdf_n_layers": 4, "perturb": 0.0, "train_ray_num": 16, "test_ray_num": 64,
    "mixed_precision": False, "sdf_mixed_precision": False, "apply_occ_loss": False,
    "lr_cfg": {"lr": 5e-4, "end_warm": 2, "end_iter": 100}, "downsample_ratio": 0.5,
    "total_step": 3, "train_log_step": 1, "save_interval": 1000, "val_interval": 1000,
}
S1_NETS = {k: S1[k] for k in ("sdf_n_layers", "n_samples", "n_importance", "n_bg_samples",
                              "mixed_precision", "sdf_mixed_precision", "is_nerf")}


def _assert_same_mesh(verts, tris, jverts, jtris, atol=1e-5):
    """The same triangles, in the same order, over vertices matched one to
    one within ``atol``."""
    assert verts.shape == jverts.shape and tris.shape == jtris.shape
    d = np.linalg.norm(verts[:, None, :] - jverts[None, :, :], axis=-1)
    match = d.argmin(1)
    assert len(np.unique(match)) == len(verts)
    assert d[np.arange(len(verts)), match].max() <= atol
    np.testing.assert_array_equal(match[tris], jtris)


def _shell_cfg(dataset):
    return dict(
        name="tiny_s2", network="stage2", zero_thickness=False, database_name="nerf/tiny",
        dataset_dir=dataset, is_nerf=True, stage1_cfg=S1_NETS,
        stage1_ckpt_dir="data/model/tiny/model.ckpt",
        stage1_mesh_dir="data/meshes/tiny-3_simplified.ply",
        loss=["eikonal", "std", "nerf_render"], eikonal_weight=0.02,
        sdf_n_layers=4, sdf_bias=0.3, n_samples_outer=8, n_samples_inner=4,
        inner_up_rounds=1, inner_up_each=4, learn_absorption=True,
        freeze_ior_step=1, freeze_thickness_step=1, curv_smooth_iters=5,
        mixed_precision=False, train_ray_num=16, test_ray_num=64, downsample_ratio=0.5,
        lr_cfg={"lr": 5e-4, "end_warm": 2, "end_iter": 100},
        total_step=2, train_log_step=1, save_interval=2, val_interval=2)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Runs the port's pipeline once in a working directory of its own;
    returns (work dir, dataset dir, {subcommand: printed lines})."""
    work = tmp_path_factory.mktemp("work")
    dataset = str(work / "datasets")
    make_test_scene(os.path.join(dataset, "tiny"), n_train=3, n_test=2, h=20, w=24)
    prev = os.getcwd()
    os.chdir(work)
    printed = {}
    try:
        with open("s1.yaml", "w") as f:
            yaml.safe_dump(dict(S1, dataset_dir=dataset), f)
        with open("s2.yaml", "w") as f:
            yaml.safe_dump(_shell_cfg(dataset), f)
        # points of the analytic sphere the scene shows (radius 0.5)
        rs = np.random.RandomState(1)
        gt = rs.randn(3000, 3)
        np.save("gt.npy", (0.5 * gt / np.linalg.norm(gt, axis=-1, keepdims=True))
                .astype(np.float32))
        steps = [
            ("train_s1", ["train", "--cfg", "s1.yaml"]),
            ("extract_s1", ["extract-mesh-stage1", "--cfg", "s1.yaml", "--resolution", "32"]),
            ("train_s2", ["train", "--cfg", "s2.yaml"]),
            ("extract_s2", ["extract-mesh-stage2", "--cfg", "s2.yaml", "--resolution", "32"]),
            ("post", ["postprocess-stage2", "--input", "data/meshes/tiny_s2-2-inner.ply",
                      "--outer", "data/meshes/tiny-3_simplified.ply", "--largest-component"]),
            ("post_empty", ["postprocess-stage2", "--input", "data/meshes/tiny_s2-2-inner.ply",
                            "--outer", "data/meshes/tiny-3_simplified.ply",
                            "--threshold", "10", "--output", "data/meshes/empty.ply",
                            "--largest-component"]),
            ("eval_geometry", ["eval-geometry", "--mesh", "data/meshes/tiny-3_simplified.ply",
                               "--gt", "gt.npy", "--n-samples", "2000"]),
            ("eval_empty", ["eval-geometry", "--mesh", "data/meshes/empty.ply",
                            "--gt", "gt.npy", "--n-samples", "2000"]),
            ("eval_images", ["eval-images", "--cfg", "s2.yaml", "--split", "test"]),
        ]
        import contextlib
        import io
        for key, argv in steps:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(argv + ["--device", "cpu"])
            printed[key] = buf.getvalue().strip().splitlines()
    finally:
        os.chdir(prev)
    return work, dataset, printed


def test_stage1_extraction_matches_jax(pipeline):
    import jax

    from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
    from nunerf_tpu_torch.convert import load_jax_checkpoint

    work, dataset, printed = pipeline
    step, params, _ = load_jax_checkpoint(str(work / "data/model/tiny/model.ckpt"))
    assert step == 3
    jr = JShapeRenderer(dict(S1, dataset_dir=dataset))
    sdf = jax.jit(lambda x: jr.sdf(params, x)[..., 0])
    jv, jt = jm.extract_geometry(lambda p: np.asarray(sdf(p)), resolution=32)
    verts, tris = load_ply(str(work / "data/meshes/tiny-3.ply"))
    assert len(tris) > 500
    _assert_same_mesh(verts, tris, jv, jt)
    sv, st = load_ply(str(work / "data/meshes/tiny-3_simplified.ply"))
    assert 0 < len(st) < len(tris)
    _assert_same_mesh(sv, st, *jm.isotropic_remesh(jv, jt))
    assert printed["extract_s1"] == [
        f"wrote data/meshes/tiny-3.ply ({len(verts)} verts) + simplified"]


def test_shell_train_and_stage2_extraction_match_jax(pipeline):
    import jax

    from nunerf_tpu.models.stage2_shell import Stage2ShellRenderer as JShell
    from nunerf_tpu_torch.convert import flat_leaves, load_jax_checkpoint

    work, dataset, printed = pipeline
    logs = [json.loads(line) for line in
            open(work / "data/model/tiny_s2/train_log.jsonl")]
    assert [r["prefix"] for r in logs] == ["train", "train", "val"]
    for k in ("thickness_mean", "thickness_frozen", "kappa_r", "ior_frozen"):
        assert k in logs[1], k
    assert logs[1]["thickness_frozen"] == 0.0 and logs[0]["thickness_frozen"] == 1.0
    assert any(line.startswith("[val] step 2 psnr") for line in printed["train_s2"])
    assert os.path.exists(work / "data/model/tiny_s2/model_best.ckpt")

    step, params, _ = load_jax_checkpoint(str(work / "data/model/tiny_s2/model.ckpt"))
    assert step == 2 and sorted(params["train"]) == sorted(
        ["sdf_inner", "var_inner", "shade_inner", "ior", "ior_int", "thickness",
         "iors_vec", "absorption"])
    # the frozen stage-1 subtree leaves the shell's training untouched
    _, s1_params, _ = load_jax_checkpoint(str(work / "data/model/tiny/model.ckpt"))
    frozen, s1 = flat_leaves(params["frozen"]), flat_leaves(s1_params)
    assert sorted(frozen) == sorted(s1)
    for k, v in s1.items():
        np.testing.assert_array_equal(frozen[k], v, err_msg=k)
    prev = os.getcwd()
    os.chdir(work)
    try:
        jr = JShell(_shell_cfg(dataset))
    finally:
        os.chdir(prev)

    @jax.jit
    def sdf(x):
        inner = jr.inner_sdf(params, x)[..., 0]
        outer = jr.stage1_sdf(x, params["frozen"])[..., 0]
        return jax.numpy.where(outer < 0, inner, 1.0)

    jv, jt = jm.extract_geometry(lambda p: np.asarray(sdf(p)), resolution=32)
    verts, tris = load_ply(str(work / "data/meshes/tiny_s2-2-inner.ply"))
    assert len(tris) > 100
    _assert_same_mesh(verts, tris, jv, jt)
    assert printed["extract_s2"] == [
        f"wrote data/meshes/tiny_s2-2-inner.ply ({len(verts)} verts)"]


def test_postprocess_matches_jax_and_survives_zero_faces(pipeline, capsys):
    import argparse

    from nunerf_tpu import cli as jcli

    work, _, printed = pipeline
    inner = str(work / "data/meshes/tiny_s2-2-inner.ply")
    outer = str(work / "data/meshes/tiny-3_simplified.ply")
    out = str(work / "jax_post.ply")
    jcli.cmd_postprocess_stage2(argparse.Namespace(
        input=inner, outer=outer, output=out, threshold=0.055, largest_component=True))
    jlines = capsys.readouterr().out.strip().splitlines()
    assert printed["post"] == jlines
    pv, pt = load_ply(str(work / "data/meshes/tiny_s2-2-inner_post.ply"))
    jv, jt = load_ply(out)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pt, jt)
    assert len(pt) > 0
    # every face dropped: the port writes an empty mesh where JAX fails
    n = len(load_ply(inner)[1])
    assert printed["post_empty"] == [f"kept 0/{n} faces (distance filter: 0)"]
    assert len(load_ply(str(work / "data/meshes/empty.ply"))[1]) == 0


def test_eval_geometry_matches_jax(pipeline):
    work, _, printed = pipeline
    rec = json.loads(printed["eval_geometry"][0])
    a = cli.sample_surface(str(work / "data/meshes/tiny-3_simplified.ply"), 2000)
    b = cli.sample_surface(str(work / "gt.npy"), 2000)
    want = chamfer_distance_np(a, b)
    assert abs(rec["chamfer"] - want) <= 1e-6 * want
    assert abs(rec["pred_to_gt"] + rec["gt_to_pred"] - rec["chamfer"]) <= 1e-9
    empty = json.loads(printed["eval_empty"][0])
    assert empty["chamfer"] is None and empty["error"] == "empty surface: pred=0 gt=2000"


def test_eval_images_prints_the_jax_lines(pipeline):
    work, _, printed = pipeline
    lines = printed["eval_images"]
    views = [line for line in lines if line.startswith("view")]
    assert len(views) == 2
    for line in views:
        assert re.fullmatch(r"view +\S+  psnr +-?\d+\.\d{3}  ssim -?\d\.\d{4}", line), line
    assert re.fullmatch(r"split 'test' \(2 views\)  mean psnr -?\d+\.\d{3}  mean ssim "
                        r"-?\d\.\d{4}", lines[-2]), lines[-2]
    assert lines[-1] == "wrote data/eval/tiny_s2/eval_test.json"
    rec = json.load(open(work / "data/eval/tiny_s2/eval_test.json"))
    assert rec["step"] == 2 and len(rec["views"]) == 2
    assert all(np.isfinite(v["psnr"]) for v in rec["views"])


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.chdir(tmp_path)
    save_ply("m.ply", *jm.extract_geometry(lambda p: np.linalg.norm(p, axis=-1) - 0.5,
                                           resolution=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["postprocess-stage2", "--input", "m.ply", "--outer", "m.ply"])
    with open("c.yaml", "w") as f:
        yaml.safe_dump(dict(S1, dataset_dir=str(tmp_path)), f)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["render-mask", "--cfg", "c.yaml", "--mesh_path", "m.ply"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["postprocess-outer", "--input", "m.ply"])


def _run(argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = cli.main(argv + ["--device", "cpu"])
    return rec, buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def tools(pipeline):
    """The tools through ``cli.main`` in the pipeline's working directory;
    returns {subcommand: (what it returned, printed lines)}."""
    work, dataset, _ = pipeline
    prev = os.getcwd()
    os.chdir(work)
    out = {}
    try:
        outer = "data/meshes/tiny-3_simplified.ply"
        hull = "data/meshes/tiny-3_simplified_hull.ply"
        with open("c.yaml", "w") as f:
            yaml.safe_dump({"name": "cap", "database_name": "custom/synth_c/32",
                            "dataset_dir": str(work), "is_nerf": False}, f)
        for key, argv in [
            ("render_mask", ["render-mask", "--cfg", "s1.yaml", "--mesh_path", outer]),
            ("mask_erosion", ["mask-erosion", "--cfg", "s1.yaml", "--erosion", "3"]),
            ("hull_mesh", ["hull-mesh", "--input", outer]),
            # on the hull (1,578 faces): the plain closest hit is slow on the CPU
            ("postprocess_outer", ["postprocess-outer", "--input", hull, "--views", "8",
                                   "--smooth", "2"]),
            ("render_orbit", ["render-orbit", "--cfg", "s1.yaml", "--ckpt",
                              "data/model/tiny/model.ckpt", "--n-views", "2", "--size", "16"]),
            ("synth_scene", ["synth-scene", "--output", "synth_c", "--colmap", "--shell",
                             "--n-train", "3"]),
            ("silhouette_prior", ["silhouette-prior", "--cfg", "c.yaml", "--output",
                                  "prior.ply"]),
            ("hull_prior", ["hull-mesh", "--input", "prior.ply"]),
            ("render_mask_prior", ["render-mask", "--cfg", "c.yaml", "--mesh_path",
                                   "prior.ply"]),
        ]:
            out[key] = _run(argv)
        with pytest.raises(SystemExit, match="COLMAP-style"):
            _run(["silhouette-prior", "--cfg", "s1.yaml"])
    finally:
        os.chdir(prev)
    return work, dataset, out


def test_mask_tools_through_the_cli(tools):
    from nunerf_tpu_torch.data import image_io
    from nunerf_tpu_torch.data.database import parse_database_name

    work, dataset, out = tools
    mask_dir = os.path.join(dataset, "tiny", "mask")
    # 3 train views and every 64th of the 2 test views
    assert out["render_mask"] == (mask_dir, [f"wrote 4 masks to {mask_dir}"])
    ero = os.path.join(dataset, "tiny", "mask_erosion")
    assert out["mask_erosion"] == (ero, [f"wrote 4 eroded masks to {ero}"])
    db = parse_database_name("nerf/tiny", dataset)
    for i in db.get_img_ids():
        stem = os.path.splitext(db.get_image_name(i))[0]
        m = image_io.imread(os.path.join(mask_dir, stem + ".png"))
        assert m.shape == (20, 24) and m.any() and not m.all()
        e = image_io.imread(os.path.join(ero, stem + ".png"))
        np.testing.assert_array_equal(db.get_mask(i), e.astype(np.float32) / 255.0)
        assert (e >= 255 - m).all()  # outside the mask stays 255


def test_outer_and_hull_tools_match_jax(tools, capsys):
    import argparse

    from nunerf_tpu import cli as jcli

    work, _, out = tools
    outer = str(work / "data/meshes/tiny-3_simplified.ply")
    hull = "data/meshes/tiny-3_simplified_hull.ply"
    jcli.cmd_hull_mesh(argparse.Namespace(input=outer, output=str(work / "j_hull.ply")))
    jcli.cmd_postprocess_outer(argparse.Namespace(input=str(work / hull),
                                                  output=str(work / "j_outer.ply"),
                                                  views=8, radius=2.0, smooth=2))
    jlines = capsys.readouterr().out.strip().splitlines()
    assert out["hull_mesh"][1] == [jlines[0].replace(str(work / "j_hull.ply"), hull)]
    path, stats = out["postprocess_outer"][0]
    assert path == "data/meshes/tiny-3_simplified_hull_outer.ply" and stats["smooth_iters"] == 2
    assert out["postprocess_outer"][1] == [
        jlines[1].replace(str(work / "j_outer.ply"), path)]
    for mine, theirs in ((path, "j_outer.ply"), (hull, "j_hull.ply")):
        for a, b in zip(load_ply(str(work / mine)), load_ply(str(work / theirs))):
            np.testing.assert_array_equal(a, b)


def test_render_orbit_matches_jax_nvs(tools):
    import jax

    from nunerf_tpu.models.stage1 import ShapeRenderer as JShapeRenderer
    from nunerf_tpu_torch.convert import load_jax_checkpoint
    from nunerf_tpu_torch.data import image_io

    work, dataset, out = tools
    imgs, printed = out["render_orbit"]
    assert printed == ["wrote 2 views to data/orbit"] and imgs.shape == (2, 16, 16, 3)
    step, params, _ = load_jax_checkpoint(str(work / "data/model/tiny/model.ckpt"))
    jr = JShapeRenderer(dict(S1, dataset_dir=dataset))
    focal = 0.5 * 16 / np.tan(0.5 * 0.65)
    K = np.array([[focal, 0, 8], [0, focal, 8], [0, 0, 1]], np.float32)
    params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    for k in range(2):
        want = jr.nvs(params, cli.orbit_pose(k, 2, 2.2, 0.4), K, 16, 16, step=step)
        np.testing.assert_allclose(imgs[k], want, rtol=0, atol=1e-5)
        png = image_io.imread(str(work / f"data/orbit/orbit_{k:03d}.png"))
        np.testing.assert_array_equal(png, (np.clip(imgs[k], 0, 1) * 255).astype(np.uint8))


def test_capture_layout_tools_through_the_cli(tools):
    from nunerf_tpu_torch.data import image_io
    from nunerf_tpu_torch.data.database import parse_database_name

    work, _, out = tools
    assert out["synth_scene"] == ("synth_c", ["wrote nested-glass scene to synth_c"])
    path, nv, nf = out["silhouette_prior"][0]
    assert path == "prior.ply" and nv > 10 and nf == 2 * nv - 4  # a closed convex hull
    assert re.fullmatch(rf"silhouette prior: \d+ cloud pts -> hull {nv} verts / {nf} faces "
                        r"-> prior\.ply", out["silhouette_prior"][1][0])
    assert out["hull_prior"][1] == [f"hull: {nv} verts -> {nv} verts / {nf} faces -> "
                                    "prior_hull.ply"]
    mask_dir = str(work / "synth_c" / "mask")
    assert out["render_mask_prior"] == (mask_dir, [f"wrote 3 masks to {mask_dir}"])
    db = parse_database_name("custom/synth_c/32/rawmask", str(work))
    for i in db.get_img_ids():
        m = db.get_mask(i)
        assert m.shape == db.get_image(i).shape[:2] and 0 < m.mean() < 1
        np.testing.assert_array_equal(
            m, image_io.imread(str(work / "synth_c" / "mask" / db.get_image_name(i)))
            .astype(np.float32) / 255.0)
