"""Headless-Blender relighting backend; the port's copy of
``nunerf_tpu/tools/relight_backend.py``.

Equivalent of the reference's ``blender_backend/relight_backend.py:15-110`` +
``blender_utils.py``: load the reconstructed mesh, attach the exported
per-vertex materials (metallic / roughness / albedo from ``cli.py relight``)
to a Principled BSDF via vertex-color attributes — metallic+roughness packed
into one RG layer split by a Separate-Color node, exactly the graph the
reference builds — light with an environment HDR, and render an arc of views
with film-transparent RGBA output.

The camera-pose math (world-to-camera [R|t] arcs -> Blender location +
quaternion) is pure numpy at module level so it is unit-testable without
Blender; ``main()`` is the only part that needs ``bpy``.

Run inside Blender (not importable in a normal Python env):

    blender --background --python relight_backend.py -- \
        --mesh mesh.ply --materials data/materials --hdr env.hdr --out out/
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np


# --------------------------------------------------------------------------
# pure-numpy pose helpers (testable without bpy)
# --------------------------------------------------------------------------

def quat_from_rotation(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a 3x3 rotation matrix
    (Shepperd's method: branch on the largest diagonal combination)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2.0
        q = np.array([0.25 * s,
                      (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = math.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s,
                      (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] >= R[2, 2]:
        s = math.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        q = np.array([(R[0, 2] - R[2, 0]) / s,
                      (R[0, 1] + R[1, 0]) / s, 0.25 * s,
                      (R[1, 2] + R[2, 1]) / s])
    else:
        s = math.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        q = np.array([(R[1, 0] - R[0, 1]) / s,
                      (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def relighting_poses(num: int, azimuth_deg: float = 0.0,
                     elevation_deg: float = 45.0,
                     dist: float = 3.0, frame: str = "z-up") -> np.ndarray:
    """[N,3,4] world-to-camera (OpenCV convention: +z forward, +y down)
    poses on a +-90 deg azimuth arc at fixed elevation, all looking at the
    origin — the reference's relighting camera sweep
    (blender_utils.py ``generate_relghting_poses``).

    Frame convention: the look-at math below assumes a Z-UP world — correct
    for meshes exported from the blender-convention synthetic scenes.  The
    reference additionally composes the remap R_trans =
    [[1,0,0],[0,0,-1],[0,1,0]] because its meshes live in the NeRO
    normalization frame (y-up); pass ``frame="y-up"`` for such meshes to
    reproduce the same arc (without it the sweep is rotated ~90 deg about x
    relative to the reference)."""
    if frame not in ("z-up", "y-up"):
        raise ValueError(f"frame must be 'z-up' or 'y-up', got {frame!r}")
    az = np.deg2rad(azimuth_deg) + np.linspace(-np.pi / 2, np.pi / 2, num)
    el = np.full_like(az, np.deg2rad(elevation_deg))
    centers = dist * np.stack([np.cos(az) * np.cos(el),
                               np.sin(az) * np.cos(el),
                               np.sin(el)], -1)            # [N,3], z-up world
    up = np.array([0.0, 0.0, 1.0])
    poses = np.zeros((num, 3, 4))
    for i, c in enumerate(centers):
        z_axis = -c / np.linalg.norm(c)                    # forward (at origin)
        x_axis = np.cross(z_axis, up)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)                  # points down
        R = np.stack([x_axis, y_axis, z_axis], 0)          # world->cam rows
        poses[i, :, :3] = R
        poses[i, :, 3] = -R @ c
    if frame == "y-up":
        # mesh world is y-up (NeRO normalization frame): rotate the mesh
        # frame into the z-up frame the arc above is defined in — the same
        # R_trans the reference composes (blender_utils.py
        # generate_relghting_poses, cam_rots @ [[1,0,0],[0,0,-1],[0,1,0]])
        r_trans = np.array([[1.0, 0.0, 0.0],
                            [0.0, 0.0, -1.0],
                            [0.0, 1.0, 0.0]])
        # x_cam = R @ (R_trans @ x_yup) + t: R_trans maps mesh y-up coords
        # into the z-up frame the arc is built in (R_trans @ (0,1,0) = z)
        poses[:, :, :3] = poses[:, :, :3] @ r_trans[None]
    return poses


def blender_camera_transform(pose: np.ndarray):
    """(location [3], quaternion wxyz [4]) for a Blender camera from a
    world-to-camera OpenCV pose [3,4].

    Blender cameras look along -z with +y up; OpenCV along +z with +y down:
    R_c2w_blender = R^T @ diag(1,-1,-1)."""
    R, t = np.asarray(pose[:, :3]), np.asarray(pose[:, 3])
    loc = -R.T @ t
    R_b = R.T @ np.diag([1.0, -1.0, -1.0])
    return loc, quat_from_rotation(R_b)


# --------------------------------------------------------------------------
# bpy driver
# --------------------------------------------------------------------------

def _set_input(node, names, value):
    """Set a node input trying several socket names (Principled BSDF socket
    names changed across Blender 3.x -> 4.x, e.g. Specular -> Specular IOR
    Level)."""
    for n in names:
        try:
            node.inputs[n].default_value = value
            return True
        except (KeyError, AttributeError):
            continue
    return False


def build_principled_graph(mat, albedo_layer: str, mr_layer: str):
    """The reference's material graph (relight_backend.py:52-73): vertex
    albedo -> Base Color; one RG-packed vertex layer -> Separate Color ->
    R=Metallic, G=Roughness; neutral specular/sheen/clearcoat defaults."""
    nt = mat.node_tree
    bsdf = nt.nodes["Principled BSDF"]
    _set_input(bsdf, ("Specular", "Specular IOR Level"), 0.5)
    _set_input(bsdf, ("Specular Tint",), 0.0)
    _set_input(bsdf, ("Sheen Tint",), 0.0)
    _set_input(bsdf, ("Clearcoat Roughness", "Coat Roughness"), 0.0)

    color_node = nt.nodes.new("ShaderNodeVertexColor")
    color_node.layer_name = albedo_layer
    nt.links.new(color_node.outputs["Color"], bsdf.inputs["Base Color"])

    mr_node = nt.nodes.new("ShaderNodeVertexColor")
    mr_node.layer_name = mr_layer
    try:
        sep = nt.nodes.new("ShaderNodeSeparateColor")   # Blender 4.x
        out_r, out_g, sep_in = "Red", "Green", "Color"
    except (KeyError, RuntimeError):
        sep = nt.nodes.new("ShaderNodeSeparateRGB")     # legacy
        out_r, out_g, sep_in = "R", "G", "Image"
    nt.links.new(mr_node.outputs["Color"], sep.inputs[sep_in])
    nt.links.new(sep.outputs[out_r], bsdf.inputs["Metallic"])
    nt.links.new(sep.outputs[out_g], bsdf.inputs["Roughness"])
    return bsdf, sep


def main():
    import bpy  # only available inside Blender

    argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else []
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", required=True)
    p.add_argument("--materials", required=True)
    p.add_argument("--hdr", required=True)
    p.add_argument("--out", default="relight_out")
    p.add_argument("--n-views", type=int, default=8)
    p.add_argument("--resolution", type=int, default=800)
    p.add_argument("--samples", type=int, default=1024)
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--elevation", type=float, default=45.0)
    p.add_argument("--cam-dist", type=float, default=3.0)
    args = p.parse_args(argv)

    # clean scene + render settings (reference blender_utils.setup)
    bpy.ops.wm.read_factory_settings(use_empty=True)
    scene = bpy.context.scene
    scene.render.engine = "CYCLES"
    scene.cycles.samples = args.samples
    scene.render.resolution_x = args.resolution
    scene.render.resolution_y = args.resolution
    scene.render.resolution_percentage = 100
    scene.render.film_transparent = True
    scene.render.image_settings.color_mode = "RGBA"
    scene.render.image_settings.file_format = "PNG"

    # environment light
    world = bpy.data.worlds.new("world")
    scene.world = world
    world.use_nodes = True
    nt = world.node_tree
    env = nt.nodes.new("ShaderNodeTexEnvironment")
    env.image = bpy.data.images.load(args.hdr)
    nt.links.new(env.outputs["Color"],
                 nt.nodes["Background"].inputs["Color"])

    # mesh + per-vertex materials as color attributes
    bpy.ops.wm.ply_import(filepath=args.mesh)
    obj = bpy.context.selected_objects[0]
    mesh = obj.data

    metallic = np.load(os.path.join(args.materials, "metallic.npy"))[:, 0]
    roughness = np.load(os.path.join(args.materials, "roughness.npy"))[:, 0]
    albedo = np.load(os.path.join(args.materials, "albedo.npy"))
    nv = len(mesh.vertices)

    def add_attr(name, rgb):
        attr = mesh.color_attributes.new(name=name, type="FLOAT_COLOR",
                                         domain="POINT")
        rgba = np.ones((nv, 4), np.float32)
        rgba[:, :3] = rgb.reshape(nv, -1)[:, :3]
        attr.data.foreach_set("color", rgba.reshape(-1))

    add_attr("albedo", albedo)
    # metallic in R, roughness in G — one layer, split in the node graph
    add_attr("mat_mr", np.stack(
        [metallic, roughness, np.zeros_like(metallic)], -1))

    mat = bpy.data.materials.new("recon")
    mat.use_nodes = True
    build_principled_graph(mat, "albedo", "mat_mr")
    obj.data.materials.append(mat)

    # camera on the relighting arc
    cam_data = bpy.data.cameras.new("cam")
    cam = bpy.data.objects.new("cam", cam_data)
    scene.collection.objects.link(cam)
    scene.camera = cam
    cam.rotation_mode = "QUATERNION"

    os.makedirs(args.out, exist_ok=True)
    poses = relighting_poses(args.n_views, args.azimuth, args.elevation,
                             args.cam_dist)
    for i in range(args.n_views):
        loc, quat = blender_camera_transform(poses[i])
        cam.location = tuple(loc)
        cam.rotation_quaternion = tuple(quat)
        scene.render.filepath = os.path.join(args.out, f"view_{i:03d}.png")
        bpy.ops.render.render(write_still=True)


if __name__ == "__main__":
    main()
