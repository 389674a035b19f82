"""Time the port's curvature-shell stage-2 training step on one GPU.

    python3 tools/shell_step_torch.py [TREE ...]

Each TREE (default: this checkout) is the root of a checkout of the port,
for instance an unpacked ``git archive`` of another commit.  For each, in a
process of its own and from that tree's own sources and kernels, it runs
that tree's ``chip_smoke.phase_main_path_shell``: ``SHELL_CFG`` at step
``SHELL_STEP``, 4 steps, the mean of the last 3 on the host clock, 3 K3
launches a step.  The mesh is ``chip_smoke.lumpy_sphere_mesh`` at
``MESH_RESOLUTION`` (about 117k triangles) in place of the remeshed
extraction that ``chip_smoke.py`` traces, so every tree steps on the same
mesh.  Prints one JSON line a tree: ``tree``, ``step_ms``, ``rays_per_s``,
``first_step_ms``, ``peak_gib``, ``card``.  Needs CUDA: without it, it exits 2.
"""

import json
import os
import subprocess
import sys
import tempfile


def one_tree(tree):
    """Run in a child whose working directory and import root is ``tree``."""
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from nunerf_tpu_torch.tracing.mesh_ops import save_ply

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    verts, tris = cs.lumpy_sphere_mesh(cs.MESH_RESOLUTION)
    with tempfile.TemporaryDirectory() as d:
        mesh = os.path.join(d, "outer.ply")
        save_ply(mesh, verts, tris)
        _, res = cs.phase_main_path_shell(mesh, torch.device("cuda"))
    print(json.dumps({"tree": tree, **{k: res[k] for k in (
        "step_ms", "rays_per_s", "first_step_ms", "peak_gib")}, "card": cs.card_line()}),
        flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        one_tree(argv[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("shell_step_torch: CUDA is not available", file=sys.stderr)
        return 2
    rc = 0
    for tree in argv or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
