"""Score a trained shell-mode stage-2 checkpoint against the analytic ground
truth; counterpart of ``tools/eval_shell.py``:

    python -m nunerf_tpu_torch.tools.eval_shell --cfg configs/stage2/nerf/nested_shell.yaml \\
        --meta datasets/nested_shell/meta.json [--ckpt model.ckpt] [--device cpu]

The hollow-glass scene (``synth-scene --shell``) has a known IoR and shell
thickness.  Under the reference maps (eta = 1/(x + ior_offset),
renderer.py:1727; thickness = x * thickness_scale, :1741) the learned values
are the IoR and thickness fields' means over 4,096 points of the outer
sphere (``meta["r_outer"] * v / |v|``, ``v`` from ``RandomState(0)``).  With
``learn_absorption`` the learned Beer-Lambert kappa is ``softplus`` of the
checkpoint's ``absorption``, beside the ground truth per normalized unit
(``glass_kappa / norm_scale``).  Prints one JSON line and writes it to
``runs/eval_shell_<name>.json`` under the working directory.  Reads
checkpoints of both packages; the fields run on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def eval_shell(cfg, meta, ckpt=None, device="cuda"):
    """The learned IoR, thickness and (with ``learn_absorption``) kappa of
    the checkpoint ``ckpt`` (by default ``data/model/<name>/model.ckpt``)
    against ``meta``'s ground truth, as a dict."""
    import torch

    from nunerf_tpu_torch.convert import load_jax_params
    from nunerf_tpu_torch.device import resolve_device
    from nunerf_tpu_torch.fields.aux import IoRNetwork, ThicknessNetwork
    from nunerf_tpu_torch.train.trainer import load_checkpoint

    dev = resolve_device(device)
    ckpt = ckpt or os.path.join("data/model", cfg["name"], "model.ckpt")
    _, params, _, _ = load_checkpoint(ckpt)
    train = params["train"]

    # evaluate the fields where they matter: on the GT outer surface
    rs = np.random.RandomState(0)
    v = rs.randn(4096, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = torch.as_tensor(meta["r_outer"] * v, dtype=torch.float32, device=dev)

    fields = {}
    for key, net in (("ior", IoRNetwork(device=dev)), ("thickness", ThicknessNetwork(device=dev))):
        load_jax_params(net, train[key])
        with torch.no_grad():
            fields[key] = net(pts).float().cpu().numpy()
    ior_x, thick_x = fields["ior"], fields["thickness"]

    learned_ior = float(ior_x.mean()) + cfg.get("ior_offset", 0.6)
    learned_tau = float(thick_x.mean()) * cfg.get("thickness_scale", 0.01)
    out = {
        "learned_ior": learned_ior,
        "gt_ior": meta["ior"],
        "ior_abs_err": abs(learned_ior - meta["ior"]),
        "learned_thickness": learned_tau,
        "gt_thickness": meta.get("tau"),
        "thickness_abs_err": (abs(learned_tau - meta["tau"]) if "tau" in meta else None),
        "ior_field_std": float(ior_x.std()),
        "thickness_field_std": float(thick_x.std()),
    }
    if "absorption" in train:
        # GT kappa is per canonical world unit (tools/synth_nested.py); the
        # renderer's chords live in the normalized database frame for
        # capture-layout scenes, so the comparable GT is kappa / norm_scale
        kappa = np.log1p(np.exp(np.asarray(train["absorption"])))  # softplus
        out["learned_kappa"] = [float(k) for k in kappa]
        if "glass_kappa" in meta:
            ns = meta.get("norm_scale", 1.0)
            out["gt_kappa_normalized"] = [float(k) / ns for k in meta["glass_kappa"]]
    return out


def main(argv=None):
    """The command; returns the printed dict."""
    from nunerf_tpu_torch.config import load_cfg

    ap = argparse.ArgumentParser(prog="nunerf_tpu_torch.tools.eval_shell")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--meta", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the fields on the host")
    args = ap.parse_args(argv)

    cfg = load_cfg(args.cfg)
    with open(args.meta) as f:
        meta = json.load(f)
    out = eval_shell(cfg, meta, args.ckpt, args.device)
    print(json.dumps(out))
    os.makedirs("runs", exist_ok=True)
    out_fp = os.path.join("runs", f"eval_shell_{cfg['name']}.json")
    with open(out_fp, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {out_fp}")
    return out


if __name__ == "__main__":
    main()
