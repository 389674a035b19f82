"""The legs of the nested-glass pipeline through the port; counterpart of
``tools/run_nested_pipeline.sh``:

    python -m nunerf_tpu_torch.pipeline front --workdir DIR [--device cpu]
    python -m nunerf_tpu_torch.pipeline stage2 BUDGET_S --workdir DIR

Every leg of the script is here (``LEGS``), and each runs the script's
subcommands, with its arguments and in its order, through
``nunerf_tpu_torch.cli.main`` (and ``tools/eval_shell.py``'s counterpart,
``nunerf_tpu_torch.tools.eval_shell``).  Three things differ, on purpose:

* **The working directory.**  A leg runs in ``--workdir`` (by default
  ``pipeline_work/`` of the checkout), never in the repository's root: the
  configs' relative paths (``./datasets``, ``./data/meshes/...``,
  ``data/model/<name>``, ``./configs/...``) resolve there.  The configs are
  read from the repository and written, with the caller's overrides, to the
  same relative paths under the working directory, so that a stage-2
  config's ``stage1_cfg_dir`` reads the stage-1 config the leg trained.  A
  JAX checkpoint at the root's ``data/model/<name>/model.ckpt`` is never
  resumed by accident (the port would drop its Adam moments).
* **Mesh names are chained, not hard-coded.**  The path that
  ``extract-mesh-stage1`` returns, named from its checkpoint's step, is the
  path the later subcommands get; likewise the inner mesh of
  ``extract-mesh-stage2`` (the script's ``ls -t | head -1``).  A stage-2 leg
  first checks that its config's ``stage1_mesh_dir`` and ``stage1_ckpt_dir``
  exist, and stops with a message naming the missing path and the meshes
  that are there; it renames nothing and falls back to nothing.
* **What it prints.**  Each subcommand prints its own lines and then its
  seconds; the leg ends with one JSON line (steps trained, checkpoint steps
  used, seconds of each subcommand, chamfers, test scores, the shell's
  scores), also written to ``<workdir>/runs/leg_<leg>.json``.

Legs that take a budget (``stage2``, ``shell_stage2``, ``shell_stage2b``,
``real_stage2``, ``real_stage2_fresh``, and ``real_boot`` where one is
given) train in a child process,
``python -m nunerf_tpu_torch.cli train``, stopped within ``budget`` seconds
as the script's ``timeout`` stops it: a pause, after which the leg goes on
from the last checkpoint and a rerun resumes exactly.  The child is stopped
right after a ``model.ckpt`` save once the next save, at the pace of the
last one, would land past the budget, so no trained step is lost; else at
the budget (checkpoints are written through ``.tmp`` and ``os.replace``, so
a kill never leaves half of one).  A paused ``real_boot`` ends there; run
again, it renders its prior masks anew (the same bytes) and resumes.  A
checkpoint carries the trainer's draws (``Trainer.rng_state``), so a resumed
run is the run that was never stopped.  A child that ends by itself leaves its
kernels' launch counts and peak memory in the record (``train_child``,
through ``cli``'s ``NUNERF_LAUNCH_LOG``).  The other legs train in this
process.

``--keep 2500,5000,7500`` hands a leg's ``train`` (the child too) the
steps at which it also writes the parameters alone, gzip'd, to
``data/model/<name>/model_<step>.ckpt.gz`` (``Trainer(keep=...)``): copies
made outside the step, so the run is the same with and without them.

``run_leg`` is the library form; its ``cfg_overrides`` (``{config path:
{key: value}}``) and ``extra_args`` (``{subcommand: [arguments]}``, appended,
so that a later ``--resolution`` or ``--size`` wins) shrink a leg for tests
and smoke runs.  The command line always runs the repository's values.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_WORKDIR = os.path.join(REPO, "pipeline_work")
WATCH_S = 0.5  # how often a budgeted child's checkpoint is looked at

S1_NESTED = "configs/shape/nerf/nested.yaml"
S1_SHELL = "configs/shape/nerf/nested_shell.yaml"
S1_REAL = "configs/shape/real/nested_real.yaml"
S1_BOOT = "configs/shape/real/nested_real_boot.yaml"
S2_NESTED = "configs/stage2/nerf/nested.yaml"
S2_SHELL = "configs/stage2/nerf/nested_shell.yaml"
S2_SHELL_B = "configs/stage2/nerf/nested_shell_b.yaml"
S2_REAL = "configs/stage2/real/nested_real.yaml"


class LegError(RuntimeError):
    """A leg cannot go on: a missing input or a failed child."""


def train_command(cfg_path, device):
    """The child process of a budgeted ``train``."""
    return [sys.executable, "-m", "nunerf_tpu_torch.cli", "train", "--cfg", cfg_path,
            "--device", str(device)]


def _keep_args(keep):
    return ["--keep", ",".join(str(int(k)) for k in keep)] if keep else []


def _ckpt_step(path):
    """The step of a checkpoint file, or None where there is none."""
    if not os.path.exists(path):
        return None
    from nunerf_tpu_torch.train.trainer import load_checkpoint

    return int(load_checkpoint(path)[0])


class _Leg:
    """One leg's state in its working directory: its derived configs, the
    record it builds and the subcommands it runs."""

    def __init__(self, name, device, cfg_overrides, extra_args, keep=()):
        self.device = str(device)
        self.keep = tuple(keep)
        self.overrides = cfg_overrides or {}
        self.extra_args = extra_args or {}
        self.cfgs = {}
        self.paused = False
        self.record = {"leg": name, "workdir": os.getcwd(), "device": self.device,
                       "steps": {}, "checkpoints": {}, "commands": [], "chamfer": {},
                       "eval_images": {}, "meshes": {}}

    # configs ----------------------------------------------------------
    def cfg(self, rel):
        """The config ``rel`` of the repository, with its overrides, written
        to ``rel`` under the working directory (and, first, the stage-1
        config it names); returns (path, dict)."""
        if rel not in self.cfgs:
            from nunerf_tpu_torch.config import load_cfg
            import yaml

            cfg = dict(load_cfg(os.path.join(REPO, rel)), **self.overrides.get(rel, {}))
            s1 = cfg.get("stage1_cfg_dir")
            if s1:
                self.cfg(os.path.normpath(s1))
            os.makedirs(os.path.dirname(rel), exist_ok=True)
            with open(rel, "w") as f:
                yaml.safe_dump(cfg, f)
            self.cfgs[rel] = cfg
        return rel, self.cfgs[rel]

    # subcommands -------------------------------------------------------
    def cli(self, *argv):
        """``cli.main(argv)`` on the leg's device; prints and records its
        seconds, returns what it returns."""
        from nunerf_tpu_torch import cli

        argv = list(argv) + list(self.extra_args.get(argv[0], []))
        t0 = time.perf_counter()
        out = cli.main(argv + ["--device", self.device])
        secs = time.perf_counter() - t0
        print(f"[pipeline] {argv[0]}: {secs:.2f} s", flush=True)
        self.record["commands"].append({"command": argv[0], "argv": argv, "s": secs})
        return out

    def synth(self, output, *args):
        self.cli("synth-scene", "--output", output, *args)

    def train(self, rel, budget=None):
        """``train`` of config ``rel``: in this process, or with ``budget``
        in a child killed after ``budget`` seconds (a pause).  Records the
        checkpoint's step before and after."""
        path, cfg = self.cfg(rel)
        ckpt = os.path.join(cfg.get("model_dir", "data/model"), cfg["name"], "model.ckpt")
        before = _ckpt_step(ckpt)
        paused = False
        if budget is None:
            self.cli("train", "--cfg", path, *_keep_args(self.keep))
        else:
            paused = self._train_child(path, float(budget), ckpt)
        after = _ckpt_step(ckpt)
        if after is None:
            raise LegError(f"train --cfg {path} left no checkpoint at {ckpt}")
        if self.keep:
            self.record["kept"] = sorted(glob.glob(os.path.join(os.path.dirname(ckpt),
                                                                "model_*.ckpt.gz")))
        self.paused = paused
        self.record["steps"][cfg["name"]] = {"from": before or 0, "to": after,
                                             "total_step": cfg["total_step"],
                                             "paused": paused}
        print(f"[pipeline] {cfg['name']}: steps {before or 0} -> {after} of "
              f"{cfg['total_step']}" + (" (paused at the budget)" if paused else ""),
              flush=True)
        return after

    def _train_child(self, path, budget, ckpt):
        """The child ``train``; True where it was stopped (a pause): right
        after a save of ``ckpt`` when the next would land past the budget,
        else at the budget."""
        from nunerf_tpu_torch import cli

        cmd = train_command(path, self.device) + _keep_args(self.keep)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        os.makedirs("runs", exist_ok=True)
        log = env[cli.LAUNCH_LOG] = os.path.abspath(
            os.path.join("runs", f"launches_train_{os.getpid()}.json"))
        print(f"[pipeline] train (budget {budget:.0f} s): {' '.join(cmd)}", flush=True)
        t0 = time.perf_counter()
        child = subprocess.Popen(cmd, env=env, start_new_session=True)
        try:
            rc = self._watch(child, t0 + budget, ckpt)
            if rc is None:
                # the script's `timeout`: TERM, then KILL whatever is left
                os.killpg(child.pid, signal.SIGTERM)
                try:
                    child.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    os.killpg(child.pid, signal.SIGKILL)
                    child.wait()
        except BaseException:
            os.killpg(child.pid, signal.SIGKILL)
            child.wait()
            raise
        secs = time.perf_counter() - t0
        self.record["commands"].append({"command": "train", "argv": cmd[2:], "s": secs,
                                        "budget_s": budget, "paused": rc is None})
        if os.path.exists(log):
            with open(log) as f:
                self.record["train_child"] = json.load(f)
            os.remove(log)
        print(f"[pipeline] train: {secs:.2f} s", flush=True)
        if rc not in (None, 0):
            raise LegError(f"train --cfg {path} exited with {rc}")
        return rc is None

    @staticmethod
    def _watch(child, deadline, ckpt):
        """The child's exit code, or None where it is to be stopped: at the
        deadline, or right after a save of ``ckpt`` (seen by its mtime;
        ``os.replace`` makes a save whole) when the next save, as far
        after it as it was after the one before (or the start), would
        land past the deadline."""
        def mtime():
            try:
                return os.stat(ckpt).st_mtime_ns
            except FileNotFoundError:
                return None

        seen, last = mtime(), time.perf_counter()
        while True:
            rc = child.poll()
            if rc is not None:
                return rc
            now, m = time.perf_counter(), mtime()
            if m != seen:
                seen, gap, last = m, now - last, now
                if now + gap > deadline:
                    print("[pipeline] train: stopped right after a save, the next due "
                          "past the budget", flush=True)
                    return None
            if now >= deadline:
                return None
            time.sleep(min(WATCH_S, deadline - now))

    def extract_stage1(self, rel, resolution, tag=None):
        """``extract-mesh-stage1`` of config ``rel``; records the checkpoint's
        step, the remeshed mesh, the seconds of each part and the counts."""
        path, _ = self.cfg(rel)
        rec = self.cli("extract-mesh-stage1", "--cfg", path, "--resolution", str(resolution),
                       *(["--tag", tag] if tag else []))
        self.record["checkpoints"]["extract-mesh-stage1"] = rec["step"]
        self.record["meshes"]["stage1"] = rec["simplified"]
        self.record["extract_s1"] = {k: v for k, v in rec.items() if k.endswith("_s")}
        self.record["mesh_counts"] = {k: rec[k] for k in ("verts", "tris", "tris_simplified")}
        return rec

    def extract_stage2(self, rel, resolution=256):
        path, _ = self.cfg(rel)
        rec = self.cli("extract-mesh-stage2", "--cfg", path, "--resolution", str(resolution))
        self.record["checkpoints"]["extract-mesh-stage2"] = rec["step"]
        self.record["meshes"]["inner"] = rec["mesh"]
        return rec["mesh"]

    def postprocess_outer(self, mesh):
        out, _ = self.cli("postprocess-outer", "--input", mesh)
        self.record["meshes"]["outer"] = out
        return out

    def eval_geometry(self, key, mesh, gt):
        self.record["chamfer"][key] = self.cli("eval-geometry", "--mesh", mesh, "--gt", gt)

    def eval_images(self, rel, *extra):
        path, cfg = self.cfg(rel)
        rec = self.cli("eval-images", "--cfg", path, "--split", "test", *extra)
        self.record["eval_images"][cfg["name"]] = dict(
            {k: rec[k] for k in ("step", "mean_psnr", "mean_ssim")}, views=len(rec["views"]))

    def eval_shell(self, rel, meta):
        from nunerf_tpu_torch.tools import eval_shell

        path, _ = self.cfg(rel)
        t0 = time.perf_counter()
        self.record["eval_shell"] = eval_shell.main(["--cfg", path, "--meta", meta,
                                                     "--device", self.device])
        secs = time.perf_counter() - t0
        print(f"[pipeline] eval_shell: {secs:.2f} s", flush=True)
        self.record["commands"].append({"command": "eval_shell", "s": secs})

    def stage1_inputs(self, rel):
        """Stop unless the stage-1 mesh and checkpoint that stage-2 config
        ``rel`` names exist; records them and the checkpoint's step, and
        returns the mesh's path."""
        _, cfg = self.cfg(rel)
        for key in ("stage1_mesh_dir", "stage1_ckpt_dir"):
            if not os.path.exists(cfg[key]):
                there = sorted(glob.glob(os.path.join("data", "meshes", "*.ply")))
                raise LegError(
                    f"{rel}: {key} {cfg[key]} does not exist in {os.getcwd()}; meshes "
                    f"there: {there or 'none'}.  Run the stage-1 leg first, or name the "
                    f"mesh and checkpoint it wrote in the config")
        self.record["stage1"] = {"mesh": cfg["stage1_mesh_dir"],
                                 "ckpt": cfg["stage1_ckpt_dir"],
                                 "ckpt_step": _ckpt_step(cfg["stage1_ckpt_dir"])}
        return cfg["stage1_mesh_dir"]


# ---------------------------------------------------------------------------
# the legs of tools/run_nested_pipeline.sh
# ---------------------------------------------------------------------------

def front(leg, budget=None):
    leg.synth("./datasets/nested")
    leg.train(S1_NESTED)
    mesh = leg.extract_stage1(S1_NESTED, 512)["simplified"]
    leg.eval_geometry("outer", mesh, "datasets/nested/gt_outer.npy")
    leg.eval_images(S1_NESTED)


def _stage2(leg, rel, budget, scene, shell=False):
    outer = leg.stage1_inputs(rel)
    leg.train(rel, budget)
    if shell:
        leg.eval_shell(rel, f"datasets/{scene}/meta.json")
    inner = leg.extract_stage2(rel)
    post, _ = leg.cli("postprocess-stage2", "--input", inner, "--outer", outer)
    leg.record["meshes"]["inner_post"] = post
    leg.eval_geometry("inner", post, f"datasets/{scene}/gt_inner.npy")
    leg.eval_images(rel)


def stage2(leg, budget):
    _stage2(leg, S2_NESTED, budget, "nested")


def shell_front(leg, budget=None):
    leg.synth("./datasets/nested_shell", "--shell")
    leg.train(S1_SHELL)
    mesh = leg.extract_stage1(S1_SHELL, 512)["simplified"]
    outer = leg.postprocess_outer(mesh)
    leg.eval_geometry("outer", outer, "datasets/nested_shell/gt_outer.npy")
    leg.eval_images(S1_SHELL)


def shell_stage2(leg, budget):
    _stage2(leg, S2_SHELL, budget, "nested_shell", shell=True)


def shell_stage2b(leg, budget):
    _stage2(leg, S2_SHELL_B, budget, "nested_shell", shell=True)


REAL_SCENE_ARGS = ("--colmap", "--shell", "--n-train", "56")


def real_front(leg, budget=None):
    if not os.path.isdir("datasets/nested_real"):
        leg.synth("./datasets/nested_real", *REAL_SCENE_ARGS)
    path, _ = leg.cfg(S1_REAL)
    leg.train(S1_REAL)
    mesh = leg.extract_stage1(S1_REAL, 384)["simplified"]
    outer = leg.postprocess_outer(mesh)
    leg.eval_geometry("outer", outer, "datasets/nested_real/gt_outer.npy")
    leg.cli("render-mask", "--cfg", path, "--mesh_path", outer)
    leg.cli("mask-erosion", "--cfg", path)


def res1024(leg, budget=None):
    # the masks come from the raw mesh, not the remeshed one
    raw = leg.extract_stage1(S1_NESTED, 1024, tag="r1024")["mesh"]
    leg.record["meshes"]["raw"] = raw
    leg.cli("render-mask", "--cfg", leg.cfg(S1_NESTED)[0], "--mesh_path", raw)


def _boot_tail(leg):
    boot, _ = leg.cfg(S1_BOOT)
    mesh = leg.extract_stage1(S1_BOOT, 384)["simplified"]
    outer = leg.postprocess_outer(mesh)
    leg.eval_geometry("outer", outer, "datasets/nested_real/gt_outer.npy")
    return boot, outer


def real_boot(leg, budget=None):
    real, _ = leg.cfg(S1_REAL)
    prior, _, _ = leg.cli("silhouette-prior", "--cfg", real)
    leg.cli("render-mask", "--cfg", real, "--mesh_path", prior)
    leg.train(S1_BOOT, budget)
    if leg.paused:
        print("[pipeline] real_boot: paused; run the leg again to resume", flush=True)
        return
    boot, outer = _boot_tail(leg)
    leg.cli("render-mask", "--cfg", boot, "--mesh_path", outer)
    leg.cli("mask-erosion", "--cfg", boot)
    leg.eval_images(S1_BOOT, "--ckpt", "data/model/nested_real_boot/model.ckpt")


def real_boot_ext(leg, budget=None):
    leg.train(S1_BOOT)
    _boot_tail(leg)
    leg.eval_images(S1_BOOT, "--ckpt", "data/model/nested_real_boot/model.ckpt")


def real_stage2(leg, budget):
    _stage2(leg, S2_REAL, budget, "nested_real", shell=True)


def real_stage2_fresh(leg, budget):
    # from scratch (the script's rm -rf of the run's model directory)
    _, cfg = leg.cfg(S2_REAL)
    shutil.rmtree(os.path.join(cfg.get("model_dir", "data/model"), cfg["name"]),
                  ignore_errors=True)
    real_stage2(leg, budget)


LEGS = {"front": front, "stage2": stage2, "shell_front": shell_front,
        "shell_stage2": shell_stage2, "shell_stage2b": shell_stage2b,
        "real_front": real_front, "res1024": res1024, "real_boot": real_boot,
        "real_boot_ext": real_boot_ext, "real_stage2": real_stage2,
        "real_stage2_fresh": real_stage2_fresh}
BUDGET_LEGS = ("stage2", "shell_stage2", "shell_stage2b", "real_stage2", "real_stage2_fresh")
# legs that take a budget where one is given (the script's run theirs whole)
PAUSE_LEGS = ("real_boot",)


def boot_overrides(workdir):
    """``cfg_overrides`` that point ``real_stage2`` at the outer mesh that
    ``real_boot`` wrote in ``workdir`` (its record's): the stage-2 config
    names ``nested_real_boot-20000_simplified_outer.ply``, while the boot
    config's 32,000 steps write ``-32000``.  The checkpoint it names,
    ``data/model/nested_real_boot/model.ckpt``, is the one the boot wrote."""
    path = os.path.join(workdir, "runs", "leg_real_boot.json")
    if not os.path.exists(path):
        raise LegError(f"{path} does not exist: run real_boot in {workdir} first")
    with open(path) as f:
        rec = json.load(f)
    if "outer" not in rec["meshes"]:
        raise LegError(f"real_boot in {workdir} was paused before its mesh: run it again")
    return {S2_REAL: {"stage1_mesh_dir": "./" + rec["meshes"]["outer"]}}


def run_leg(leg, workdir=DEFAULT_WORKDIR, budget=None, device="cuda", cfg_overrides=None,
            extra_args=None, keep=()):
    """Run the leg ``leg`` in ``workdir`` (made if missing; never the
    repository's root); returns its record, which it also prints as the
    last line and writes to ``<workdir>/runs/leg_<leg>.json``.  ``keep``:
    the steps at which its ``train`` also writes the parameters alone."""
    if leg not in LEGS:
        raise ValueError(f"unknown leg {leg!r}; legs: {', '.join(LEGS)}")
    if leg in BUDGET_LEGS and budget is None:
        raise ValueError(f"leg {leg} takes a budget in seconds")
    if budget is not None and leg not in BUDGET_LEGS + PAUSE_LEGS:
        raise ValueError(f"leg {leg} takes no budget")
    workdir = os.path.abspath(workdir)
    if os.path.realpath(workdir) == os.path.realpath(REPO):
        raise ValueError("the pipeline's working directory must not be the repository's "
                         "root: its data/ may hold JAX checkpoints")
    os.makedirs(workdir, exist_ok=True)
    prev = os.getcwd()
    os.chdir(workdir)
    try:
        state = _Leg(leg, device, cfg_overrides, extra_args, keep)
        t0 = time.perf_counter()
        LEGS[leg](state, budget)
        state.record["seconds"] = time.perf_counter() - t0
        os.makedirs("runs", exist_ok=True)
        with open(os.path.join("runs", f"leg_{leg}.json"), "w") as f:
            json.dump(state.record, f, indent=1)
    finally:
        os.chdir(prev)
    print(json.dumps(state.record), flush=True)
    return state.record


def main(argv=None):
    p = argparse.ArgumentParser(prog="nunerf_tpu_torch.pipeline",
                                description="one leg of the nested-glass pipeline")
    p.add_argument("leg", choices=sorted(LEGS))
    p.add_argument("budget", nargs="?", type=float, default=None,
                   help="seconds of training for the legs that take a budget")
    p.add_argument("--workdir", default=DEFAULT_WORKDIR)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--keep", default="",
                   help="steps, comma-separated, at which train also writes the parameters "
                        "alone to data/model/<name>/model_<step>.ckpt.gz")
    args = p.parse_args(argv)
    if args.leg in BUDGET_LEGS and args.budget is None:
        p.error(f"leg {args.leg} takes a budget in seconds")
    try:
        keep = [int(k) for k in args.keep.split(",") if k.strip()]
        return run_leg(args.leg, args.workdir, args.budget, args.device, keep=keep)
    except LegError as e:
        print(f"pipeline: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
