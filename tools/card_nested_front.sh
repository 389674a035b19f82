#!/bin/bash
# The nested front leg through the port at its full schedule on one card,
# then a copy in OUT of what the zero-thickness stage2 leg needs to start in
# another working directory: the stage-1 model_best.ckpt (its Adam state
# dropped), the simplified mesh it traces, the dataset and the configs, with
# the leg's record and train log.  The last model.ckpt, which the res1024 leg
# extracts, goes with them, its Adam state dropped too.
#
#   bash tools/card_nested_front.sh WORKDIR OUT
set -u
W=${1:?workdir}
OUT=${2:?output directory}
mkdir -p "$OUT/data/model/nested" "$OUT/data/meshes" "$OUT/runs"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
t0=$(date +%s)
python -m nunerf_tpu_torch.pipeline front --workdir "$W" > "$OUT/front.log" 2>&1
echo "leg rc=$? in $(( $(date +%s) - t0 )) s"
tail -c 6000 "$OUT/front.log"
cp "$W/runs/leg_front.json" "$OUT/runs/"
cp "$W/data/model/nested/train_log.jsonl" "$OUT/data/model/nested/"
python - "$W" "$OUT" <<'PY'
import pickle, sys
w, out = sys.argv[1:]
for name in ("model_best", "model"):
    blob = pickle.load(open(f"{w}/data/model/nested/{name}.ckpt", "rb"))
    print(name, "step", blob["step"], "best_para", blob["best_para"])
    blob["opt_state"] = None
    pickle.dump(blob, open(f"{out}/data/model/nested/{name}.ckpt", "wb"))
PY
cp "$W"/data/meshes/nested-*_simplified.ply "$OUT/data/meshes/"
cp -r "$W/configs" "$W/datasets" "$OUT/"
[ -d "$W/data/eval" ] && cp -r "$W/data/eval" "$OUT/data/"
du -sh "$OUT"
