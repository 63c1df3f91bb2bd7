#!/usr/bin/env bash
# ChunkFormer speech classification recipe on chunkformer_tpu_torch
# (PyTorch/CUDA): the twin of run.sh, with the same stages, variables and
# defaults, plus device (cuda, or cpu), passed as --device to every CLI that
# takes one. Data lists are JSONL lines with "key"/"wav" plus one
# "label_<task>" integer column per task (e.g. label_gender, label_emotion).
#   bash run_torch.sh                    # on the card
#   device=cpu bash run_torch.sh         # on the CPU
set -euo pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-5}
data=${data:-data}
exp=${exp:-exp/chunkformer-classification}
config=${config:-conf/multi_task.yaml}
train_tsv=${train_tsv:-$data/train.tsv}
avg_num=${avg_num:-5}
device=${device:-cuda}

cd "$(dirname "$0")"
export PYTHONPATH=$(cd ../.. && pwd):${PYTHONPATH:-}

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  echo "stage 0: tsv -> data lists"
  python ../../tools/tsv_to_list.py "$train_tsv" "$data/all.list"
  python ../../tools/split_train_test.py "$data/all.list" \
    --train "$data/train.list" --dev "$data/dev.list" --test "$data/internal_test.list"
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  echo "stage 1: global CMVN stats"
  mkdir -p "$data/train"
  python ../../tools/compute_torch_cmvn_stats.py \
    --in_list "$data/train.list" --out_cmvn "$data/train/global_cmvn"
fi

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ]; then
  echo "stage 2: label statistics + validation"
  python ../../tools/compute_label_stats.py \
    "$data/train.list" --out "$data/train/label_stats.json"
fi

if [ ${stage} -le 3 ] && [ ${stop_stage} -ge 3 ]; then
  echo "stage 3: train multi-task classification heads"
  python -m chunkformer_tpu_torch.bin.train \
    --config "$config" \
    --train_data "$data/train.list" --cv_data "$data/dev.list" \
    --model_dir "$exp" \
    --override_config "cmvn_conf.cmvn_file $data/train/global_cmvn" \
    --device "$device"
fi

if [ ${stage} -le 4 ] && [ ${stop_stage} -ge 4 ]; then
  echo "stage 4: export for inference"
  python - "$exp" "$avg_num" <<'EOF'
import os, sys, yaml
from chunkformer_tpu_torch.export import export_model_dir
from chunkformer_tpu_torch.train.checkpoint import list_checkpoints, load_checkpoint
exp, avg = sys.argv[1], sys.argv[2]
# the average where one was made, else the last epoch
tag = f"avg_{avg}" if os.path.exists(f"{exp}/avg_{avg}.pt") else \
    [c["tag"] for c in list_checkpoints(exp) if c["tag"].startswith("epoch_")][-1]
state, _, _, _ = load_checkpoint(exp, tag)
with open(f"{exp}/train.yaml") as f:
    cfg = yaml.safe_load(f)
tasks = cfg.get("model_conf", {}).get("tasks", {})
# each class named by its id, as a list indexed by the id: the form the
# export's readers index (run.sh's {name: id} dicts raise KeyError there)
label_mapping = {t: [str(i) for i in range(n)] for t, n in tasks.items()}
export_model_dir(f"{exp}/export", cfg, state, label_mapping=label_mapping)
print("exported", tag, "to", f"{exp}/export")
EOF
fi

if [ ${stage} -le 5 ] && [ ${stop_stage} -ge 5 ]; then
  echo "stage 5: classify + metrics"
  python -m chunkformer_tpu_torch.bin.classify \
    --model_checkpoint "$exp/export" \
    --test_data "$data/internal_test.list" \
    --output_file "$exp/predictions.tsv" --format tsv \
    --device "$device"
  python ../../tools/compute_classification_metrics.py \
    --hyp "$exp/predictions.tsv" \
    --ref "$data/internal_test.list" || true
fi
