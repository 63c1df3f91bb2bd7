#!/usr/bin/env bash
# ChunkFormer RNN-T training recipe on chunkformer_tpu_torch (PyTorch/CUDA):
# the twin of run.sh, with the same stages, variables and defaults, plus
# device (cuda, or cpu), passed as --device to every CLI that takes one.
#   bash run_torch.sh                    # on the card
#   device=cpu bash run_torch.sh         # on the CPU
set -euo pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-6}
data=${data:-data}
exp=${exp:-exp/chunkformer-rnnt-small}
config=${config:-conf/chunkformer-rnnt-small.yaml}
train_tsv=${train_tsv:-$data/train.tsv}
test_tsv=${test_tsv:-$data/test.tsv}
avg_num=${avg_num:-5}
device=${device:-cuda}

cd "$(dirname "$0")"
export PYTHONPATH=$(cd ../../.. && pwd):${PYTHONPATH:-}

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  echo "stage 0: tsv -> data lists"
  python ../../../tools/tsv_to_list.py "$train_tsv" "$data/all.list"
  python ../../../tools/split_train_test.py "$data/all.list" \
    --train "$data/train.list" --dev "$data/dev.list" --test "$data/internal_test.list"
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  echo "stage 1: global CMVN stats"
  mkdir -p "$data/train"
  python ../../../tools/compute_torch_cmvn_stats.py \
    --in_list "$data/train.list" --out_cmvn "$data/train/global_cmvn"
fi

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ]; then
  echo "stage 2: build vocab (char units from transcripts)"
  mkdir -p "$data/lang_char"
  python - "$data/train.list" "$data/lang_char/units.txt" <<'EOF'
import sys
chars = set()
for line in open(sys.argv[1], encoding="utf-8"):
    parts = line.rstrip("\n").split("\t")
    if len(parts) >= 3:
        for ch in parts[2]:
            chars.add("▁" if ch == " " else ch)
with open(sys.argv[2], "w", encoding="utf-8") as f:
    f.write("<blank> 0\n<unk> 1\n")
    for i, ch in enumerate(sorted(chars), start=2):
        f.write(f"{ch} {i}\n")
    f.write(f"<sos/eos> {len(chars) + 2}\n")
EOF
fi

if [ ${stage} -le 3 ] && [ ${stop_stage} -ge 3 ]; then
  echo "stage 3: train (loss = w_t*RNNT + w_ctc*CTC + w_att*AED)"
  python -m chunkformer_tpu_torch.bin.train \
    --config "$config" \
    --train_data "$data/train.list" --cv_data "$data/dev.list" \
    --model_dir "$exp" \
    --override_config "tokenizer char" \
    --override_config "tokenizer_conf.symbol_table_path $data/lang_char/units.txt" \
    --override_config "cmvn_conf.cmvn_file $data/train/global_cmvn" \
    --device "$device"
fi

if [ ${stage} -le 4 ] && [ ${stop_stage} -ge 4 ]; then
  echo "stage 4: average checkpoints"
  python -m chunkformer_tpu_torch.bin.average_model \
    --src_path "$exp" --dst_tag avg_${avg_num} --num ${avg_num} --mode best
fi

if [ ${stage} -le 5 ] && [ ${stop_stage} -ge 5 ]; then
  echo "stage 5: export for inference"
  python - "$exp" "$data/lang_char/units.txt" "$avg_num" <<'EOF'
import sys, yaml
from chunkformer_tpu_torch.api import read_symbol_table
from chunkformer_tpu_torch.export import export_model_dir
from chunkformer_tpu_torch.train.checkpoint import load_checkpoint
exp, units, avg = sys.argv[1], sys.argv[2], sys.argv[3]
state, _, _, _ = load_checkpoint(exp, f"avg_{avg}")
with open(f"{exp}/train.yaml") as f:
    cfg = yaml.safe_load(f)
export_model_dir(f"{exp}/export", cfg, state, read_symbol_table(units))
print("exported", f"avg_{avg}", "to", f"{exp}/export")
EOF
fi

if [ ${stage} -le 6 ] && [ ${stop_stage} -ge 6 ]; then
  echo "stage 6: recognize + WER (greedy / beam / beam+attn rescoring)"
  python -m chunkformer_tpu_torch.bin.recognize \
    --model_checkpoint "$exp/export" \
    --test_data "$data/internal_test.list" \
    --modes rnnt_greedy_search rnnt_beam_search rnnt_beam_attn_rescoring \
    --result_dir "$exp/results" \
    --device "$device"
fi
