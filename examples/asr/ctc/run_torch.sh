#!/usr/bin/env bash
# ChunkFormer CTC/AED training recipe on chunkformer_tpu_torch (PyTorch/CUDA):
# the twin of run.sh, with the same stages, variables and defaults, plus
# device (cuda, or cpu), passed as --device to every CLI that takes one.
#   bash run_torch.sh                    # on the card
#   device=cpu bash run_torch.sh         # on the CPU
set -euo pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-6}
data=${data:-data}
exp=${exp:-exp/chunkformer-ctc-small}
config=${config:-conf/chunkformer-ctc-small.yaml}
train_tsv=${train_tsv:-$data/train.tsv}
test_tsv=${test_tsv:-$data/test.tsv}
avg_num=${avg_num:-5}
# vocabulary: bpemode=char (default) builds char units; bpemode=bpe|unigram
# trains a sentencepiece model of nbpe pieces (reference run.sh:96-113)
bpemode=${bpemode:-char}
nbpe=${nbpe:-5000}
device=${device:-cuda}

cd "$(dirname "$0")"
export PYTHONPATH=$(cd ../../.. && pwd):${PYTHONPATH:-}

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  echo "stage 0: tsv -> data lists"
  python -m tools.tsv_to_list "$train_tsv" "$data/all.list" || \
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

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ] && [ "$bpemode" != "char" ]; then
  echo "stage 2: build vocab (${bpemode}${nbpe} sentencepiece units)"
  mkdir -p "$data/lang_char"
  dict=$data/lang_char/units.txt
  bpemodel=$data/lang_char/train_${bpemode}${nbpe}
  # transcripts only (tsv col 3) feed the spm trainer
  cut -f 3- "$data/train.list" > "$data/lang_char/input.txt"
  python ../../../tools/spm_train.py --input="$data/lang_char/input.txt" \
    --vocab_size=${nbpe} --model_type=${bpemode} --model_prefix="$bpemodel" \
    --input_sentence_size=100000000
  {
    echo "<blank> 0"; echo "<unk> 1"
    python ../../../tools/spm_encode.py --model="$bpemodel.model" \
      --output_format=piece < "$data/lang_char/input.txt" \
      | tr ' ' '\n' | sort -u | grep -v '^$' | awk '{print $0 " " NR+1}'
  } > "$dict"
  n=$(wc -l < "$dict")
  echo "<sos/eos> $n" >> "$dict"
  echo "built $dict ($(wc -l < "$dict") entries); pass
  --override_config \"tokenizer bpe\"
  --override_config \"tokenizer_conf.bpe_model $bpemodel.model\" at stage 3"
fi

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ] && [ "$bpemode" = "char" ]; then
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
  echo "stage 3: train"
  if [ "$bpemode" = "char" ]; then
    tok_overrides=(--override_config "tokenizer char")
  else
    tok_overrides=(--override_config "tokenizer bpe"
                   --override_config "tokenizer_conf.bpe_model $data/lang_char/train_${bpemode}${nbpe}.model")
  fi
  python -m chunkformer_tpu_torch.bin.train \
    --config "$config" \
    --train_data "$data/train.list" --cv_data "$data/dev.list" \
    --model_dir "$exp" \
    "${tok_overrides[@]}" \
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
  echo "stage 6: recognize + WER"
  python -m chunkformer_tpu_torch.bin.recognize \
    --model_checkpoint "$exp/export" \
    --test_data "$data/internal_test.list" \
    --modes ctc_greedy_search attention_rescoring \
    --result_dir "$exp/results" \
    --device "$device"
fi
