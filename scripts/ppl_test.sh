#!/usr/bin/env bash
# Dense vs sparse perplexity (parity with reference scripts/ppl_test.bash)
set -euo pipefail
MODEL=${1:?usage: ppl_test.sh MODEL HIST_PATH SPARSITY [CHECKPOINT]}
HIST=${2:?}
S=${3:?}
CKPT=${4:-}
ARGS=(--model "$MODEL" --hist-path "$HIST" --sparsity "$S")
if [[ -n "$CKPT" ]]; then ARGS+=(--checkpoint "$CKPT"); else ARGS+=(--random-init); fi
python -m teal_jax.cli ppl "${ARGS[@]}"
