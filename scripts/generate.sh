#!/usr/bin/env bash
# Sparse generation benchmark run (parity with gpt-fast/scripts/run.sh)
set -euo pipefail
MODEL=${1:?usage: generate.sh MODEL [SPARSITY] [CHECKPOINT]}
S=${2:-0.5}
CKPT=${3:-}
ARGS=(--model "$MODEL" --sparsity "$S" --max-new-tokens 200 --num-samples 5)
if [[ -n "$CKPT" ]]; then ARGS+=(--checkpoint "$CKPT"); else ARGS+=(--random-init); fi
python -m teal_jax.cli generate "${ARGS[@]}"
