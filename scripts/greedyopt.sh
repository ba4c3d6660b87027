#!/usr/bin/env bash
# Greedy per-layer sparsity allocation over a calibration dir
# (parity with reference scripts/greedyopt.bash; step 0.025 as upstream)
set -euo pipefail
MODEL=${1:?usage: greedyopt.sh MODEL TEAL_PATH [CHECKPOINT]}
TEAL=${2:?}
CKPT=${3:-}
ARGS=(--model "$MODEL" --teal-path "$TEAL" --base-step-size 0.025 --target-sparsity 0.9)
if [[ -n "$CKPT" ]]; then ARGS+=(--checkpoint "$CKPT"); else ARGS+=(--random-init); fi
python -m teal_jax.cli greedyopt "${ARGS[@]}"
