#!/usr/bin/env bash
# Calibration: capture activations -> histograms + layer inputs
# (parity with reference scripts/grab_acts.bash)
set -euo pipefail
MODEL=${1:?usage: calibrate.sh MODEL OUTPUT_PATH [CHECKPOINT]}
OUT=${2:?}
CKPT=${3:-}
ARGS=(--model "$MODEL" --output-path "$OUT" --batch 10 --seq-len 2048)
if [[ -n "$CKPT" ]]; then ARGS+=(--checkpoint "$CKPT"); else ARGS+=(--random-init); fi
python -m teal_jax.cli calibrate "${ARGS[@]}"
