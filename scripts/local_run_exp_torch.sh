#!/usr/bin/env bash
# Local single-host launch of the PyTorch port: the counterpart of
# scripts/local_run_exp.sh. One process on the card is the whole topology
# (no Redis fabric to pre-start); it runs until the experiment's iterations
# are done (main train's --iterations, default 1), logging to <log_dir> with
# a snapshot every 10 generations. It needs a CUDA device: without one,
# main train stops with "no CUDA device" and runs nothing on the CPU.
#
# Usage: ./scripts/local_run_exp_torch.sh <algo> <exp_file.json> [log_dir]
set -euo pipefail
ALGO=${1:?algo (es|ga|rs|nses)}
EXP=${2:?experiment json}
LOG=${3:-logs/$(basename "$EXP" .json)}
exec python -m deep_neuroevolution_torch.main train \
    --algo "$ALGO" --exp_file "$EXP" --log_dir "$LOG" --snapshot_freq 10
