#!/usr/bin/env bash
# Multi-host GPU launch of the PyTorch port: the counterpart of
# scripts/pod_run.sh. Run this same command on EVERY host (scripts/launch_gpu.py
# start does); torchrun starts one rank per card, and the ranks of all hosts
# meet at host 0. Set on each host:
#   NNODES=<hosts> NODE_RANK=<this host, 0-based> MASTER_ADDR=<host 0>
#   [MASTER_PORT=29500] [NPROC_PER_NODE=<cards a host; default: all it has>]
# One host with every card needs none of them.
#
# Usage: ./scripts/pod_run_torch.sh <algo> <exp_file.json> [log_dir]
set -euo pipefail
ALGO=${1:?algo}
EXP=${2:?experiment json}
LOG=${3:-logs/$(basename "$EXP" .json)}
NNODES=${NNODES:-1}
NODE_RANK=${NODE_RANK:-0}
MASTER_ADDR=${MASTER_ADDR:-localhost}
MASTER_PORT=${MASTER_PORT:-29500}
NPROC_PER_NODE=${NPROC_PER_NODE:-$(nvidia-smi --list-gpus | wc -l)}
exec torchrun --nnodes "$NNODES" --node_rank "$NODE_RANK" --nproc_per_node "$NPROC_PER_NODE" \
    --master_addr "$MASTER_ADDR" --master_port "$MASTER_PORT" \
    -m deep_neuroevolution_torch.main train \
    --algo "$ALGO" --exp_file "$EXP" --log_dir "$LOG" --snapshot_freq 10
