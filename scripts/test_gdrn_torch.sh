#!/usr/bin/env bash
# Eval entrypoint of the PyTorch port (the counterpart of test_gdrn.sh).
# <ckpt> is a checkpoint directory or a .pth file.
# Usage: ./scripts/test_gdrn_torch.sh <config.py> <ckpt> [extra opts...]
set -euo pipefail
CFG=$1
CKPT=$2
shift 2 || true
exec python -m gdrnet_tpu_torch.engine.train --config-file "$CFG" --eval-only \
    "MODEL.WEIGHTS=$CKPT" "$@"
