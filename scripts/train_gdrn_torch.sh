#!/usr/bin/env bash
# Train entrypoint of the PyTorch port (the counterpart of train_gdrn.sh):
# trains, then tests, on the CUDA card; under torchrun, one process a card.
# Usage: ./scripts/train_gdrn_torch.sh <config.py> [extra opts...]
set -euo pipefail
CFG=$1
shift || true
exec python -m gdrnet_tpu_torch.engine.train --config-file "$CFG" "$@"
