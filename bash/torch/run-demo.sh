#!/usr/bin/env bash
# Demo: train male-3-casual then animate with the AIST dance sequence, on
# the GPU through the PyTorch port (bash/run-demo.sh's commands)
set -e
SUBJECT=${1:-male-3-casual}
python -m instantavatar_torch.cli.train --config-name SNARF_NGP dataset=peoplesnapshot/$SUBJECT
python -m instantavatar_torch.cli.animate --config-name SNARF_NGP dataset=peoplesnapshot/$SUBJECT
