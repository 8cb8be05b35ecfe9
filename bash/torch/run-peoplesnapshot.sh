#!/usr/bin/env bash
# 4-subject PeopleSnapshot benchmark: 50 train epochs + 20 refine epochs
# per subject, on the GPU through the PyTorch port
# (bash/run-peoplesnapshot.sh's commands)
set -e
for SUBJECT in male-3-casual male-4-casual female-3-casual female-4-casual; do
    python -m instantavatar_torch.cli.train --config-name SNARF_NGP \
        dataset=peoplesnapshot/$SUBJECT train.max_epochs=50
    python -m instantavatar_torch.cli.eval --config-name SNARF_NGP_refine \
        dataset=peoplesnapshot/$SUBJECT
done
