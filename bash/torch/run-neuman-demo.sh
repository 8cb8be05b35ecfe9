#!/usr/bin/env bash
# In-the-wild demo: fit SMPL from scratch with the NN deformer, train the
# avatar, then render novel views + animation, on the GPU through the
# PyTorch port (bash/run-neuman-demo.sh's commands)
set -e
SEQUENCE=${1:-video}
python -m instantavatar_torch.cli.fit --config-name SNARF_NGP_fitting dataset=custom/$SEQUENCE \
    deformer=smpl train.max_epochs=200
python -m instantavatar_torch.cli.train --config-name demo dataset=custom/$SEQUENCE \
    train.max_epochs=200 sampler.dilate=8
python -m instantavatar_torch.cli.novel_view --config-name demo dataset=custom/$SEQUENCE
python -m instantavatar_torch.cli.animate --config-name demo dataset=custom/$SEQUENCE
