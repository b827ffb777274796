#!/bin/bash
# rnr_tpu_torch's copy of scripts/train_rnr.sh: the same flags, run by the
# PyTorch + CUDA port on the card.
# Canonical RNR training config (counterpart of reference train_rnr.sh).
DATA_ROOT=${1:-./data/material_sphere}
python -m rnr_tpu_torch.drivers.train_rnr \
    --data_root $DATA_ROOT \
    --img_size 512 \
    --sampling_pattern skipinv_10 \
    --sampling_pattern_val skip_10 \
    --lighting_idx 0 \
    --lighting_relight_idx 1 \
    --lp_dir _/light_probe \
    --val_freq 100 \
    --lr 0.001
