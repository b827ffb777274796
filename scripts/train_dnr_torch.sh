#!/bin/bash
# rnr_tpu_torch's copy of scripts/train_dnr.sh: the same flags, run by the
# PyTorch + CUDA port on the card.
DATA_ROOT=${1:-./data/material_sphere}
python -m rnr_tpu_torch.drivers.train_dnr \
    --data_root $DATA_ROOT \
    --img_size 512 \
    --texture_num_ch 30 \
    --sampling_pattern skipinv_10 \
    --sampling_pattern_val skip_10
