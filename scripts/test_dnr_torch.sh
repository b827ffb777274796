#!/bin/bash
# rnr_tpu_torch's copy of scripts/test_dnr.sh: the same flags, run by the
# PyTorch + CUDA port on the card.
DATA_ROOT=${1:-./data/material_sphere/test_seq/spiral_step720}
CKPT_DIR=${2:?usage: test_dnr_torch.sh DATA_ROOT CHECKPOINT_DIR}
python -m rnr_tpu_torch.drivers.test_dnr \
    --data_root $DATA_ROOT \
    --checkpoint_dir $CKPT_DIR \
    --img_size 512
