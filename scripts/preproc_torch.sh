#!/bin/bash
# rnr_tpu_torch's copy of scripts/preproc.sh: the same flags, run by the
# PyTorch + CUDA port on the card.
# G-buffer precomputation (counterpart of reference preproc.sh):
# full pass on the high mesh, mesh-related pass on the low mesh.
DATA_ROOT=${1:-./data/material_sphere}
IMG_SIZE=${2:-512}
python -m rnr_tpu_torch.drivers.precompute --data_root $DATA_ROOT --obj_fp _/mesh.obj --img_size $IMG_SIZE
python -m rnr_tpu_torch.drivers.precompute --data_root $DATA_ROOT --obj_fp _/mesh_7500v.obj --img_size $IMG_SIZE --only_mesh_related true
python -m rnr_tpu_torch.drivers.stitch_lp --data_root $DATA_ROOT --sampling_pattern skipinv_10
