#!/usr/bin/env bash
# The port on the GPU: MarT/scripts/run_finetune_vilt.sh recipe parity (lr 4e-5, alpha 0.3)
python -m mkg_analogy_tpu_torch.cli.main \
    --model_class ViltKGC --batch_size 32 --lr 4e-5 --alpha 0.3 \
    --max_epochs 15 --max_seq_length 128 --eval_batch_size 128 \
    --data_dir dataset/MARS --pretrain_path dataset/MarKG "$@"
