#!/usr/bin/env bash
# The port on the GPU: MarT/scripts/run_finetune_vilbert.sh recipe parity (lr 5e-5, bsz 64)
python -m mkg_analogy_tpu_torch.cli.main \
    --model_class VilBertKGC --batch_size 64 --lr 5e-5 --alpha 0.43 \
    --max_epochs 15 --max_seq_length 128 --eval_batch_size 128 \
    --data_dir dataset/MARS --pretrain_path dataset/MarKG "$@"
