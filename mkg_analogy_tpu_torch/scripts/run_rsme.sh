#!/usr/bin/env bash
# The port on the GPU: RSME run.sh + run_finetune.sh recipe parity (ComplEx lr 1e-2, 300 epochs)
python -m mkg_analogy_tpu_torch.cli.rsme --model ComplEx --rank 1000 \
    --learning_rate 1e-2 --max_epochs 300 --batch_size 1000 --valid 3 \
    --data_dir dataset/MARS --pretrain_path dataset/MarKG "$@"
python -m mkg_analogy_tpu_torch.cli.rsme --model Analogy --finetune \
    --ckpt output/rsme/ckpt --data_dir dataset/MARS --pretrain_path dataset/MarKG "$@"
