#!/usr/bin/env bash
# The port on the GPU: IKRL recipe parity (IKRL.py:990-1046): 2000 epochs, neg 25+25, margin 5
python -m mkg_analogy_tpu_torch.cli.ikrl --model transe --train_times 2000 \
    --nbatches 100 --neg_ent 25 --neg_rel 25 --margin 5.0 --alpha 1.0 \
    --data_dir dataset/MARS --pretrain_path dataset/MarKG "$@"
python -m mkg_analogy_tpu_torch.cli.ikrl --model transe --finetune \
    --ckpt output/ikrl/ckpt --data_dir dataset/MARS --pretrain_path dataset/MarKG "$@"
