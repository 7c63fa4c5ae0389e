#!/usr/bin/env bash
# The port on the GPU: MarT/scripts/run_pretrain_mkgformer.sh recipe parity (bsz 64, seq 96)
python -m mkg_analogy_tpu_torch.cli.main \
    --model_class MKGformerKGC --pretrain 1 --batch_size 64 --lr 5e-5 \
    --max_epochs 30 --max_seq_length 96 --eval_batch_size 128 \
    --data_dir dataset/MARS --pretrain_path dataset/MarKG "$@"
