#!/usr/bin/env bash
# The port on the GPU: the JAX package's extension (no reference counterpart): MarKG pseudo-analogy
# pretraining in the FINETUNE prompt layout — pairs of same-relation triples
# rendered as (h,t)::(h',[MASK]->t'). Fixes the reference recipe's zero
# format transfer (finetune from the triple-format pretrain starts at
# uniform CE; from this one it starts at dev MRR ~0.11 after 1 epoch —
# RESULTS.md "Pseudo-analogy pretrain A/B"). seq 128 to match finetune.
# Chain into finetune with:  run_finetune_mkgformer.sh --checkpoint <out>/ckpt
python -m mkg_analogy_tpu_torch.cli.main \
    --model_class MKGformerKGC --pretrain 1 --pretrain_format analogy \
    --batch_size 64 --lr 5e-5 \
    --max_epochs 30 --max_seq_length 128 --eval_batch_size 128 \
    --data_dir dataset/MARS --pretrain_path dataset/MarKG "$@"
