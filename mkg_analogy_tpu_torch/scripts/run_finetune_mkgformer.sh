#!/usr/bin/env bash
# The port on the GPU: MarT/scripts/run_finetune_mkgformer.sh recipe parity (lr 5e-5, alpha 0.43)
python -m mkg_analogy_tpu_torch.cli.main \
    --model_class MKGformerKGC --batch_size 32 --lr 5e-5 --alpha 0.43 \
    --max_epochs 15 --max_seq_length 128 --eval_batch_size 128 \
    --check_val_every_n_epoch 1 --accumulate_grad_batches 1 \
    --data_dir dataset/MARS --pretrain_path dataset/MarKG "$@"
