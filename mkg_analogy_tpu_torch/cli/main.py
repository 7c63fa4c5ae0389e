"""CLI entry point of the PyTorch port: the flag surface of
``mkg_analogy_tpu/cli/main.py`` (MarT/main.py:20-60 parity) plus
``--device``.

Ported so far: ``--only_test`` evaluation of ``MKGformerKGC``, e.g.

  python -m mkg_analogy_tpu_torch.cli.main --only_test \\
      --model_class MKGformerKGC --eval_batch_size 128 --max_seq_length 128 \\
      --data_dir dataset/MARS --pretrain_path dataset/MarKG

It runs on CUDA unless ``--device cpu`` is given; with ``--device cuda`` and
no GPU it raises instead of falling back to the CPU. On CUDA every attention
call goes through the hand-written kernel (``--fused_attention 1``, the
default); ``--fused_attention 0`` runs its plain PyTorch version instead.
Training, checkpoints, the flash kernel, parallelism and the other model
families raise until their slices land. Flags that only steer training
(optimizer, schedule, XLA and PRNG knobs of the JAX package) are accepted
for script parity and do not change an evaluation.
"""

from __future__ import annotations

import argparse
import os

import torch


def _int_or_float(token: str):
    """pl.Trainer disambiguates limit_train_batches by Python type: int =
    batch count, float = epoch fraction."""
    if any(c in token for c in ".eE"):
        return float(token)
    return int(token)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="MKG analogy framework, PyTorch port (MarT pipeline)"
    )
    # Basic (main.py:29-41)
    p.add_argument("--wandb", action="store_true", default=False,
                   help="also write a wandb-offline-format run directory "
                        "under log_dir/wandb")
    p.add_argument("--litmodel_class", type=str, default="TransformerLitModel")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--data_class", type=str, default="KGC")
    p.add_argument("--chunk", type=str, default="")
    p.add_argument("--model_class", type=str, default="MKGformerKGC")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="not supported yet: an orbax checkpoint needs JAX to "
                        "read (convert with models/convert.py)")
    p.add_argument("--visual_model_path", type=str, default=None)
    p.add_argument("--pretrain_path", type=str, default=None)
    p.add_argument("--alpha", type=float, default=0.4,
                   help="weight of the relaxation (similarity) loss")
    p.add_argument("--only_test", action="store_true", default=False)
    p.add_argument("--export_torch", type=str, default=None)
    # Trainer args (pl.Trainer surface used by the run scripts)
    p.add_argument("--max_epochs", type=int, default=15)
    p.add_argument("--gpus", type=str, default=None,
                   help="accepted for script parity; see --device")
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--track_grad_norm", type=int, default=-1)
    p.add_argument("--check_val_every_n_epoch", type=int, default=1)
    p.add_argument("--precision", type=int, default=32,
                   help="accepted for parity; --dtype sets the compute dtype")
    p.add_argument("--num_workers", type=int, default=4,
                   help="accepted for parity; input pipeline is vectorized")
    p.add_argument("--limit_train_batches", type=_int_or_float, default=None)
    # Data args (data_module.py:253-262)
    p.add_argument("--model_name_or_path", type=str, default="wordpiece-kg",
                   help="path to a vocab.txt/tokenizer dir, or 'wordpiece-kg' "
                        "to train an offline WordPiece vocab from the corpus")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--warm_up_radio", type=float, default=0.1)
    p.add_argument("--eval_batch_size", type=int, default=128)
    p.add_argument("--overwrite_cache", action="store_true", default=False)
    p.add_argument("--batch_size", type=int, default=32)
    # Model args (models/model.py)
    p.add_argument("--pretrain", type=int, default=0)
    p.add_argument("--pretrain_format", type=str, default="triple",
                   choices=["triple", "analogy", "mixed"])
    p.add_argument("--vilbert_ablate_img_to_txt", type=int, default=0)
    # LitModel args (lit_models/base.py + transformer.py)
    p.add_argument("--optimizer", type=str, default="AdamW")
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--label_smoothing", type=float, default=0.1)
    p.add_argument("--bce", type=int, default=0)
    # extensions of the JAX package
    p.add_argument("--dp", type=int, default=None, help="data-parallel size")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel size")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--log_dir", type=str, default="training/logs")
    p.add_argument("--cache_dir", type=str, default=".cache/mkg")
    p.add_argument("--image_features", type=str, default=None,
                   help="path to a .npy pixel feature cache, or 'synthetic' / "
                        "'synthetic_noise' (seeded tables built on the device "
                        "by torch.Generator; their values differ from the JAX "
                        "package's tables of the same name)")
    p.add_argument("--text_vocab_size", type=int, default=8192)
    # architecture overrides (small-scale runs / CI)
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--num_heads", type=int, default=None)
    p.add_argument("--intermediate_size", type=int, default=None)
    p.add_argument("--profile", action="store_true", default=False)
    p.add_argument("--fused_attention", type=str, default=None,
                   choices=["0", "1", "flash"],
                   help="1 (default) -> the hand-written CUDA fused-attention "
                        "kernel (its plain version on the CPU); 0 -> the plain "
                        "PyTorch attention on every device; flash -> not "
                        "ported yet")
    p.add_argument("--exact_gelu", type=int, default=None, choices=[0, 1],
                   help="1 -> exact erf gelu in every dtype; 0 -> tanh "
                        "approximation under bf16")
    p.add_argument("--gelu_impl", type=str, default=None,
                   choices=["erf", "tanh", "poly"],
                   help="gelu under bf16 compute (fp32 always uses exact erf): "
                        "poly (default; degree-14 Chebyshev fit of erf-gelu, "
                        "models/common.py gelu_poly), erf, tanh. Overrides "
                        "--exact_gelu when given.")
    p.add_argument("--qk_bf16_grad", type=int, default=None, choices=[0, 1])
    p.add_argument("--fused_adamw", action="store_true", default=False)
    p.add_argument("--host_gather", action="store_true", default=False,
                   help="gather image features on the host per batch instead "
                        "of the device-resident table")
    p.add_argument("--xla_opt", action="append", default=[], metavar="KEY=VALUE",
                   help="XLA options of the JAX package; none apply to PyTorch")
    p.add_argument("--prng", type=str, default="unsafe_rbg",
                   choices=["threefry2x32", "rbg", "unsafe_rbg"],
                   help="JAX PRNG implementation; the port draws from "
                        "torch.Generator")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def resolve_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda, but PyTorch sees no CUDA device; pass --device cpu "
            "to run on the CPU")
    return torch.device(name)


def _refuse_unported(args) -> None:
    """Fail fast on what later slices of the port bring."""
    if not args.only_test:
        raise NotImplementedError(
            "training is not ported to PyTorch yet (the next slice); run with "
            "--only_test")
    if args.pretrain:
        raise NotImplementedError(
            "pre-training formats are not ported yet (training slice)")
    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint: an orbax checkpoint needs JAX to read; restore it "
            "with the JAX package and map it with "
            "mkg_analogy_tpu_torch.models.convert.unimo_params_from_jax "
            "(checkpoints are the training slice)")
    if args.fused_attention == "flash":
        raise NotImplementedError(
            "--fused_attention flash: the flash-attention kernels "
            "(kernels/flash_attention.py) are a later slice of the port")
    if (args.dp or 1) * args.tp > 1:
        raise NotImplementedError(
            "--dp/--tp: data and tensor parallelism are a later slice of the "
            "port; it runs on one device")
    if args.xla_opt:
        raise ValueError("--xla_opt: XLA options have no PyTorch counterpart")


def make_model(args, vocab_size: int):
    from ..models.registry import create_model

    overrides = {
        k: getattr(args, k)
        for k in ("hidden_size", "num_layers", "num_heads", "intermediate_size")
        if getattr(args, k, None)
    }
    gelu_impl = args.gelu_impl or (
        {None: "poly", 1: "erf", 0: "tanh"}[args.exact_gelu])
    return create_model(args.model_class, vocab_size=vocab_size, dtype=args.dtype,
                        fused_attention=args.fused_attention != "0",
                        gelu_impl=gelu_impl, **overrides)


def synthetic_image_table(mode: str, num_entities: int, size: int,
                          device: torch.device) -> torch.Tensor:
    """(N + 1, 3, size, size) bf16 identity-signal table built on the device
    from ``torch.Generator`` seed 314159, last row the zero pad row.
    "synthetic": each (size/7)^2 block is one per-entity Gaussian value (a
    3x7x7 code a ViT-B/32 patch embedding reads); "synthetic_noise":
    per-pixel white noise. Same construction as the JAX CLI's; the values
    differ, since the generators differ."""
    gen = torch.Generator(device=device).manual_seed(314159)
    shape = (3, size, size)
    if mode == "synthetic_noise":
        tab = torch.randn((num_entities,) + shape, generator=gen, device=device)
    else:
        blocks = max(1, size // 32)
        g = torch.randn((num_entities, 3, blocks, blocks), generator=gen,
                        device=device)
        rep = size // blocks
        tab = g.repeat_interleave(rep, dim=2).repeat_interleave(rep, dim=3)
        tab = tab[:, :, :size, :size]
    tab = tab.to(torch.bfloat16)
    return torch.cat([tab, tab.new_zeros((1,) + shape)], dim=0)


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    device = resolve_device(args.device)
    _refuse_unported(args)

    from ..data.module import KGCDataModule
    from ..models.registry import IMAGE_INPUT
    from ..train.trainer import MarTTrainer, TrainConfig
    from ..utils.logging import MetricLogger

    vocab_file = None
    if args.model_name_or_path and args.model_name_or_path != "wordpiece-kg":
        cand = os.path.join(args.model_name_or_path, "vocab.txt")
        if os.path.exists(cand):
            vocab_file = cand
        elif os.path.exists(args.model_name_or_path):
            vocab_file = args.model_name_or_path

    kind, img_size = IMAGE_INPUT.get(args.model_class, ("pixels", 224))
    if args.image_features not in (None, "", "synthetic", "synthetic_noise") \
            and not os.path.exists(args.image_features):
        # an explicit cache that does not exist must not degrade silently to
        # the zero-feature baseline (a different experiment arm)
        raise SystemExit(
            f"--image_features {args.image_features!r} is neither a known "
            "synthetic mode (synthetic, synthetic_noise) nor an existing "
            "feature-cache path"
        )
    data = KGCDataModule(
        data_dir=args.data_dir,
        pretrain_path=args.pretrain_path or args.data_dir,
        max_seq_length=args.max_seq_length,
        vocab_file=vocab_file,
        text_vocab_size=args.text_vocab_size,
        cache_dir=args.cache_dir,
        image_features=args.image_features,
        image_size=img_size or 224,
        image_kind=kind,
        overwrite_cache=args.overwrite_cache,
        seed=args.seed,
    )
    with torch.device(device):
        model = make_model(args, data.vocab.padded_vocab_size)
    cfg = TrainConfig(eval_batch_size=args.eval_batch_size)
    logger = MetricLogger(args.log_dir, wandb=args.wandb,
                          config=vars(args) if args.wandb else None)
    trainer = MarTTrainer(model, data.vocab, cfg, device=device, logger=logger)

    attach = None
    if args.image_features in ("synthetic", "synthetic_noise"):
        trainer.set_image_table(synthetic_image_table(
            args.image_features, data.markg.num_entities, img_size or 224,
            device), kind=kind)
    elif args.host_gather:
        attach = data.pixel_attach()
    else:
        # device-resident feature table: only int indices cross to the device
        trainer.set_image_table(data.device_table(), kind=kind)

    trainer.init_params(args.seed)
    metrics = trainer.evaluate(
        data.features("test"), attach=attach,
        dump_path=(os.path.join(args.output_dir, "test_ranks.npz")
                   if args.output_dir else None))
    logger.log(0, metrics, prefix="test/")
    logger.close()
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
