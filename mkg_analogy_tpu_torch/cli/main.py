"""CLI entry point of the PyTorch port: the flag surface of
``mkg_analogy_tpu/cli/main.py`` (MarT/main.py:20-60 parity) plus
``--device``.

Ported so far: fine-tuning, pre-training and evaluation of the three
families that read pixel stores, ``MKGformerKGC``, ``ViltKGC`` (384-px
stores, scripts/run_finetune_vilt.sh: ``--batch_size 32 --lr 4e-5 --alpha
0.3``) and ``FlavaKGC`` (224-px stores, scripts/run_finetune_flava.sh:
``--batch_size 24 --lr 5e-5 --alpha 0.45``); ``--image_features`` names a
store that ``python -m mkg_analogy_tpu_torch.tools.encode_images`` wrote.
Fine-tuning (MarT/scripts/run_finetune_mkgformer.sh parity), e.g.

  python -m mkg_analogy_tpu_torch.cli.main \\
      --model_class MKGformerKGC --batch_size 32 --lr 5e-5 --alpha 0.43 \\
      --max_epochs 15 --max_seq_length 128 --eval_batch_size 128 \\
      --data_dir dataset/MARS --pretrain_path dataset/MarKG --pretrain 0

fits with dev evaluation each epoch, keeps the best-dev-Hits@10 checkpoint
under ``<output_dir>/ckpt`` and tests with it; ``--only_test`` evaluates
only, from ``--checkpoint <dir>`` (a checkpoint directory of this port) or
from the seed's random weights. ``--checkpoint`` also initialises a fit,
e.g. a fine-tune from a pre-train checkpoint. Pre-training on MarKG
(``--pretrain 1``, scripts/run_pretrain_mkgformer.sh and
run_pretrain_analogy.sh) takes ``--pretrain_format triple`` (link and
relation prediction prompts), ``analogy`` (pseudo-analogies in the
fine-tune layout) or ``mixed`` (both, interleaved each epoch); it evaluates
on its training features, as the JAX package does.

It runs on CUDA unless ``--device cpu`` is given; with ``--device cuda`` and
no GPU it raises instead of falling back to the CPU. On CUDA every attention
call, forward and backward, goes through hand-written kernels: the
single-block kernels with ``--fused_attention 1``, the K-blocked flash
kernels with ``--fused_attention flash``; without the flag each family
takes its default (models/registry.py:DEFAULT_ATTENTION: single for
MKGformer and ViLT, flash for FLAVA, whose multimodal tower attends over
394 + L tokens). The single-block kernels are two sets, picked by the
dtype alone: in bf16 tensor-core kernels (``mma.sync`` products, keys
streamed in chunks of 64), in fp32 CUDA-core kernels that hold a head's
whole K and V in shared memory. They take up to 717 keys in bf16 (where the
route's limit has always been) and 400 in fp32 (shared memory) and raise
above, naming the flash kernels: ViLT's L + 290 tokens fit in bf16 only. ``--fused_attention 0`` runs the plain PyTorch
attention, except that a sequence of 512 or more takes the flash kernels,
as in JAX. ``--export_torch``, parallelism and the two region-feature
families (VisualBertKGC, VilBertKGC) raise until their slices land. The
JAX package's ``--prng`` is accepted and changes nothing; ``--xla_opt``
raises.
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
                   help="a checkpoint directory written by this port (its "
                        "latest step): the weights of --only_test, or the "
                        "initialisation of a fit (strict=False). An orbax "
                        "checkpoint of the JAX package needs JAX to read: "
                        "convert it with models/convert.py")
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
                   help="1 -> the hand-written CUDA single-block "
                        "fused-attention kernels; flash -> the K-blocked "
                        "(online-softmax) CUDA kernels, any sequence length; "
                        "0 -> the plain PyTorch attention (flash from L=512); "
                        "default: 1 for MKGformerKGC and ViltKGC, flash for "
                        "FlavaKGC; on the CPU each kernel's plain version")
    p.add_argument("--exact_gelu", type=int, default=None, choices=[0, 1],
                   help="1 -> exact erf gelu in every dtype; 0 -> tanh "
                        "approximation under bf16")
    p.add_argument("--gelu_impl", type=str, default=None,
                   choices=["erf", "tanh", "poly"],
                   help="gelu under bf16 compute (fp32 always uses exact erf): "
                        "poly (default; degree-14 Chebyshev fit of erf-gelu, "
                        "models/common.py gelu_poly), erf, tanh. Overrides "
                        "--exact_gelu when given.")
    p.add_argument("--qk_bf16_grad", type=int, default=None, choices=[0, 1],
                   help="1 -> dq/dk GEMMs of the plain attention's backward "
                        "in the compute dtype: not ported yet (with "
                        "--fused_attention 1 it changes nothing, as in JAX)")
    p.add_argument("--fused_adamw", action="store_true", default=False,
                   help="accepted; the same numbers as the default AdamW")
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
    if args.export_torch:
        raise NotImplementedError(
            "--export_torch: the reference-format converters "
            "(models/export_torch.py) are a later slice of the port "
            "(ROADMAP.md, Open items 1, item 2)")
    if args.qk_bf16_grad and args.fused_attention == "0":
        raise NotImplementedError(
            "--qk_bf16_grad 1 with --fused_attention 0: the bf16 dq/dk "
            "backward of the plain attention is not ported yet (ROADMAP.md "
            "queue 1, the default-off knobs)")
    if (args.dp or 1) * args.tp > 1:
        raise NotImplementedError(
            "--dp/--tp: data and tensor parallelism are a later slice of the "
            "port; it runs on one device")
    if args.xla_opt:
        raise ValueError("--xla_opt: XLA options have no PyTorch counterpart")


def make_model(args, vocab_size: int):
    from ..models.registry import DEFAULT_ATTENTION, create_model

    overrides = {
        k: getattr(args, k)
        for k in ("hidden_size", "num_layers", "num_heads", "intermediate_size")
        if getattr(args, k, None)
    }
    gelu_impl = args.gelu_impl or (
        {None: "poly", 1: "erf", 0: "tanh"}[args.exact_gelu])
    attention = {None: DEFAULT_ATTENTION.get(args.model_class, "single"), "1": "single",
                 "0": "plain", "flash": "flash"}[args.fused_attention]
    return create_model(args.model_class, vocab_size=vocab_size, dtype=args.dtype,
                        attention=attention, gelu_impl=gelu_impl, **overrides)


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


def pretrain_splits(data, fmt: str):
    """The train / dev / test features of a pre-training run. The mixed diet
    trains on (triple, analogy) features, each cached under its
    single-format key, and evaluates in the analogy geometry, the downstream
    task; a single format evaluates on its training features, as the JAX CLI
    does."""
    if fmt == "mixed":
        analogy = data.features("train", fmt="analogy")
        return dict(train=(data.features("train", fmt="triple"), analogy),
                    dev=analogy, test=analogy)
    feats = data.features("train")
    return dict(train=feats, dev=feats, test=feats)


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    device = resolve_device(args.device)
    _refuse_unported(args)

    from ..data.module import KGCDataModule
    from ..models.registry import IMAGE_INPUT
    from ..train import checkpoint
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
        pretrain=bool(args.pretrain),
        vocab_file=vocab_file,
        text_vocab_size=args.text_vocab_size,
        cache_dir=args.cache_dir,
        image_features=args.image_features,
        image_size=img_size or 224,
        image_kind=kind,
        overwrite_cache=args.overwrite_cache,
        seed=args.seed,
        pretrain_format=args.pretrain_format,
    )
    with torch.device(device):
        model = make_model(args, data.vocab.padded_vocab_size)
    cfg = TrainConfig(
        lr=args.lr,
        max_epochs=args.max_epochs,
        batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size,
        alpha=args.alpha,
        label_smoothing=args.label_smoothing,
        warmup_ratio=args.warm_up_radio,
        weight_decay=args.weight_decay,
        grad_accum_steps=args.accumulate_grad_batches,
        pretrain=bool(args.pretrain),
        analogy_pretrain=bool(args.pretrain)
        and args.pretrain_format in ("analogy", "mixed"),
        mixed_pretrain=bool(args.pretrain) and args.pretrain_format == "mixed",
        seed=args.seed,
        track_grad_norm=args.track_grad_norm != -1,
        check_val_every_n_epoch=args.check_val_every_n_epoch,
        profile_dir=os.path.join(args.log_dir, "profile") if args.profile else None,
        # pl.Trainer semantics, resolved in MarTTrainer.fit
        limit_train_batches=args.limit_train_batches or None,
        fused_adamw=args.fused_adamw,
    )
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

    def restore_from(directory):
        def init_params_fn(state):
            return checkpoint.partial_restore(state, checkpoint.load(directory))
        return init_params_fn

    split = (pretrain_splits(data, args.pretrain_format).__getitem__ if args.pretrain
             else data.features)
    dump_path = (os.path.join(args.output_dir, "test_ranks.npz")
                 if args.output_dir else None)
    if args.only_test:
        if args.checkpoint:
            model.load_state_dict(restore_from(args.checkpoint)(model.state_dict()))
        metrics = trainer.evaluate(split("test"), attach=attach, dump_path=dump_path)
        logger.log(0, metrics, prefix="test/")
        logger.close()
        print(metrics)
        return metrics

    ckpt = checkpoint.Checkpointer(os.path.join(args.output_dir, "ckpt"))
    try:
        steps, _ = trainer.fit(
            split("train"), split("dev"), attach=attach, checkpointer=ckpt,
            init_params_fn=restore_from(args.checkpoint) if args.checkpoint else None)
        # test with the best-Hits@10 checkpoint of THIS fit (main.py:157-159
        # parity: a stale checkpoint directory of an older run is not used)
        if ckpt.saved_steps:
            model.load_state_dict(ckpt.restore(step=ckpt.saved_steps[-1]))
    finally:
        ckpt.close()
    test_metrics = trainer.evaluate(split("test"), attach=attach, dump_path=dump_path)
    logger.log(steps, test_metrics, prefix="test/")
    logger.close()
    print(test_metrics)
    return test_metrics


if __name__ == "__main__":
    main()
