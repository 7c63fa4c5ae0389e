"""CLI entry point of the PyTorch port: the flag surface of
``mkg_analogy_tpu/cli/main.py`` (MarT/main.py:20-60 parity) plus
``--device``.

Ported: fine-tuning, pre-training and evaluation of the five families:
the three that read pixel stores, ``MKGformerKGC``, ``ViltKGC`` (384-px
stores, scripts/run_finetune_vilt.sh: ``--batch_size 32 --lr 4e-5 --alpha
0.3``) and ``FlavaKGC`` (224-px stores, scripts/run_finetune_flava.sh:
``--batch_size 24 --lr 5e-5 --alpha 0.45``), where ``--image_features``
names a store that ``python -m mkg_analogy_tpu_torch.tools.encode_images``
wrote; and the two that read detector region features (2 images x 36
regions of 2048), ``VisualBertKGC`` and ``VilBertKGC``
(scripts/run_finetune_visualbert.sh, run_finetune_vilbert.sh: ``--batch_size
64 --lr 5e-5 --alpha 0.43``), from a region store or the seeded
``--image_features synthetic`` / ``synthetic_noise`` tables.
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
whole K and V in shared memory where they fit a block and stream them in
chunks of 32 where they do not. Both take any key count, as JAX's kernel
does (ViLT's L + 290 tokens in either dtype). Both kernel sets take every
head_dim from 1 to 256 (64 and, for ViLBERT's 1024-wide visual stream, 128
from the nine libraries, any other width from the libraries of its padded
width; ``--num_heads 3`` at width 768 gives heads of 256) and raise above.
``--fused_attention 0`` runs
the plain PyTorch attention, except that a sequence of 512 or more takes
the flash kernels, as in JAX. ``--export_torch <file>`` writes the fit's
best MKGformerKGC weights as a reference-layout checkpoint
(``torch.save({"state_dict": ...})``, models/export_torch.py), as the JAX
CLI does. ``--qk_bf16_grad 1`` runs the plain attention's dq/dk backward in
the compute dtype (models/common.py:_qk_scores_bf16grad). On CUDA the CLI
builds every kernel first (core/cache.py), before the first batch. The JAX
package's ``--prng`` is accepted and changes nothing; ``--xla_opt`` raises.

``--dp``/``--tp`` run the fit and the evaluations on a (dp, tp) mesh
(core/mesh.py, parallel/), one process a rank: the CLI spawns them
(file rendezvous under ``--output_dir``), or, started by ``torchrun``
(``RANK``/``WORLD_SIZE`` set), joins the group that is there. As in the JAX
CLI, under ``--device cuda`` dp * tp must equal the visible GPU count (dp
defaults to that count over tp); under ``--device cpu`` the ranks are
processes, any count (dp defaults to 1). Rank 0 logs, prints, dumps ranks
and writes checkpoints, and the spawning process returns its test metrics.
With neither flag the run is the single-device one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist


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
    p.add_argument("--export_torch", type=str, default=None,
                   help="after a fit of MKGformerKGC, write its best weights as a "
                        "reference-format torch checkpoint to this file")
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
                        "in the compute dtype (bf16); exact forward. Applies "
                        "with --fused_attention 0 below 512 tokens; elsewhere "
                        "it changes nothing, as in JAX")
    p.add_argument("--fused_adamw", action="store_true", default=False,
                   help="AdamW through train/optim.py:fused_adamw: the same "
                        "numbers as the default AdamW")
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
    """Fail fast on flags the run would not honour."""
    if args.export_torch and args.model_class != "MKGformerKGC":
        raise ValueError(
            "--export_torch writes MKGformerKGC checkpoints (the JAX CLI's "
            f"export), not {args.model_class}")
    if args.xla_opt:
        raise ValueError("--xla_opt: XLA options have no PyTorch counterpart")


def mesh_devices(args, device: torch.device):
    """The mesh's devices, one a rank: [device] with neither --dp nor --tp;
    under cuda the visible GPUs, whose count dp * tp must equal (JAX's
    rule); under cpu dp * tp processes."""
    from ..core.mesh import default_devices

    if args.dp is None and args.tp == 1:
        return [device]
    if device.type == "cuda":
        devices = default_devices()
        dp = args.dp if args.dp is not None else len(devices) // args.tp
        if dp * args.tp != len(devices):
            raise ValueError(f"dp({dp}) * tp({args.tp}) != devices({len(devices)}): under "
                             "--device cuda the mesh takes every visible GPU, one a rank")
        return devices
    return [device] * ((args.dp or 1) * args.tp)


def _rank_main(rank: int, argv, metrics_path: str) -> None:
    """One rank of a spawned run: ``main`` in the process group; rank 0
    writes the test metrics for the spawning process."""
    metrics = main(argv)
    if rank == 0:
        with open(metrics_path, "w") as f:
            json.dump(metrics, f)


def _spawn_ranks(argv, args, devices):
    from ..parallel.launch import spawn

    os.makedirs(args.output_dir, exist_ok=True)
    metrics_path = os.path.join(args.output_dir, "metrics_rank0.json")
    threads = max(1, torch.get_num_threads() // len(devices))
    spawn(_rank_main, devices, args.output_dir, args=(argv, metrics_path), threads=threads)
    with open(metrics_path) as f:
        metrics = json.load(f)
    print(metrics)
    return metrics


def _rank0_first(fn):
    """``fn()`` on rank 0, then on the other ranks (which read the caches
    it wrote); once where there is no process group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return fn()
    if dist.get_rank() == 0:
        out = fn()
        dist.barrier()
        return out
    dist.barrier()
    return fn()


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
    if args.vilbert_ablate_img_to_txt:
        overrides["vilbert_ablate_img_to_txt"] = True
    return create_model(args.model_class, vocab_size=vocab_size, dtype=args.dtype,
                        attention=attention, gelu_impl=gelu_impl,
                        qk_bf16_grad=bool(args.qk_bf16_grad), **overrides)


def synthetic_image_table(mode: str, num_entities: int, size, device: torch.device,
                          kind: str = "pixels") -> torch.Tensor:
    """The identity-signal table of ``--image_features synthetic`` /
    ``synthetic_noise``, bf16, built on the device from a seeded
    ``torch.Generator``, last row the zero pad row. Same construction as the
    JAX CLI's (cli/main.py:343-370 for regions); the values differ, since
    the generators differ.

    Pixels (seed 314159): (N + 1, 3, size, size); "synthetic": each
    (size/7)^2 block is one per-entity Gaussian value (a 3x7x7 code a
    ViT-B/32 patch embedding reads); "synthetic_noise": per-pixel white noise.
    Regions (seed 271828, ``size`` unused): (N + 1, 36, 2048); "synthetic":
    each entity's 36 regions carry the same 2048-d Gaussian code (rank one,
    which the region projection reads in one linear map);
    "synthetic_noise": independent draws per (entity, region, dim)."""
    if kind == "regions":
        from ..data.images import RegionStore

        gen = torch.Generator(device=device).manual_seed(271828)
        shape = (RegionStore.num_regions, RegionStore.feat_dim)
        if mode == "synthetic_noise":
            tab = torch.randn((num_entities,) + shape, generator=gen, device=device)
        else:
            code = torch.randn((num_entities, 1, shape[1]), generator=gen, device=device)
            tab = code.expand(-1, shape[0], -1)
        tab = tab.to(torch.bfloat16)
        return torch.cat([tab, tab.new_zeros((1,) + shape)], dim=0)
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
    device = resolve_device(args.device)
    _refuse_unported(args)
    devices = mesh_devices(args, device)
    if len(devices) == 1 or dist.is_initialized():
        return _run(args, device, devices)
    from ..parallel.launch import join_from_env, launched_by_env

    if not launched_by_env():
        print(args)
        return _spawn_ranks(sys.argv[1:] if argv is None else argv, args, devices)
    join_from_env(devices)
    try:
        return _run(args, device, devices)
    finally:
        dist.destroy_process_group()


def _run(args, device, devices):
    """The run of one process: the whole of a single-device run, or one
    rank of a mesh whose process group is up."""
    from ..core.mesh import is_main, make_mesh

    mesh = make_mesh(dp=len(devices) // args.tp, tp=args.tp, devices=devices)
    main_rank = is_main(mesh)
    if main_rank:
        print(args)
    if mesh is not None:
        device = torch.device(devices[dist.get_rank()])
    from ..core.cache import enable_compilation_cache

    # the JAX CLI's first call: on a CUDA device every csrc/ kernel is built
    # here, before the first batch, so no step pays for nvcc
    _rank0_first(lambda: enable_compilation_cache(device))

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
    data = _rank0_first(lambda: KGCDataModule(
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
        overwrite_cache=args.overwrite_cache and main_rank,
        seed=args.seed,
        pretrain_format=args.pretrain_format,
    ))
    with torch.device(device):
        model = make_model(args, data.vocab.padded_vocab_size)
    # the attention libraries of the model's head widths other than 64 and
    # 128 (kernels/build.py:build_widths), before the first batch too
    from ..models.common import attention_head_dims

    _rank0_first(lambda: enable_compilation_cache(
        device, kernels=False, head_dims=attention_head_dims(model)))
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
    logger = (MetricLogger(args.log_dir, wandb=args.wandb,
                           config=vars(args) if args.wandb else None)
              if main_rank else MetricLogger())
    trainer = MarTTrainer(model, data.vocab, cfg, device=device, logger=logger, mesh=mesh)

    attach = None
    if args.image_features in ("synthetic", "synthetic_noise"):
        trainer.set_image_table(synthetic_image_table(
            args.image_features, data.markg.num_entities, img_size, device, kind=kind),
            kind=kind)
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
    if mesh is not None:  # the features of every split, built (and cached) by rank 0 first
        _rank0_first(lambda: [split(name) for name in
                              (("test",) if args.only_test else ("train", "dev", "test"))])
    # test_ranks.npz is always a MARS split, the file tools/analyze_ranks.py
    # reads; a pre-training run's ranks mix entity and relation rows and go
    # to a file of their own (ranks, is_rel)
    dump_name = "test_ranks_pretrain.npz" if args.pretrain else "test_ranks.npz"
    dump_path = os.path.join(args.output_dir, dump_name) if args.output_dir else None
    if args.only_test:
        if args.checkpoint:
            trainer.load_state_dict(restore_from(args.checkpoint)(trainer.state_dict()))
        metrics = trainer.evaluate(split("test"), attach=attach, dump_path=dump_path)
        if main_rank:
            logger.log(0, metrics, prefix="test/")
            print(metrics)
        logger.close()
        return metrics

    ckpt = checkpoint.Checkpointer(os.path.join(args.output_dir, "ckpt"), mesh=mesh)
    try:
        steps, _ = trainer.fit(
            split("train"), split("dev"), attach=attach, checkpointer=ckpt,
            init_params_fn=restore_from(args.checkpoint) if args.checkpoint else None)
        # test with the best-Hits@10 checkpoint of THIS fit (main.py:157-159
        # parity: a stale checkpoint directory of an older run is not used)
        if ckpt.saved_steps:
            trainer.load_state_dict(ckpt.restore(step=ckpt.saved_steps[-1]))
    finally:
        ckpt.close()
    test_metrics = trainer.evaluate(split("test"), attach=attach, dump_path=dump_path)
    if main_rank:
        logger.log(steps, test_metrics, prefix="test/")
        print(test_metrics)
    logger.close()
    if args.export_torch:
        # reference-format torch checkpoint of the best weights
        # (models/export_torch.py; loadable by MarT main.py --checkpoint)
        from ..models.export_torch import state_dict_to_torch, unimo_params_to_reference

        state = trainer.state_dict()  # whole tensors: every rank takes part
        if main_rank:
            sd = unimo_params_to_reference(state, num_layers=model.cfg.text.num_layers,
                                           vocab_rows=data.vocab.vocab_size)
            torch.save({"state_dict": state_dict_to_torch(sd)}, args.export_torch)
            print(f"exported reference-format checkpoint to {args.export_torch}")
    return test_metrics


if __name__ == "__main__":
    main()
