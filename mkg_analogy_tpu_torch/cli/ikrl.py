"""IKRL / TransAE command-line entry point of the PyTorch port
(``mkg_analogy_tpu/cli/ikrl.py``: the same flags, plus ``--device``).

The reference toggles ``finetune`` / ``analogy`` booleans in source
(IKRL.py:982-983, documented in its README); here they are flags. The flow
mirrors the module bodies of IKRL.py:985-1107 and TransAE.py:

  pretrain:  Bernoulli sampler (neg 25+25, bern, filter) -> margin/softplus
             negative-sampling training -> filtered link prediction
  finetune:  Adam CE over MARS 6-tuples -> analogical reasoning metrics

Examples:
  python -m mkg_analogy_tpu_torch.cli.ikrl --data_dir dataset/MARS \\
      --pretrain_path dataset/MarKG --model transe --train_times 2000
  python -m mkg_analogy_tpu_torch.cli.ikrl ... --finetune --ckpt out/ikrl/ckpt
  python -m mkg_analogy_tpu_torch.cli.ikrl ... --transae   # TransAE variant

It runs on CUDA unless ``--device cpu`` is given; with ``--device cuda`` and
no GPU it raises. Checkpoints are the port's (``train/checkpoint.py``: the
model's state dict, frozen feature tables included); a JAX checkpoint is
converted with ``models.convert.params_from_jax`` first. Unlike the JAX
CLI, ``--dump_ranks`` writes each example's real tie-group size, and
``--holdout_frac`` with ``--use_native_sampler`` raises: the native sampler
reads ``--in_path`` whole and would train on the held-out triples.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .main import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description="IKRL/TransAE KGE training and evaluation (PyTorch port)")
    p.add_argument("--data_dir", required=True, help="MARS dir")
    p.add_argument("--pretrain_path", required=True, help="MarKG dir")
    p.add_argument("--in_path", default=None,
                   help="existing OpenKE-format dir (else derived from MarKG)")
    p.add_argument("--model", choices=["transe", "analogy"], default="transe")
    p.add_argument("--transae", action="store_true",
                   help="use the TransAE autoencoder entity encoder")
    p.add_argument("--dim", type=int, default=None,
                   help="embedding dim (default: 400 transe / 200 analogy)")
    p.add_argument("--train_times", type=int, default=2000)
    p.add_argument("--nbatches", type=int, default=100)
    p.add_argument("--neg_ent", type=int, default=25)
    p.add_argument("--neg_rel", type=int, default=25)
    p.add_argument("--margin", type=float, default=5.0)
    p.add_argument("--alpha", type=float, default=1.0, help="pretrain lr")
    p.add_argument("--finetune", action="store_true")
    p.add_argument("--finetune_lr", type=float, default=1e-4)
    p.add_argument("--finetune_epochs", type=int, default=1000)
    p.add_argument("--finetune_bsz", type=int, default=128)
    p.add_argument("--ckpt", default=None, help="checkpoint dir to restore")
    p.add_argument("--output_dir", default="output/ikrl")
    p.add_argument("--visual_features", default=None,
                   help=".npy (E+1, 4096) VGG feature store")
    p.add_argument("--use_native_sampler", action="store_true",
                   help="sample via the C++ kgsampler library")
    p.add_argument("--task_mode", choices=["text", "random"], default="text")
    p.add_argument("--triple_classification", action="store_true",
                   help="also run triple classification after link prediction")
    p.add_argument("--holdout_frac", type=float, default=0.0,
                   help="carve this fraction each for valid/test out of the "
                        "training triples (seeded) and evaluate link "
                        "prediction on the held-out test split "
                        "(kge/sampling.split_store); not with "
                        "--use_native_sampler")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", default="training/logs")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training and evaluate the restored --ckpt "
                        "(link prediction in pretrain mode, analogical "
                        "reasoning with --finetune)")
    p.add_argument("--dump_ranks", default=None,
                   help="npz path for per-example analogy-eval ranks "
                        "(keys ranks/mode/tie — tools/analyze_ranks.py "
                        "layout); finetune mode only")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; cuda raises without a GPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    device = resolve_device(args.device)
    if args.holdout_frac and args.use_native_sampler:
        raise ValueError(
            "--holdout_frac with --use_native_sampler: the native sampler reads "
            "--in_path's train2id.txt whole, so it would train on the held-out "
            "valid and test triples")
    if args.eval_only and not args.ckpt:
        raise ValueError("--eval_only needs --ckpt")
    if args.use_native_sampler and not args.in_path:
        raise ValueError("--use_native_sampler needs --in_path")
    from ..core.cache import enable_compilation_cache

    # the JAX CLI's first call: here the one native library this path
    # launches, the sampler, built before the first batch (no CUDA kernel)
    enable_compilation_cache(device, kernels=False,
                             native_sampler=args.use_native_sampler)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..data.readers import MARS, MarKG
    from ..kge.eval import (analogical_reasoning, build_filters, link_prediction,
                            triple_classification)
    from ..kge.ikrl import IKRLConfig, create_ikrl
    from ..kge.sampling import NegativeSampler, TripleStore
    from ..kge.trainer import KGETrainConfig, KGETrainer, mars_finetune_tuples
    from ..train import checkpoint
    from ..utils.logging import MetricLogger

    logger = MetricLogger(args.log_dir, name="ikrl")
    markg = MarKG(args.pretrain_path)
    mars = MARS(args.data_dir, markg)
    test_store = valid_store = None
    if args.in_path:
        store = TripleStore.from_openke_dir(args.in_path)
        for name in ("test", "valid"):
            if not os.path.exists(os.path.join(args.in_path, f"{name}2id.txt")):
                continue
            s = TripleStore.from_openke_dir(args.in_path, split=name)
            if name == "test":
                test_store = s
            else:
                valid_store = s
    else:
        store = TripleStore.from_arrays(
            markg.triples_as_ids(), markg.num_entities, markg.num_relations
        )
    if args.holdout_frac:
        from ..kge.sampling import split_store

        store, valid_store, test_store = split_store(
            store, args.holdout_frac, seed=args.seed
        )
        print(f"holdout split: train={len(store)} valid={len(valid_store)} "
              f"test={len(test_store)}")

    visual = None
    if args.visual_features and os.path.exists(args.visual_features):
        visual = np.load(args.visual_features)

    generator = torch.Generator().manual_seed(args.seed)
    dim = args.dim or (400 if args.model == "transe" else 200)
    if args.transae:
        from ..kge.transae import TransAEConfig, TransAETransE, build_transae_inputs

        text_feats, vis_feats = build_transae_inputs(markg, visual, device=device)
        model = TransAETransE(
            TransAEConfig(markg.num_entities, markg.num_relations, dim=dim),
            text_features=text_feats, visual_features=vis_feats, generator=generator,
        )
    else:
        cfg = IKRLConfig(markg.num_entities, markg.num_relations, dim=dim,
                         scorer=args.model, margin=args.margin)
        model = create_ikrl(cfg, visual, generator)
    model.to(device)

    batch_size = len(store) // args.nbatches
    tcfg = KGETrainConfig(
        train_times=args.train_times, lr=args.alpha,
        loss="margin" if args.model == "transe" else "softplus",
        margin=args.margin,
        regul_rate=0.0 if args.model == "transe" else 1.0,
        finetune_lr=args.finetune_lr, finetune_epochs=args.finetune_epochs,
        finetune_batch_size=args.finetune_bsz, seed=args.seed,
    )
    trainer = KGETrainer(model, tcfg, batch_size,
                         neg_total=args.neg_ent + args.neg_rel)
    ckpt = checkpoint.Checkpointer(os.path.join(args.output_dir, "ckpt"))
    if args.ckpt:
        model.load_state_dict(checkpoint.load(args.ckpt, map_location=device),
                              strict=True)
    state = trainer.init_state(finetune=args.finetune)

    try:
        if not args.finetune:
            if not args.eval_only:
                if args.use_native_sampler:
                    from ..native.api import NativeTrainLoader

                    sampler = NativeTrainLoader(
                        args.in_path, batch_size=batch_size,
                        neg_ent=args.neg_ent, neg_rel=args.neg_rel, bern_flag=True,
                    )
                else:
                    sampler = NegativeSampler(
                        store, batch_size=batch_size, neg_ent=args.neg_ent,
                        neg_rel=args.neg_rel, bern=True, seed=args.seed,
                    )
                state = trainer.pretrain(sampler, state, logger=logger)
                ckpt.save(state.step, model.state_dict())

            model.eval()
            eval_store = test_store if test_store is not None else store
            filter_stores = [s for s in (store, valid_store, test_store) if s is not None]
            metrics = link_prediction(
                model.candidate_energies, eval_store, build_filters(*filter_stores),
                markg.num_entities, task_mode=args.task_mode, seed=args.seed,
                device=device,
            )
            logger.log(state.step, metrics, prefix="link_prediction/")
            print({k: metrics[k] for k in ("mrr", "mr", "hit10", "hit3", "hit1")})

            if args.triple_classification:
                # corrupted negatives for classification (getTestBatch parity)
                neg_sampler = NegativeSampler(store, batch_size=len(store), neg_ent=1,
                                              neg_rel=0, bern=True, seed=args.seed)
                nb = neg_sampler._normal_batch(np.arange(len(store)))
                n = len(store)
                neg_store = TripleStore(
                    nb["batch_h"][n : 2 * n], nb["batch_t"][n : 2 * n],
                    nb["batch_r"][n : 2 * n], store.num_entities, store.num_relations,
                )
                acc, thr = triple_classification(model, store, neg_store, device=device)
                logger.log(state.step, {"acc": acc, "threshold": thr},
                           prefix="triple_classification/")
                print({"triple_classification_acc": acc})
            return metrics

        tuples = mars_finetune_tuples(mars, markg)
        if not args.eval_only:
            state = trainer.finetune(tuples["train"], state, logger=logger)
            ckpt.save(state.step, model.state_dict())
        model.eval()
        metrics, ranks, ties = analogical_reasoning(
            model.finetune_scores, tuples["test"], return_ranks=True, device=device)
        if args.dump_ranks:
            np.savez(args.dump_ranks, ranks=ranks, mode=tuples["test"][:, 5],
                     tie=ties.astype(np.int64))
            print(f"ranks dumped to {args.dump_ranks}")
        logger.log(state.step, metrics, prefix="analogy/")
        print(metrics)
        return metrics
    finally:
        ckpt.close()  # the last save is written by a worker thread
        logger.close()


if __name__ == "__main__":
    main()
