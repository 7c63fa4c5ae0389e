"""RSME command-line entry point of the PyTorch port (``mkg_analogy_tpu/cli/rsme.py``:
the same flags, plus ``--device``; learn.py parity).

Mirrors M-KGE/RSME/learn.py:20-91 flags and the run.sh / run_finetune.sh
recipes (ComplEx rank 1000 lr 1e-2 Adagrad 300 epochs; --finetune --ckpt for
the Analogy stage):

  python -m mkg_analogy_tpu_torch.cli.rsme --data_dir dataset/MARS \\
      --pretrain_path dataset/MarKG --model ComplEx --rank 1000 \\
      --learning_rate 1e-2 --max_epochs 300
  python -m mkg_analogy_tpu_torch.cli.rsme ... --model Analogy --finetune \\
      --ckpt output/rsme/ckpt

It runs on CUDA unless ``--device cpu`` is given; with ``--device cuda`` and
no GPU it raises. Checkpoints are the port's (``train/checkpoint.py``).
The fine-tune evaluation ranks the answer as ``kge.eval.analogical_reasoning``
does (``ranks_from_scores``); ``--dump_ranks`` writes each example's real
tie-group size (the JAX CLI writes ones). ``--model CP`` trains and evaluates; with ``--finetune`` it
raises (CP has no fine-tune forward, in JAX neither).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .main import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description="RSME KBC training and evaluation (PyTorch port)")
    p.add_argument("--data_dir", required=True, help="MARS dir")
    p.add_argument("--pretrain_path", required=True, help="MarKG dir")
    p.add_argument("--dataset", default="analogy")
    p.add_argument("--model", choices=["ComplEx", "Analogy", "CP"],
                   default="ComplEx")
    p.add_argument("--regularizer", choices=["N3", "F2"], default="N3")
    p.add_argument("--reg", type=float, default=0.0)
    p.add_argument("--optimizer", choices=["Adagrad", "Adam", "SGD"],
                   default="Adagrad")
    p.add_argument("--max_epochs", type=int, default=300)
    p.add_argument("--valid", type=int, default=3,
                   help="evaluate every N epochs")
    p.add_argument("--rank", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=1e-2)
    p.add_argument("--decay1", type=float, default=0.9)
    p.add_argument("--decay2", type=float, default=0.999)
    p.add_argument("--init", type=float, default=1e-3)
    p.add_argument("--finetune", action="store_true")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--alpha", type=float, default=0.7)
    p.add_argument("--beta", type=float, default=0.5)
    p.add_argument("--no_forget_gate", action="store_true")
    p.add_argument("--remember_rate", type=int, default=100)
    p.add_argument("--img_vec", default=None, help=".npy (E, 1000) ViT store")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_dir", default="output/rsme")
    p.add_argument("--log_dir", default="training/logs")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training and evaluate the restored --ckpt "
                        "(held-out link prediction in pretrain mode, MARS "
                        "analogy ranking with --finetune)")
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
    if args.eval_only and not args.ckpt:
        raise ValueError("--eval_only needs --ckpt")
    if args.finetune and args.model == "CP":
        raise ValueError("--finetune needs --model ComplEx or Analogy: CPModel "
                         "has no fine-tune forward")
    from ..core.cache import enable_compilation_cache

    # the JAX CLI's first call; this path launches no native library
    enable_compilation_cache(device, kernels=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..data.gates import build_gates
    from ..data.readers import MARS, MarKG
    from ..kge.rsme import (
        CPModel,
        RSMEConfig,
        RSMEModel,
        RSMETrainConfig,
        RSMETrainer,
        assign_modes,
        build_to_skip,
        eval_both_sides,
        reciprocal_augment,
    )
    from ..kge.eval import analogical_reasoning
    from ..kge.trainer import mars_finetune_tuples
    from ..train import checkpoint
    from ..utils.logging import MetricLogger

    logger = MetricLogger(args.log_dir, name="rsme")
    markg = MarKG(args.pretrain_path)
    mars = MARS(args.data_dir, markg)
    rng = np.random.default_rng(args.seed)

    triples = np.asarray(
        [(h, r, t) for h, r, t in markg.triples_as_ids()], np.int64
    )
    modes = assign_modes(len(triples), rng)
    data4 = np.column_stack([triples[:, 0], triples[:, 1], triples[:, 2], modes])
    # 98/1/1 split of MarKG for pretrain valid/test
    perm = rng.permutation(len(data4))
    n_valid = max(1, len(data4) // 100)
    test4 = data4[perm[n_valid : 2 * n_valid]]
    train4 = data4[perm[2 * n_valid :]]
    train_aug = reciprocal_augment(train4, markg.num_relations)
    # the reciprocal-augmented (lhs, rel)->rhs map covers both directions:
    # lhs-side queries are rewritten to rhs form (swap + rel+n_rel) in
    # eval_both_sides before the lookup.
    rhs_map = build_to_skip(reciprocal_augment(data4, markg.num_relations)[:, :3])["rhs"]
    to_skip_all = {"rhs": rhs_map, "lhs": rhs_map}

    img_vec = None
    if args.img_vec and os.path.exists(args.img_vec):
        img_vec = np.load(args.img_vec)
    if img_vec is None:
        img_vec = np.zeros((markg.num_entities, 1000), np.float32)
    _, _, rel_pd = build_gates(
        data4[:, :3], img_vec, markg.num_relations, args.remember_rate
    )
    rel_pd2 = np.vstack([rel_pd, rel_pd])  # reciprocal copy (models.py:193)

    generator = torch.Generator().manual_seed(args.seed)
    if args.model == "CP":
        model = CPModel(markg.num_entities, markg.num_relations, args.rank,
                        args.init, generator=generator)
    else:
        cfg = RSMEConfig(
            markg.num_entities, markg.num_relations, rank=args.rank,
            init_size=args.init, img_dim=img_vec.shape[1], alpha=args.alpha,
            beta=args.beta, forget_gate=not args.no_forget_gate,
            model=args.model.lower(),
        )
        model = RSMEModel(cfg, img_vec=img_vec, rel_pd=rel_pd2, generator=generator)
    model.to(device)

    tcfg = RSMETrainConfig(
        lr=args.learning_rate, optimizer=args.optimizer.lower(),
        batch_size=args.batch_size, reg_weight=args.reg,
        regularizer=args.regularizer.lower(), max_epochs=args.max_epochs,
        seed=args.seed, decay1=args.decay1, decay2=args.decay2,
    )
    trainer = RSMETrainer(model, tcfg, finetune=args.finetune)
    if args.ckpt:
        model.load_state_dict(checkpoint.load(args.ckpt, map_location=device),
                              strict=True)
    state = trainer.init_state()
    ckpt = checkpoint.Checkpointer(os.path.join(args.output_dir, "ckpt"))

    nprng = np.random.default_rng(args.seed + 1)
    try:
        if not args.finetune:
            best_mrr = 0.0
            for epoch in range(0 if args.eval_only else args.max_epochs):
                state, loss = trainer.epoch(state, train_aug, nprng)
                logger.log(state.step, {"loss": loss, "epoch": epoch},
                           prefix="rsme_train/")
                if (epoch + 1) % args.valid == 0:
                    m = eval_both_sides(model, test4, to_skip_all, markg.num_relations)
                    logger.log(state.step, m, prefix="rsme_test/")
                    if m["mrr"] > best_mrr:
                        best_mrr = m["mrr"]
                        ckpt.save(state.step, model.state_dict(), metrics=m)
            result = eval_both_sides(model, test4, to_skip_all, markg.num_relations)
            print("TEST:", result)
            return result

        tuples = mars_finetune_tuples(mars, markg)
        if not args.eval_only:
            for epoch in range(args.max_epochs):
                state, loss = trainer.epoch(state, tuples["train"], nprng)
                logger.log(state.step, {"loss": loss, "epoch": epoch},
                           prefix="rsme_ft/")
            ckpt.save(state.step, model.state_dict())
        model.eval()

        def scores(e_head, e_tail, q_head, task_mode):  # columns 0, 1, 2 and 5
            x = torch.stack([e_head, e_tail, q_head, q_head, q_head, task_mode], dim=1)
            return model.finetune_forward(x)[0]

        result, ranks, ties = analogical_reasoning(scores, tuples["test"], batch_size=500,
                                                   return_ranks=True, device=device)
        if args.dump_ranks:
            np.savez(args.dump_ranks, ranks=ranks, mode=tuples["test"][:, 5],
                     tie=ties.astype(np.int64))
            print(f"ranks dumped to {args.dump_ranks}")
        logger.log(state.step, result, prefix="rsme_ft_test/")
        print("TEST_FT:", result)
        return result
    finally:
        ckpt.close()
        logger.close()


if __name__ == "__main__":
    main()
