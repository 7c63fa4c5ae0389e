"""Faults planted in the program underneath the harness, to show that the
check that decides ``correct`` reads each as not correct.

Each takes ``patch(owner, name, value)``: pytest's ``monkeypatch.setattr``
in the tests, or ``setattr`` in a process of ``port_bench/calibrate.py
--fault <name>``, which reads the numbers a fault gives on the card.

- ``unchanged``: every step leaves the parameters as they are (a learning
  rate of 0);
- ``half_batch``: each training step's loss over the first half of its
  batch, the mean taken over those rows;
- ``label``: one example's label altered where the loss takes it;
- ``dq_zeroed``: the attention backward's dq left at zero on every call,
  rows 2 and 5 (a result the kernel never writes);
- ``answer``: one example's rank altered where the evaluation produces it;
- ``eval_half_batch``: half of each evaluation batch marked not valid.
"""

import torch


def unchanged(patch):
    from mkg_analogy_tpu_torch.train import optim
    patch(optim, "linear_warmup_linear_decay", lambda *a, **k: (lambda c: 0.0))


def half_batch(patch):
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer
    loss = MarTTrainer._finetune_loss

    def half(self, batch, rng, image_table=None):
        n = batch["input_ids"].shape[0] // 2
        return loss(self, {k: v[:n] for k, v in batch.items()}, rng, image_table)
    patch(MarTTrainer, "_finetune_loss", half)


def label(patch):
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer
    loss = MarTTrainer._finetune_loss

    def relabel(self, batch, rng, image_table=None):
        labels = batch["label"].clone()
        labels[0] = (labels[0] + 1) % self.analogy_entity_ids.numel()
        return loss(self, {**batch, "label": labels}, rng, image_table)
    patch(MarTTrainer, "_finetune_loss", relabel)


def dq_zeroed(patch):
    from mkg_analogy_tpu_torch.kernels import attention, flash_attention
    for function in (attention._FusedAttention, flash_attention._FlashAttention):
        def zeroed(ctx, g, backward=function.backward):
            dq, *rest = backward(ctx, g)
            return (torch.zeros_like(dq), *rest)
        patch(function, "backward", staticmethod(zeroed))


def answer(patch):
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer
    step = MarTTrainer._eval_step

    def altered(self, batch, image_table=None):
        out = step(self, batch, image_table)
        ranks = out["ranks"].clone()
        ranks[0] = 1 if int(ranks[0]) != 1 else 2
        return {**out, "ranks": ranks}
    patch(MarTTrainer, "_eval_step", altered)


def eval_half_batch(patch):
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer
    step = MarTTrainer._eval_step

    def half(self, batch, image_table=None):
        out = step(self, batch, image_table)
        valid = out["valid"].clone()
        valid[valid.shape[0] // 2:] = False
        return {**out, "valid": valid}
    patch(MarTTrainer, "_eval_step", half)
