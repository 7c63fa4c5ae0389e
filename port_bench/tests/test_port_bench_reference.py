"""The plain reference against the port at tiny widths on the CPU, in fp32:
the same weights, features, pixels and dropout seeds give the same states,
logits, loss and gradients (the port's plain attention routes on the CPU
hold the kernels' own dropout masks)."""

import pytest
import torch

from conftest import ROOT, tiny_config, tiny_traffic
from port_bench import traffic, weights
from port_bench.harness import Bench, run_cell
from port_bench.reference.layers import DropoutDraws, step_seed
from port_bench.reference.objective import finetune_loss


def _inputs(cfg, seed, b=4):
    feats = traffic.make_split(tiny_traffic("mars_train_b32"), cfg, seed)
    batch = {k: torch.as_tensor(v[:b]) for k, v in feats.items()}
    gen = torch.Generator().manual_seed(seed)
    pixels = torch.randn(b, 2, 3, cfg["image_size"], cfg["image_size"], generator=gen)
    positions = torch.stack([batch["mask_idx"], batch["rel_idx"][:, 0], batch["rel_idx"][:, 1],
                             batch["q_head_idx"], batch["a_head_idx"]], dim=1)
    return batch, pixels, positions


@pytest.mark.parametrize("config,route", [("mkgformer", "single"), ("mkgformer", "flash"),
                                          ("flava", "flash"), ("flava", "single")])
@pytest.mark.parametrize("train", [False, True])
def test_forward_and_gradients_match_the_port(config, route, train):
    from mkg_analogy_tpu_torch.models.common import DropoutRNG
    from mkg_analogy_tpu_torch.models.registry import create_model
    from mkg_analogy_tpu_torch.ops.losses import (
        label_smoothing_cross_entropy, relaxation_loss)

    bench = Bench(ROOT)
    cfg = dict(tiny_config(config), attention=route)
    ref = bench.reference(cfg)
    params = weights.make_params(ref.param_shapes(cfg), cfg["init"], 11, "cpu")
    model = create_model(cfg["model_class"], vocab_size=cfg["vocab_size"], dtype="float32",
                         attention=route, hidden_size=cfg["hidden_size"],
                         num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
                         intermediate_size=cfg["intermediate_size"])
    model.load_state_dict(params)
    batch, pixels, positions = _inputs(cfg, 7)
    ids = torch.arange(300, 300 + cfg["analogy_entities"])
    seed = step_seed(123, 4)

    inputs = dict(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"],
                  token_type_ids=batch["token_type_ids"], pixel_values=pixels,
                  positions=positions, boundary=batch["sep_idx"][:, 2])
    trans = model(**inputs, deterministic=not train,
                  rng=DropoutRNG.from_seed(seed, "cpu") if train else None)
    logits = model.logits(trans[:, 0], vocab_ids=ids)
    loss = (label_smoothing_cross_entropy(logits, batch["label"], 0.1)
            + 0.43 * relaxation_loss(trans[:, 3], trans[:, 4], trans[:, 1], trans[:, 2]))

    leaves = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    want_trans = ref.forward(leaves, cfg, batch, pixels, positions,
                             DropoutDraws(seed, "cpu") if train else None)
    want_logits = ref.logits(leaves, want_trans[:, 0], ids)
    want_loss, _, _ = finetune_loss(want_trans, want_logits, batch["label"], 0.43, 0.1)

    # fp32 round-off, amplified by the LayerNorms of 32-wide rows: the port
    # and the reference each sit within ~5e-5 of a float64 run of the reference
    torch.testing.assert_close(trans, want_trans, rtol=1e-3, atol=2e-4)
    torch.testing.assert_close(logits, want_logits, rtol=1e-3, atol=2e-4)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    if train:
        loss.backward()
        want = dict(zip(leaves, torch.autograd.grad(want_loss, list(leaves.values()))))
        # leaf by leaf, against the larger of its norm and the median leaf's
        # (a key's bias has a gradient of round-off alone)
        median = torch.stack([g.norm() for g in want.values()]).median()
        for name, p in model.named_parameters():
            g = want[name]
            assert (p.grad - g).norm() <= 1e-3 * max(g.norm(), median), name


@pytest.mark.parametrize("cell", ["mkgformer_finetune_bf16", "flava_finetune_fp32"])
def test_checked_steps_follow_the_reference_in_fp32(tiny_root_fp32, cell):
    """The whole check of a fine-tune cell in fp32, through fit, its
    optimizer hook and the reference's AdamW: the gaps are round-off."""
    line = run_cell(Bench(tiny_root_fp32), cell, 2 ** 31 + 17, 0.2, False, device="cpu")
    assert line["correct"]
    for name, check in line["checks"].items():
        assert check["value"] < 1e-3, name


def test_evaluation_ranks_follow_the_reference_in_fp32(tiny_root_fp32):
    line = run_cell(Bench(tiny_root_fp32), "mkgformer_eval_bf16", 2 ** 31 + 19, 0.2, False,
                    device="cpu")
    assert line["checks"]["rank_gap_median"]["value"] < 1e-4
    assert line["checks"]["ranks_unexplained"]["value"] == 0
    assert line["checks"]["metric_mismatch"]["value"] == 0
    assert line["attempted"] % 60 == 0 and line["failed"] == 0
