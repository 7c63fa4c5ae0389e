"""KimiVLKGC (``models/kimi_vl.py``) on the CPU at small sizes, seeded,
against the benchmark's plain fp32 reference (``port_bench/reference/
kimi_vl.py``): the five gathered states, the loss and every leaf's
gradient; the held experts' shares adding up to the uncut layer; the causal
mask; the selection bias; planted routing faults that the comparison
catches; the registry's defaults against ``kimi_vl_a3b.json``; and the
expert layers' spans and counters."""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.models import kimi_vl
from mkg_analogy_tpu_torch.models.kimi_vl import ExpertLayer, KimiVLConfig, KimiVLForMaskedLM
from mkg_analogy_tpu_torch.models.registry import DEFAULT_ATTENTION, IMAGE_INPUT, create_model
from mkg_analogy_tpu_torch.models.unimo import VisionConfig
from mkg_analogy_tpu_torch.train.optim import make_optimizer
from mkg_analogy_tpu_torch.utils import profiling
from port_bench import traffic
from port_bench.reference import kimi_vl as ref
from port_bench.reference.objective import finetune_loss

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "port_bench" / "configs" / "kimi_vl_a3b.json").read_text())

SMALL = dict(vocab_size=64, hidden_size=32, num_layers=3, num_heads=2, intermediate_size=48,
             moe_intermediate_size=16, router_experts=8, held_experts=4, experts_per_token=3,
             shared_experts=2, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
             v_head_dim=8, first_dense_layers=1)
VISION = VisionConfig(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
                      image_size=32, patch_size=16, num_images=1)
VOCAB = dict(entity_token_start=30, word_tokens=[5, 30], pad_id=0, cls_id=1, sep_id=2,
             mask_id=3, r_id=4)
ENTITIES = 20


def program_config(**kw) -> KimiVLConfig:
    return KimiVLConfig(**{**SMALL, **kw}, vision=VISION, dtype="float32")


def reference_config(cfg: KimiVLConfig) -> dict:
    """The reference's keys (kimi_vl_a3b.json's) at ``cfg``'s sizes."""
    v = cfg.vision
    return dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size, moe_intermediate_size=cfg.moe_intermediate_size,
        first_k_dense_replace=cfg.first_dense_layers, router_experts=cfg.router_experts,
        n_routed_experts=cfg.held_experts, first_held_expert=cfg.first_held_expert,
        num_experts_per_tok=cfg.experts_per_token, n_shared_experts=cfg.shared_experts,
        routed_scaling_factor=cfg.routed_scaling_factor, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim, qk_rope_head_dim=cfg.qk_rope_head_dim,
        v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
        kv_a_norm_eps=cfg.kv_a_norm_eps, image_size=v.image_size, patch_size=v.patch_size,
        num_images=cfg.num_images, vision_hidden_size=v.hidden_size,
        vision_layers=v.num_layers, vision_heads=v.num_heads,
        vision_intermediate_size=v.intermediate_size, vision_layer_norm_eps=v.layer_norm_eps,
        analogy_entities=ENTITIES, vocab=VOCAB)


def random_params(shapes, seed=0):
    """Seeded leaves at the configuration's initialisers, the scales raised
    so that every path carries signal at these sizes."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("adaptive_w0"):
            out[name] = torch.rand(shape, generator=g) * 0.5
        elif name.endswith("adaptive_w1"):
            out[name] = torch.full(shape, 0.7)
        elif name.endswith("_ln.weight") or name.endswith((".ln1.weight", ".ln2.weight")):
            out[name] = 1.0 + 0.1 * torch.randn(shape, generator=g)
        else:
            out[name] = 0.2 * torch.randn(shape, generator=g)
    return out


def make_batch(seed=3, n=4, length=20):
    spec = dict(split="train", examples=n, mode_counts=[1, 2, 1], batch_size=n,
                max_seq_length=length, prompt_length=[16, length])
    feats = traffic.make_split(spec, dict(vocab=VOCAB, analogy_entities=ENTITIES), seed)
    batch = {k: torch.as_tensor(v) for k, v in feats.items()}
    g = torch.Generator().manual_seed(seed)
    pixels = torch.randn(n, 2, 3, 32, 32, generator=g)
    positions = torch.stack([batch["mask_idx"], batch["rel_idx"][:, 0], batch["rel_idx"][:, 1],
                             batch["q_head_idx"], batch["a_head_idx"]], dim=1)
    return batch, pixels, positions


def program(cfg, params):
    model = KimiVLForMaskedLM(cfg)
    model.load_state_dict(params, strict=True)
    return model


def run_program(model, batch, pixels, positions):
    return model(batch["input_ids"], batch["attention_mask"], batch["token_type_ids"], pixels,
                 positions, boundary=batch["sep_idx"][:, 2])


def loss_of(trans, logits, batch):
    return finetune_loss(trans, logits, batch["label"], 0.45, 0.1)[0]


def entity_ids():
    return torch.arange(VOCAB["entity_token_start"], VOCAB["entity_token_start"] + ENTITIES)


def rel_gap(a, b):
    return float((a - b).norm() / b.norm())


def test_states_loss_and_every_gradient_match_the_reference():
    cfg = program_config()
    rcfg = reference_config(cfg)
    params = random_params(ref.param_shapes(rcfg))
    model = program(cfg, params)
    batch, pixels, positions = make_batch()
    trans = run_program(model, batch, pixels, positions)
    loss = loss_of(trans, model.logits(trans[:, 0], vocab_ids=entity_ids()), batch)
    loss.backward()

    leaves = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    want = ref.forward(leaves, rcfg, batch, pixels, positions)
    want_loss = loss_of(want, ref.logits(leaves, want[:, 0], entity_ids()), batch)
    grads = torch.autograd.grad(want_loss, list(leaves.values()), allow_unused=True)

    assert trans.shape == (4, 5, cfg.hidden_size)
    assert rel_gap(trans.detach(), want.detach()) < 1e-5
    got_loss, want_loss = float(loss.detach()), float(want_loss.detach())
    assert abs(got_loss - want_loss) < 1e-5 * abs(want_loss)
    named = dict(model.named_parameters())
    assert set(named) == set(leaves)
    # each leaf within 2e-5 of the larger of its norm and the median leaf's
    # (a key's bias has a gradient of rounding noise alone, as under softmax)
    median = float(np.median([float(g.norm()) for g in grads if g is not None]))
    for (name, leaf), g in zip(leaves.items(), grads):
        got = named[name].grad
        if g is None:  # the selection bias takes no gradient, on either side
            assert name.endswith("router.bias") and got is None, name
            continue
        assert got is not None, name
        scale = max(float(g.norm()), median)
        assert float((got - g).norm()) < 2e-5 * scale, name


def test_expert_shares_add_up_to_the_uncut_layer():
    """The parts of the result of the two shares of four experts each, the
    shared expert counted once, add up to the reference's layer holding all
    eight."""
    cfg = program_config()
    rcfg = reference_config(cfg)
    g = torch.Generator().manual_seed(5)
    h, inner, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.router_experts
    whole = {"x.router.weight": 0.3 * torch.randn(e, h, generator=g),
             "x.router.bias": 0.05 * torch.randn(e, generator=g),
             "x.experts.gate_up": 0.3 * torch.randn(e, h, 2 * inner, generator=g),
             "x.experts.down": 0.3 * torch.randn(e, inner, h, generator=g)}
    for n in ("gate_proj", "up_proj"):
        whole[f"x.shared.{n}.weight"] = 0.3 * torch.randn(2 * inner, h, generator=g)
    whole["x.shared.down_proj.weight"] = 0.3 * torch.randn(h, 2 * inner, generator=g)
    x = torch.randn(37, h, generator=g)
    uncut = ref.expert_layer(ref.Numerics(), whole, dict(rcfg, n_routed_experts=e), "x", x)
    shared = ref._swiglu(ref.Numerics(), whole, "x.shared", x)
    total = torch.zeros_like(x)
    held = cfg.held_experts
    for first in range(0, e, held):
        layer = ExpertLayer(dataclasses.replace(cfg, first_held_expert=first), torch.float32)
        state = {k[2:]: v for k, v in whole.items() if "experts." not in k}
        state["experts.gate_up"] = whole["x.experts.gate_up"][first:first + held]
        state["experts.down"] = whole["x.experts.down"][first:first + held]
        layer.load_state_dict(state, strict=True)
        with torch.no_grad():
            total += layer(x[None])[0] - shared
    torch.testing.assert_close(total + shared, uncut, atol=1e-5, rtol=1e-5)
    assert rel_gap(total, torch.zeros_like(total) + 1e-9) > 0  # the routed part is not empty


def test_a_later_token_leaves_earlier_states_unchanged():
    cfg = program_config()
    model = program(cfg, random_params(ref.param_shapes(reference_config(cfg)), seed=1))
    batch, pixels, _ = make_batch(seed=4)
    positions = torch.arange(18)[None].expand(4, 18)
    with torch.no_grad():
        a = model(batch["input_ids"], batch["attention_mask"], batch["token_type_ids"], pixels,
                  positions)
        ids = batch["input_ids"].clone()
        ids[:, 10] = 7 + (ids[:, 10] % 20)
        b = model(ids, batch["attention_mask"], batch["token_type_ids"], pixels, positions)
    torch.testing.assert_close(a[:, :10], b[:, :10], atol=1e-6, rtol=1e-6)
    assert (a[:, 10:] - b[:, 10:]).abs().max() > 1e-3


def test_the_selection_bias_moves_the_choice_not_the_weights():
    cfg = program_config()
    g = torch.Generator().manual_seed(2)
    scores = torch.rand(9, cfg.router_experts, generator=g).requires_grad_(True)
    bias = torch.zeros(cfg.router_experts, requires_grad=True)
    chosen, experts = kimi_vl.choose(scores, bias, 3)
    lifted = bias.detach().clone()
    lifted[5] = 10.0
    chosen2, experts2 = kimi_vl.choose(scores, lifted, 3)
    assert not (experts == 5).all() and (experts2 == 5).any(dim=-1).all()
    # the weights are the scores of the chosen experts, whatever the bias
    torch.testing.assert_close(chosen2, scores.gather(-1, experts2))
    assert torch.equal(chosen, scores.gather(-1, experts))
    chosen.sum().backward()
    assert bias.grad is None
    assert torch.equal(scores.grad, torch.zeros_like(scores).scatter(-1, experts, 1.0))
    # AdamW steps of a layer (the first at a learning rate of 0) leave its
    # bias where it was
    layer = ExpertLayer(cfg, torch.float32)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.1)
    held = layer.router.bias.detach().clone()
    weight = layer.router.weight.detach().clone()
    opt = make_optimizer(layer, 1e-2, 10, warmup_ratio=0.0)
    x = torch.randn(1, 7, cfg.hidden_size, generator=g)
    for _ in range(2):
        layer(x).square().sum().backward()
        assert layer.router.bias.grad is None and layer.router.weight.grad.any()
        assert opt.step()
    assert torch.equal(layer.router.bias.detach(), held)
    assert not torch.equal(layer.router.weight.detach(), weight)


@pytest.mark.parametrize("fault", ["top5", "no_scaling"])
def test_a_planted_routing_fault_fails_the_comparison(fault):
    """The program routing over five of its six slots, or without the
    scaling factor, reads far outside the agreement the sound program
    keeps (the states within 1e-5)."""
    cfg = program_config()
    rcfg = reference_config(cfg)
    params = random_params(ref.param_shapes(rcfg))
    bad = (dataclasses.replace(cfg, experts_per_token=cfg.experts_per_token - 1)
           if fault == "top5" else dataclasses.replace(cfg, routed_scaling_factor=1.0))
    batch, pixels, positions = make_batch()
    with torch.no_grad():
        got = run_program(program(bad, params), batch, pixels, positions)
        want = ref.forward(params, rcfg, batch, pixels, positions)
    assert rel_gap(got, want) > 1e-3


def test_registry_defaults_are_the_configuration_files_widths():
    c = KimiVLConfig()
    want = dict(hidden_size="hidden_size", num_heads="num_attention_heads",
                num_layers="num_hidden_layers", intermediate_size="intermediate_size",
                moe_intermediate_size="moe_intermediate_size",
                first_dense_layers="first_k_dense_replace", router_experts="router_experts",
                held_experts="n_routed_experts", first_held_expert="first_held_expert",
                experts_per_token="num_experts_per_tok", shared_experts="n_shared_experts",
                routed_scaling_factor="routed_scaling_factor", kv_lora_rank="kv_lora_rank",
                qk_nope_head_dim="qk_nope_head_dim", qk_rope_head_dim="qk_rope_head_dim",
                v_head_dim="v_head_dim", rope_theta="rope_theta", rms_norm_eps="rms_norm_eps",
                kv_a_norm_eps="kv_a_norm_eps", vocab_size="vocab_size", num_images="num_images")
    for field, key in want.items():
        assert getattr(c, field) == CONFIG[key], field
    v = c.vision
    assert (v.hidden_size, v.num_layers, v.num_heads, v.intermediate_size, v.image_size,
            v.patch_size, v.layer_norm_eps) == tuple(CONFIG[k] for k in (
                "vision_hidden_size", "vision_layers", "vision_heads",
                "vision_intermediate_size", "image_size", "patch_size",
                "vision_layer_norm_eps"))
    assert IMAGE_INPUT["KimiVLKGC"] == ("pixels", CONFIG["image_size"])
    assert DEFAULT_ATTENTION["KimiVLKGC"] == CONFIG["attention"] == "flash"
    # what the benchmark passes, on the meta device: the reference's leaves
    with torch.device("meta"):
        model = create_model(CONFIG["model_class"], vocab_size=CONFIG["vocab_size"],
                             dtype=CONFIG["dtype"], attention=CONFIG["attention"],
                             hidden_size=CONFIG["hidden_size"],
                             num_layers=CONFIG["num_layers"], num_heads=CONFIG["num_heads"],
                             intermediate_size=CONFIG["intermediate_size"],
                             max_position_embeddings=CONFIG["max_position_embeddings"])
    shapes = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    assert shapes == ref.param_shapes(CONFIG)
    assert abs(sum(math.prod(s) for s in shapes.values()) / 1e9 - 1.6126) < 1e-3


def _moe_spans(rec):
    return [s for s in rec.spans if s.name.startswith("moe.")]


def test_moe_spans_nest_and_carry_the_step_id():
    """A tiny fit through MarTTrainer: each expert layer's five spans in
    every step's forward, under ``step.forward``, and ``moe.experts`` again
    in its backward, under ``step.backward``; each with the step's id."""
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    cfg = program_config()
    model = program(cfg, random_params(ref.param_shapes(reference_config(cfg))))
    spec = dict(split="train", examples=8, mode_counts=[3, 3, 2], batch_size=4,
                max_seq_length=20, prompt_length=[16, 20])
    feats = traffic.make_split(spec, dict(vocab=VOCAB, analogy_entities=ENTITIES), 9)

    class Vocab:
        analogy_entity_ids = np.arange(30, 30 + ENTITIES)
        analogy_relation_ids = np.zeros(0, np.int64)

    trainer = MarTTrainer(model, Vocab(), TrainConfig(max_epochs=1, batch_size=4, seed=1,
                                                      check_val_every_n_epoch=2),
                          device="cpu")
    trainer.set_image_table(torch.randn(ENTITIES + 1, 3, 32, 32))
    with profiling.recording() as rec:
        trainer.fit(feats, feats)
    spans = {s.id: s for s in rec.spans}
    moe = _moe_spans(rec)
    layers = cfg.num_layers - cfg.first_dense_layers
    names = [s.name for s in moe]
    for name in ("moe.route", "moe.dispatch", "moe.shared", "moe.combine"):
        assert names.count(name) == 2 * layers, name
    assert names.count("moe.experts") == 2 * 2 * layers  # forward and backward, two steps

    def ancestors(s):
        out = []
        while s.parent is not None:
            s = spans[s.parent]
            out.append(s.name)
        return out

    steps = set()
    for s in moe:
        up = ancestors(s)
        assert "step.forward" in up or "step.backward" in up, (s.name, up)
        assert s.step is not None
        steps.add(s.step)
    assert len(steps) == 2
    backward = [s for s in moe if "step.backward" in ancestors(s)]
    assert {s.name for s in backward} == {"moe.experts"} and len(backward) == 2 * layers


def test_counters_count_a_known_routing_exactly():
    """Router rows at zero and a bias that ranks the experts: every token
    takes experts 0, 1, 2, of which the layer holding 0-3 holds all three
    and the layer holding 4-7 none."""
    cfg = program_config()
    torch.manual_seed(0)
    x = torch.randn(1, 11, cfg.hidden_size)
    for first, held_slots in ((0, 3), (4, 0)):
        layer = ExpertLayer(dataclasses.replace(cfg, first_held_expert=first), torch.float32)
        for p in layer.parameters():
            torch.nn.init.normal_(p, std=0.1)
        with torch.no_grad():
            layer.router.weight.zero_()
            layer.router.bias.copy_(-torch.arange(cfg.router_experts, dtype=torch.float32))
        before = (kimi_vl.TOKENS_ROUTED_HELD, kimi_vl.MOE_CALLS, kimi_vl.GROUPED_PRODUCTS)
        y = layer(x)
        assert (kimi_vl.TOKENS_ROUTED_HELD - before[0], kimi_vl.MOE_CALLS - before[1],
                kimi_vl.GROUPED_PRODUCTS - before[2]) == (11 * held_slots, 1, 2)
        y.sum().backward()
        assert kimi_vl.GROUPED_PRODUCTS - before[2] == 6
        assert layer.experts.gate_up.grad is not None
        assert bool(layer.experts.gate_up.grad.any()) == (held_slots > 0)


def test_tracing_off_costs_nothing():
    """Off, every span is the one shared no-op and the layer records
    nothing; on, the result is bit for bit the same."""
    assert profiling.span("moe.route") is profiling.span("moe.experts")
    cfg = program_config()
    layer = ExpertLayer(cfg, torch.float32)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(1, 13, cfg.hidden_size)
    with torch.no_grad():
        off = layer(x)
        with profiling.recording() as rec:
            on = layer(x)
    assert torch.equal(off, on)
    assert sorted({s.name for s in rec.spans}) == ["moe.combine", "moe.dispatch",
                                                   "moe.experts", "moe.route", "moe.shared"]
