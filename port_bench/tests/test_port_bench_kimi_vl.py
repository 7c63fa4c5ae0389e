"""The arithmetic of the ``kimi_vl_a3b`` configuration: its FLOP count
against ``FlopCounterMode`` over the reference's forward at small widths,
the causal bounds against the flash bounds they extend, and the full-width
counts PERF.md uses."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from port_bench import bounds, bounds_mla, traffic, weights
from port_bench.harness import Bench

SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
             intermediate_size=48, moe_intermediate_size=16, router_experts=8,
             n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=2, kv_lora_rank=16,
             qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8, image_size=32,
             patch_size=16, vision_hidden_size=16, vision_layers=1, vision_heads=2,
             vision_intermediate_size=32, analogy_entities=20,
             vocab=dict(entity_token_start=30, word_tokens=[5, 30], pad_id=0, cls_id=1,
                        sep_id=2, mask_id=3, r_id=4))


def test_forward_flops_match_the_reference_with_every_expert_held():
    """With every expert held each token's k slots are computed, so the count
    is exact; the reference computes the whole score plane, the count the
    causal half."""
    bench = Bench(ROOT)
    cfg = {**json.loads((ROOT / "port_bench" / "configs" / "kimi_vl_a3b.json").read_text()),
           **SMALL}
    ref, flops = bench.reference(cfg), bench.flops("kimi_vl_a3b")
    spec = dict(split="train", examples=3, mode_counts=[1, 1, 1], batch_size=3,
                max_seq_length=20, prompt_length=[16, 20])
    feats = traffic.make_split(spec, cfg, seed=3)
    batch = {k: torch.as_tensor(v) for k, v in feats.items()}
    params = weights.make_params(ref.param_shapes(cfg), cfg["init"], 5, "cpu")
    pixels = torch.randn(3, 2, 3, 32, 32)
    positions = torch.stack([batch["mask_idx"], batch["rel_idx"][:, 0], batch["rel_idx"][:, 1],
                             batch["q_head_idx"], batch["a_head_idx"]], dim=1)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        trans = ref.forward(params, cfg, batch, pixels, positions)
        ref.logits(params, trans[:, 0], torch.arange(30, 50))
    n = flops.image_tokens(cfg) + 20
    above = n * n - flops.causal_pairs(n)
    masked = 2 * cfg["num_attention_heads"] * above * (8 + 8 + 8) * cfg["num_hidden_layers"]
    assert counter.get_total_flops() == 3 * (flops.forward_flops(cfg, 20) + masked)


def test_flops_and_parameters_at_full_width():
    """283.8 GFLOP a forward an example at L=128 (27.2 TFLOP a training step
    at B=32); 1.61 B parameters."""
    bench = Bench(ROOT)
    cfg = bench.config("kimi_vl_a3b")
    assert 283e9 < bench.flops("kimi_vl_a3b").forward_flops(cfg, 128) < 284.5e9
    shapes = bench.reference(cfg).param_shapes(cfg)
    assert 1.61e9 < sum(torch.Size(s).numel() for s in shapes.values()) < 1.615e9


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_causal_bounds_extend_the_flash_bounds(kernel):
    """Without the mask and with d_v = d the bounds are bounds.py's; causal,
    the operations are those of the pairs on and below the diagonal."""
    full = bounds.flash_bound_s(kernel, 24, 12, 128, 128, 64, "bfloat16")
    assert bounds_mla.flash_bound_s(kernel, 24, 12, 128, 128, 64, 64, False,
                                    "bfloat16") == pytest.approx(full, rel=1e-12)
    causal = bounds_mla.flash_bound_s(kernel, 24, 12, 128, 128, 64, 64, True, "bfloat16")
    assert causal[0] == pytest.approx(full[0], rel=1e-12)
    assert causal[1] == pytest.approx(full[1] * (128 * 129 / 2) / 128 ** 2, rel=1e-12)


def test_grouped_bounds_count_each_side_once():
    """A row-grouped product reads its rows and each expert's weight once and
    writes its rows; a weight gradient writes one matrix an expert."""
    t = bounds_mla.grouped_bound_s([(100, 64, 32, "b")], 8, "bfloat16")
    want = max((100 * 64 + 8 * 64 * 32 + 100 * 32) * 2 / bounds.HBM_BYTES_PER_S,
               2 * 100 * 64 * 32 / bounds.PEAK_FLOPS_PER_S["bfloat16"])
    assert t == pytest.approx(want, rel=1e-12)
    t = bounds_mla.grouped_bound_s([(64, 100, 32, "out")], 8, "bfloat16")
    want = (64 * 100 + 100 * 32 + 8 * 64 * 32) * 2 / bounds.HBM_BYTES_PER_S
    assert t == pytest.approx(want, rel=1e-12)


def _fake_run(bench, config, kernels):
    """What the readers read of a traced fine-tune run: its configuration,
    FLOP module, batch and length, and a slice of one step whose kernels'
    device seconds are ``kernels``."""
    cfg = bench.config(config)
    slice_ = SimpleNamespace(units=1, kernels=kernels,
                             kernel_time=lambda match: sum(s for n, s in kernels.items()
                                                           if match(n)))
    return SimpleNamespace(config=cfg, flops=bench.flops(cfg["flops"]), batch=32, seq_len=128,
                           dtype="bfloat16", phase="finetune", slice=slice_)


def test_the_attention_roofline_covers_every_flash_call_of_the_cell():
    """The bound of latent attention's causal calls and of the image tower's
    plain ones over the time of every flash kernel, whatever its width;
    nothing for a configuration without causal calls."""
    bench = Bench(ROOT)
    reader = bench.metric_reader("mla_attention_roofline.train.bf16")
    kernels = {"void (anonymous namespace)::fwd_streaming_kernel<192>(Args)": 0.004,
               "void (anonymous namespace)::dkv_kernel<192>(Args)": 0.010,
               "void (anonymous namespace)::dq_kernel<64>(Args)": 0.002,
               "void (anonymous namespace)::fwd_resident_kernel<64, 2>(Args)": 0.002,
               "void at::native::vectorized_elementwise_kernel<4>": 1.0}
    run = _fake_run(bench, "kimi_vl_a3b", kernels)
    calls = run.flops.attention_calls(run.config, 32, 128)
    assert sorted(c.get("causal", False) for c in calls) == [False, True]
    bound = sum(c["count"] * bounds_mla.call_bound_s(c, "bfloat16", backward=True)
                for c in calls)
    assert reader.read(run) == pytest.approx(100.0 * bound / 0.018, rel=1e-12)
    assert reader.read(_fake_run(bench, "flava_bf16", kernels)) is None


def test_the_expert_roofline_takes_its_rows_from_the_traffic(monkeypatch):
    """Each expert layer's grouped products at a step's tokens times the
    expected held slots of a token (32 x 228 x 0.75), over the device time
    in ``moe.experts``; the program's counters play no part."""
    from port_bench import spans

    bench = Bench(ROOT)
    reader = bench.metric_reader("expert_roofline.train.bf16")
    run = _fake_run(bench, "kimi_vl_a3b", {})
    joined = SimpleNamespace(device={None: 5e6, 1: 3e6, 2: 7e6}, units=2,
                             within=lambda sid, names: sid == 2 and names == ("moe.experts",))
    monkeypatch.setattr(spans, "joined", lambda run, phase: joined)
    cfg = run.config
    rows = 32 * 228 * 6 * 8 / 64
    bound = 13 * bounds_mla.grouped_bound_s(run.flops.expert_products(cfg, rows), 8, "bfloat16")
    assert reader.read(run) == pytest.approx(100.0 * bound * 2 / 7e-3, rel=1e-12)
    joined.within = lambda sid, names: False
    assert reader.read(run) is None
