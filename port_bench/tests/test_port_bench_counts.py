"""The benchmark's arithmetic: each configuration's FLOP count against
``FlopCounterMode`` over the reference's forward at small widths, and the
attention bounds against the figures of the port's kernel table."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, tiny_config, tiny_traffic
from port_bench import bounds, traffic, weights
from port_bench.harness import Bench


@pytest.mark.parametrize("config", ["mkgformer", "flava"])
def test_forward_flops_match_the_reference(config):
    bench = Bench(ROOT)
    cfg = tiny_config(config)
    ref = bench.reference(cfg)
    flops = bench.flops(config)
    t = tiny_traffic("mars_train_b32")
    feats = traffic.make_split(t, cfg, seed=3)
    b = 3
    batch = {k: torch.as_tensor(v[:b]) for k, v in feats.items()}
    params = weights.make_params(ref.param_shapes(cfg), cfg["init"], 5, "cpu")
    pixels = torch.randn(b, 2, 3, cfg["image_size"], cfg["image_size"])
    positions = torch.stack([batch["mask_idx"], batch["rel_idx"][:, 0], batch["rel_idx"][:, 1],
                             batch["q_head_idx"], batch["a_head_idx"]], dim=1)
    ids = torch.arange(300, 300 + cfg["analogy_entities"])
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        trans = ref.forward(params, cfg, batch, pixels, positions)
        ref.logits(params, trans[:, 0], ids)
    assert counter.get_total_flops() == b * flops.forward_flops(cfg, t["max_seq_length"])


def test_flops_at_full_width():
    """The full-width counts the PERF.md predictions use: ~43 GFLOP an
    MKGformer forward, ~145 a FLAVA forward, at L=128."""
    bench = Bench(ROOT)
    mk = bench.flops("mkgformer").forward_flops(bench.config("mkgformer"), 128)
    fl = bench.flops("flava").forward_flops(bench.config("flava"), 128)
    assert 42e9 < mk < 44e9
    assert 143e9 < fl < 147e9


@pytest.mark.parametrize("lq,lk,want_ms", [(128, 128, 0.0301), (99, 99, 0.0233),
                                            (99, 227, 0.0383)])
def test_single_block_bounds_match_the_kernel_table(lq, lk, want_ms):
    """Row 1 bf16 at B=128, 12 heads of 64: the byte bounds of PERF.md."""
    t_bytes, t_ops = bounds.fwd_bound_s(128, 12, lq, lk, 64, "bfloat16")
    assert t_bytes > t_ops
    assert round(t_bytes * 1e3, 4) == want_ms


@pytest.mark.parametrize("lq,lk,want_ms", [(128, 128, 0.01315), (99, 99, 0.01017),
                                            (99, 227, 0.01769)])
def test_backward_bounds_match_the_kernel_table(lq, lk, want_ms):
    """Row 2 bf16 at B=32: the byte bounds of PERF.md."""
    t_bytes, _ = bounds.bwd_bound_s(32, 12, lq, lk, 64, "bfloat16")
    assert round(t_bytes * 1e3, 5) == want_ms


@pytest.mark.parametrize("kernel,n,want_ms", [("fwd", 128, 0.0180), ("fwd", 393, 0.1700),
                                               ("fwd", 522, 0.2998), ("dkv", 522, 0.5997),
                                               ("dq", 522, 0.4498)])
def test_flash_fp32_bounds_match_the_kernel_table(kernel, n, want_ms):
    """Rows 3-5 fp32 at FLAVA's calls (B=24): the operation bounds of
    PERF.md."""
    t_bytes, t_ops = bounds.flash_bound_s(kernel, 24, 12, n, n, 64, "float32")
    assert t_ops > t_bytes
    assert round(t_ops * 1e3, 4) == want_ms
