#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the quickest proof that
the port builds, is right and runs its main path on the GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, prints its traceback and
exits non-zero:

1. card    — name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel under mkg_analogy_tpu_torch/csrc;
3. kernel  — the fused-attention kernel against its plain PyTorch version
             at the three main-path shapes, B=128: fp32 (TF32 off) at atol
             2e-5, bf16 at 2e-2, and fp32 with dropout (same seed, so the
             masks must agree) at 2e-5; times of the kernel, the plain
             version and scaled_dot_product_attention (a yardstick only,
             at the two vision shapes; no single PyTorch call applies the
             analogy multiplier of the text shape), and the bound;
4. model   — a full-width UnimoForMaskedLM (random weights from a seed,
             B=32, L=128, two 224-px images) forward through the kernel and
             through the plain version: fp32 logits within 1e-3, bf16
             difference and top-1 agreement reported, 24 launches a forward;
5. cli     — ``mkg_analogy_tpu_torch.cli.main --only_test`` at full width
             on a small MARS/MarKG-format dataset written here, in bf16
             through the kernel (the main path): finite metrics, 24 launches
             per eval batch; then in fp32 through the kernel and through the
             plain attention (``--fused_attention 0``): identical ranks.

Then the ``{"kernels": [...]}`` line, the card line, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``mkg_analogy_tpu_torch`` beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12   # H100 SXM data sheet, dense bf16 tensor cores
BATCH = 128                 # --eval_batch_size default
HEADS, HEAD_DIM = 12, 64
# (name, Lq, Lk, analogy geometry, launches per forward): 12 text layers,
# 8 vision layers, 4 vision layers over the previous text layer's K/V
SHAPES = [("text", 128, 128, True, 12), ("vision", 99, 99, False, 8),
          ("vision_text", 99, 227, False, 4)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, samples=21, per_sample=10):
    """Median over ``samples`` of the mean time of ``per_sample``
    back-to-back calls, by CUDA events. A device-side sleep ahead of each
    sample lets the host enqueue the calls before the card reaches them,
    so host launch overhead is not timed."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def device_profile(fn, top=12):
    """Device time of one call of ``fn`` by kernel name (torch.profiler):
    the total and the ``top`` names with their ms and call counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return dict(device_ms=sum(r[1] for r in rows),
                top=[dict(name=n[:90], ms=ms, calls=c) for n, ms, c in rows[:top]])


def bound_times(b, lq, lk, dtype_bytes):
    """(ms for the bytes, ms for the operations) of one call: each input
    read once (q, k, v, the fp32 mask, the int32 boundary) and the output
    written once, over the HBM rate; the QK^T and PV products over the bf16
    tensor-core peak. The bound is the larger of the two."""
    hd = HEADS * HEAD_DIM
    nbytes = (b * lq * hd + 2 * b * lk * hd + b * lq * hd) * dtype_bytes + b * lk * 4 + b * 4
    flops = 4 * b * HEADS * lq * lk * HEAD_DIM
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def bound_by(t_bytes, t_ops):
    return "bytes" if t_bytes >= t_ops else "operations"


def attention_inputs(lq, lk, geometry, dtype, device, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    hd = HEADS * HEAD_DIM
    q, k, v = (torch.randn(BATCH, n, hd, generator=g).to(device, dtype)
               for n in (lq, lk, lk))
    text_len = torch.randint(40, 129, (BATCH,), generator=g)
    text_mask = (torch.arange(128)[None] < text_len[:, None]).float()
    if geometry:                       # text self-attention, padded prompts
        mask = text_mask
    elif lk == lq:                     # vision self-attention
        mask = torch.ones(BATCH, lk)
    else:                              # vision over [text K/V ; vision]
        mask = torch.cat([text_mask, torch.ones(BATCH, lq)], dim=1)
    kw = {}
    if geometry:
        kw = dict(boundary=(text_len // 2).to(device, torch.int32),
                  w0=torch.tensor([0.3], device=device),
                  w1=torch.tensor([0.7], device=device))
    return q, k, v, mask.to(device), kw


def kernel_phase(device):
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.kernels import attention as attn

    rows = []
    for name, lq, lk, geometry, per_fwd in SHAPES:
        row = dict(shape=name, B=BATCH, Lq=lq, Lk=lk, heads=HEADS,
                   head_dim=HEAD_DIM, launches_per_forward=per_fwd)
        checks = [("fp32", torch.float32, 2e-5, {}),
                  ("bf16", torch.bfloat16, 2e-2, {}),
                  ("fp32_dropout", torch.float32, 2e-5,
                   dict(dropout_rate=0.1, deterministic=False, dropout_seed=1234))]
        for tag, dtype, atol, extra in checks:
            q, k, v, mask, kw = attention_inputs(lq, lk, geometry, dtype, device, seed=lq + lk)
            kw = dict(kw, compute_dtype=dtype, **extra)
            got = attn.fused_attention(q, k, v, mask, HEADS, **kw)
            want = attn.fused_attention_reference(q, k, v, mask, HEADS, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            row[f"max_abs_err_{tag}"] = err
            if not err <= atol:
                raise AssertionError(f"{name} {tag}: kernel vs plain {err} > {atol}")
        # timing in the main path's dtype
        q, k, v, mask, kw = attention_inputs(lq, lk, geometry, torch.bfloat16, device, seed=7)
        kw = dict(kw, compute_dtype=torch.bfloat16)
        row["kernel_ms"] = time_ms(lambda: attn.fused_attention(q, k, v, mask, HEADS, **kw))
        row["plain_ms"] = time_ms(
            lambda: attn.fused_attention_reference(q, k, v, mask, HEADS, **kw))
        row["library_ms"] = None
        if not geometry:
            def heads(x):
                return x.view(BATCH, x.shape[1], HEADS, HEAD_DIM).transpose(1, 2)

            qh, kh, vh = heads(q), heads(k), heads(v)
            bias = None
            if lk != lq:
                bias = ((1.0 - mask) * -10000.0).to(torch.bfloat16)[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

            want = attn.fused_attention_reference(q, k, v, mask, HEADS, **kw)
            lib = sdpa().transpose(1, 2).reshape(want.shape)
            row["library_max_abs_err_bf16"] = (lib.float() - want.float()).abs().max().item()
            row["library_ms"] = time_ms(sdpa)
        row["bytes_ms"], row["operations_ms"] = bound_times(BATCH, lq, lk, 2)
        row["bound_ms"] = max(row["bytes_ms"], row["operations_ms"])
        row["bound_by"] = bound_by(row["bytes_ms"], row["operations_ms"])
        rows.append(row)
        emit(dict(phase="kernel", **row))
    return rows


def model_phase(device):
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.models.common import AttentionCore
    from mkg_analogy_tpu_torch.models.unimo import UnimoConfig, UnimoForMaskedLM

    b, length = 32, 128
    g = torch.Generator().manual_seed(0)
    lens = torch.randint(48, length + 1, (b,), generator=g)
    batch = dict(
        input_ids=torch.randint(0, 42112, (b, length), generator=g),
        attention_mask=(torch.arange(length)[None] < lens[:, None]).int(),
        token_type_ids=torch.zeros(b, length, dtype=torch.int32),
        pixel_values=torch.randn(b, 2, 3, 224, 224, generator=g),
        positions=torch.randint(0, 48, (b, 5), generator=g),
        boundary=(lens // 2).int(),
    )
    batch = {k: v.to(device) for k, v in batch.items()}
    vocab_ids = torch.arange(20000, 22063, device=device)
    out = {}
    state = None
    for dtype in ("float32", "bfloat16"):
        with torch.device(device):
            model = UnimoForMaskedLM(UnimoConfig(dtype=dtype))
        if state is None:
            model.init_params(torch.Generator(device=device).manual_seed(0))
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        results = {}
        for fused in (True, False):
            for m in model.modules():
                if isinstance(m, AttentionCore):
                    m.fused = fused
            with torch.inference_mode():
                before = attn.LAUNCHES
                logits = model.logits(model(**batch)[:, 0], vocab_ids=vocab_ids)
                torch.cuda.synchronize()
                launches = attn.LAUNCHES - before
                t = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    model(**batch)
                    torch.cuda.synchronize()
                    t.append((time.perf_counter() - t0) * 1e3)
                if fused and dtype == "bfloat16":
                    out["profile_bf16_kernel_forward"] = device_profile(
                        lambda: model(**batch))
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{dtype}: non-finite logits")
            expect = 24 if fused else 0
            if launches != expect:
                raise AssertionError(f"{dtype} fused={fused}: {launches} launches, "
                                     f"expected {expect}")
            results[fused] = (logits.float(), statistics.median(t))
        (lk, tk), (lp, tp) = results[True], results[False]
        diff = (lk - lp).abs().max().item()
        top1 = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        out[dtype] = dict(max_abs_logit_diff=diff, top1_agreement=top1,
                          forward_ms_kernel=tk, forward_ms_plain=tp,
                          launches_per_forward=24)
        if dtype == "float32" and not diff <= 1e-3:
            raise AssertionError(f"fp32 logits: kernel vs plain {diff} > 1e-3")
        del model
    emit(dict(phase="model", B=b, L=length, **out))
    return out


WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lamda mu nu "
         "xi omicron pi rho sigma tau upsilon").split()


def write_dataset(root, n_ent=64, n_rel=8, n_triples=200, n_test=200, seed=0):
    """A small MarKG + MARS in the reference file formats (the layout of
    tests/util.make_tiny_dataset, larger)."""
    rng = random.Random(seed)
    markg, mars = os.path.join(root, "MarKG"), os.path.join(root, "MARS")
    os.makedirs(markg)
    os.makedirs(mars)
    ents = [f"Q{i}" for i in range(n_ent)]
    rels = [f"P{i}" for i in range(n_rel)]
    with open(os.path.join(markg, "entity2text.txt"), "w") as f:
        for i, e in enumerate(ents):
            f.write(f"{e}\tentity {i} {' '.join(rng.choices(WORDS, k=rng.randint(2, 6)))}\n")
    with open(os.path.join(markg, "relation2text.txt"), "w") as f:
        for i, r in enumerate(rels):
            f.write(f"{r}\trelation {WORDS[i]}\n")
    with open(os.path.join(markg, "wiki_tuple_ids.txt"), "w") as f:
        for _ in range(n_triples):
            f.write(f"{rng.choice(ents)}\t{rng.choice(rels)}\t{rng.choice(ents)}\n")
    analogy_ents, analogy_rels = ents[: n_ent // 2], rels[: n_rel // 2]
    with open(os.path.join(mars, "analogy_entities.txt"), "w") as f:
        f.write("\n".join(analogy_ents) + "\n")
    with open(os.path.join(mars, "analogy_relations.txt"), "w") as f:
        f.write("\n".join(analogy_rels) + "\n")
    for split, n in (("train", 16), ("dev", 16), ("test", n_test)):
        with open(os.path.join(mars, f"{split}.json"), "w") as f:
            for i in range(n):
                f.write(json.dumps(dict(
                    example=[rng.choice(ents), rng.choice(ents)],
                    question=rng.choice(ents), answer=rng.choice(analogy_ents),
                    relation=rng.choice(analogy_rels), mode=i % 3)) + "\n")
    return markg, mars


def cli_phase():
    """The main path: the CLI's --only_test evaluation in bf16 through the
    kernel (launches counted from 0). Then the reference check: the same
    evaluation in fp32 through the kernel and through the plain attention
    must rank at least 99% of the examples alike (fp32 differences are
    summation-order ulps, far below the logit gaps of almost every
    example). The bf16 plain run is only
    reported: with random weights BertFusion's unscaled softmax over
    768-wide dot products is near-argmax, so last-bit differences in the
    text context can move its choice of vision token."""
    import numpy as np

    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import attention as attn

    n_test = 200
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=".") as root:
        markg, mars = write_dataset(root, n_test=n_test)
        for dtype, fused in (("bfloat16", "1"), ("float32", "1"), ("float32", "0"),
                             ("bfloat16", "0")):
            out_dir = os.path.join(root, f"out_{dtype}_{fused}")
            argv = ["--data_dir", mars, "--pretrain_path", markg, "--only_test",
                    "--device", "cuda", "--fused_attention", fused,
                    "--dtype", dtype, "--max_seq_length", "128",
                    "--image_features", "synthetic",
                    "--output_dir", out_dir, "--log_dir", os.path.join(root, "logs"),
                    "--cache_dir", os.path.join(root, "cache")]
            attn.LAUNCHES = 0
            t0 = time.perf_counter()
            metrics = cli.main(argv)
            seconds = time.perf_counter() - t0
            launches = attn.LAUNCHES
            ranks = np.load(os.path.join(out_dir, "test_ranks.npz"))["ranks"]
            runs[dtype, fused] = (metrics, launches, ranks, seconds)
    n_batches = math.ceil(n_test / 128)
    for (dtype, fused), (metrics, launches, ranks, _) in runs.items():
        expect = 24 * n_batches if fused == "1" else 0
        if launches != expect:
            raise AssertionError(f"cli {dtype} --fused_attention {fused}: "
                                 f"{launches} launches, expected {expect}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cli {dtype}: non-finite metrics {metrics}")
        if not 0.0 < metrics["Eval_entity/mrr"] <= 1.0 or len(ranks) != n_test:
            raise AssertionError(f"cli {dtype}: mrr {metrics['Eval_entity/mrr']}, "
                                 f"{len(ranks)} ranks")
    fp32_same = float((runs["float32", "1"][2] == runs["float32", "0"][2]).mean())
    if fp32_same < 0.99:
        raise AssertionError(f"cli fp32: kernel and plain attention rank alike "
                             f"for only {fp32_same} of the examples")
    metrics, launches, ranks, seconds = runs["bfloat16", "1"]
    plain_metrics, _, plain_ranks, plain_seconds = runs["bfloat16", "0"]
    emit(dict(phase="cli", dtype="bfloat16", examples=n_test, eval_batches=n_batches,
              launches=launches, mrr=metrics["Eval_entity/mrr"],
              hits1=metrics["Eval_entity/hits1"], hits10=metrics["Eval_entity/hits10"],
              seconds=seconds, fp32_rank_agreement_kernel_vs_plain=fp32_same,
              fp32_mrr=runs["float32", "1"][0]["Eval_entity/mrr"],
              bf16_plain_mrr=plain_metrics["Eval_entity/mrr"],
              bf16_rank_agreement_kernel_vs_plain=float((ranks == plain_ranks).mean()),
              bf16_plain_seconds=plain_seconds))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    try:
        from mkg_analogy_tpu_torch.kernels import build
    except ImportError:
        print("chip_smoke: run it from the repository root (needs the "
              "mkg_analogy_tpu_torch package)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    card = card_line()
    emit(dict(phase="card", card=card, torch=torch.__version__,
              cuda=torch.version.cuda))
    t0 = time.perf_counter()
    build.build()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              kernels=sorted(p.stem for p in build.CSRC.glob("*.cu"))))
    rows = kernel_phase(device)
    model_phase(device)
    launches = cli_phase()

    def per_forward(key):
        return sum(r[key] * r["launches_per_forward"] for r in rows)

    t_bytes, t_ops = per_forward("bytes_ms"), per_forward("operations_ms")
    emit({"kernels": [dict(
        name="fused_attention_fwd", route="cuda",
        source="mkg_analogy_tpu_torch/csrc/fused_attention_fwd.cu",
        replaces="mkg_analogy_tpu/kernels/attention.py:124",
        ok=True, launches=launches,
        max_abs_err=max(r["max_abs_err_bf16"] for r in rows),
        max_abs_err_fp32=max(r["max_abs_err_fp32"] for r in rows),
        # per full-width forward at B=128: 12 text + 8 vision + 4 vision-text calls
        ms=per_forward("kernel_ms"), plain_ms=per_forward("plain_ms"),
        bound_ms=max(t_bytes, t_ops), bound_by=bound_by(t_bytes, t_ops),
        library_ms=None,  # no single PyTorch call applies the analogy multiplier
        shapes=rows,
    )]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
