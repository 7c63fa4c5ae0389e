#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the quickest proof that
the port builds, is right and runs its main path on the GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, prints its traceback and
exits non-zero:

1. card       — name and power limit (nvidia-smi);
2. build      — nvcc builds every kernel under mkg_analogy_tpu_torch/csrc
                (one process per source, all started together);
3. kernel     — the fused-attention forward kernel against its plain PyTorch
                version at the three main-path shapes, B=128: fp32 (TF32
                off) at atol 2e-5, bf16 at 2e-2, and fp32 with dropout (same
                seed, so the masks must agree) at 2e-5; times of the kernel,
                the plain version and scaled_dot_product_attention (a
                yardstick only, at the two vision shapes; no single PyTorch
                call applies the analogy multiplier of the text shape), and
                the bound;
4. kernel_bwd — the backward kernel against its plain version at the same
                shapes and B=32 (the training batch): dq, dk, dv and dw in
                fp32 and bf16, with and without dropout; its times, the
                plain version's, the bound, and the backward of
                scaled_dot_product_attention at the vision shapes;
5. model      — a full-width UnimoForMaskedLM (random weights from a seed,
                B=32, L=128, two 224-px images) forward through the kernel
                and through the plain version: fp32 logits within 1e-3, bf16
                difference and top-1 agreement reported, 24 launches a
                forward;
6. train      — the full-width fine-tune step (label-smoothed CE +
                alpha * relaxation, AdamW), dropout on: fp32 through the
                kernels against fp32 through the plain attention from the
                same weights, batch and seeds (loss within 1e-5 relative,
                every gradient leaf within its bound); then bf16 through the
                kernels, the main path, for 8 steps on one batch: the loss
                falls, 24 forward and 24 backward launches a step, step time
                and a device profile of one step;
7. cli        — ``mkg_analogy_tpu_torch.cli.main --only_test`` at full width
                on a small MARS/MarKG-format dataset written here, in bf16
                through the kernel: finite metrics, 24 launches per eval
                batch; then in fp32 through the kernel and through the plain
                attention (``--fused_attention 0``): identical ranks;
8. cli_train  — the main path of the fine-tune slice: the CLI fine-tune
                (``--max_epochs 1 --batch_size 32``, bf16, through the
                kernels) with dev and test evaluation and the best-dev
                checkpoint, launches counted from 0; then ``--only_test
                --checkpoint`` on that checkpoint reproduces the fit's test
                ranks exactly;
9. flash_kernel — the three flash kernels (forward, dK/dV, dQ) against
                their plain versions at the triple pre-train shapes (B=64:
                text 96x96, vision 99x99, vision-text 99x195), the analogy
                ones (128x128 with the geometry, 99x227), two Q tiles
                (512x512, B=8), two K tiles with a ragged second (99x611,
                B=8) and L=2048 (B=8, 8 x 4 tiles), fp32 and bf16, dropout 0
                and 0.1; the times of each kernel, the plain versions and
                SDPA (where no analogy multiplier applies), and the bounds;
10. pretrain  — the full-width triple pre-train step (B=64, L=96) through
                the flash kernels: fp32 against the plain attention (loss
                within 1e-5 relative, every gradient leaf within its bound),
                then 8 bf16 steps on one batch: the loss falls, 24 + 24 + 24
                launches a step, step time and a device profile;
11. long      — a full-width bf16 fine-tune step at B=8, L=512 through the
                flash kernels (multi-tile and ragged shapes inside the
                model), and a forward at L=512 on the plain route that takes
                the flash forward in the 12 text layers only (the
                auto-route);
12. cli_pretrain — the main path of this slice: ``--pretrain 1
                --fused_attention flash`` through the CLI for the triple,
                analogy and mixed formats (3 steps each, dev and test), the
                counts set to 0 before the three runs and read after them;
                then a fine-tune from the triple run's checkpoint.

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
TRAIN_BATCH = 32            # --batch_size default
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


def bwd_bound_times(b, lq, lk, dtype_bytes):
    """(ms for the bytes, ms for the operations) of one backward: q, k, v
    and g read once, dq, dk and dv written once, plus the fp32 mask and the
    int32 boundary, over the HBM rate; 10·B·heads·Lq·Lk·64 flops (QKᵀ
    recomputed, dv, dp, dq, dk) over the bf16 tensor-core peak."""
    hd = HEADS * HEAD_DIM
    nbytes = (3 * b * lq * hd + 4 * b * lk * hd) * dtype_bytes + b * lk * 4 + b * 4
    flops = 10 * b * HEADS * lq * lk * HEAD_DIM
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def attention_inputs(lq, lk, geometry, dtype, device, seed, batch=BATCH):
    import torch

    g = torch.Generator().manual_seed(seed)
    hd = HEADS * HEAD_DIM
    q, k, v = (torch.randn(batch, n, hd, generator=g).to(device, dtype)
               for n in (lq, lk, lk))
    text_len = torch.randint(40, 129, (batch,), generator=g)
    text_mask = (torch.arange(128)[None] < text_len[:, None]).float()
    if geometry:                       # text self-attention, padded prompts
        mask = text_mask
    elif lk == lq:                     # vision self-attention
        mask = torch.ones(batch, lk)
    else:                              # vision over [text K/V ; vision]
        mask = torch.cat([text_mask, torch.ones(batch, lq)], dim=1)
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


def kernel_bwd_phase(device):
    """The backward kernel against fused_attention_bwd_reference at the
    main-path shapes and the training batch. Bars, per result tensor:
    fp32 (TF32 off) 2e-5 of its largest |value| (the same fp32 math, summed
    in another order: the forward's 2e-5 bar, scaled to the gradient);
    bf16 2^-7 of its largest |value| (dq, dk and dv are rounded to bf16, and
    a term rounded at a cast point can land one bf16 ulp apart); dw0/dw1
    1e-5 of the sum of |ds·s_raw| over their region (fp32 sums of up to 6M
    terms in another order; the error scales with the terms, not with their
    cancelling sum)."""
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.kernels import attention as attn

    rows = []
    for name, lq, lk, geometry, per_fwd in SHAPES:
        row = dict(shape=name, B=TRAIN_BATCH, Lq=lq, Lk=lk, heads=HEADS,
                   head_dim=HEAD_DIM, launches_per_step=per_fwd)
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for rate in (0.0, 0.1):
                q, k, v, mask, kw = attention_inputs(lq, lk, geometry, dtype, device,
                                                     seed=lq + lk, batch=TRAIN_BATCH)
                g = torch.randn(q.shape, generator=torch.Generator().manual_seed(lq)
                                ).to(device, dtype)
                kw = dict(kw, compute_dtype=dtype, dropout_rate=rate,
                          deterministic=rate == 0.0, dropout_seed=4321)
                bnd, w, geo, r, seed = attn._resolve(
                    q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), None, 0, 0,
                    rate, rate == 0.0, 4321)
                got = attn._launch_bwd(q, k, v, mask, g, HEADS, bnd, w, geo, r, seed)
                want = attn.fused_attention_bwd_reference(q, k, v, mask, g, HEADS, **kw)
                torch.cuda.synchronize()
                key = f"{tag}{'_dropout' if rate else ''}"
                bar = 2e-5 if dtype == torch.float32 else 2.0 ** -7
                for t_name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
                    err = (a.float() - b.float()).abs().max().item()
                    top = b.float().abs().max().item()
                    row[f"max_abs_err_{t_name}_{key}"] = err
                    if not err <= bar * top:
                        raise AssertionError(f"bwd {name} {key} {t_name}: kernel vs plain "
                                             f"{err} > {bar} * {top}")
                if geometry:
                    # the scale of the dw sums: sum |ds * s_raw| over the regions
                    with torch.no_grad():
                        qf, kf = q.float(), k.float()
                        s_raw, planes, p = attn._scores(qf, kf, mask, HEADS, bnd, w, geo)
                        gh = attn._split_heads(g, HEADS, torch.float32)
                        dp = gh @ attn._split_heads(v, HEADS, torch.float32).transpose(-1, -2)
                        if r > 0.0:
                            keep = attn.dropout_keep(TRAIN_BATCH, HEADS, lq, lk, r, seed, device)
                            dp = torch.where(keep, dp / (1.0 - r), 0.0)
                        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
                        terms = (ds * s_raw).abs()
                        scales = [(terms * planes[1]).sum().item(),
                                  (terms * planes[2]).sum().item()]
                    for i in range(2):
                        err = abs(got[3][i].item() - want[3][i].item())
                        row[f"dw{i}_err_{key}"] = err
                        row[f"dw{i}_{key}"] = want[3][i].item()
                        if not err <= 1e-5 * scales[i]:
                            raise AssertionError(f"bwd {name} {key} dw{i}: {err} > 1e-5 * "
                                                 f"{scales[i]}")
                elif got[3].abs().max().item() != 0.0:
                    raise AssertionError(f"bwd {name}: dw without a geometry")
        # timing in the main path's dtype, dropout as the text tower trains
        q, k, v, mask, kw = attention_inputs(lq, lk, geometry, torch.bfloat16, device,
                                             seed=7, batch=TRAIN_BATCH)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)
                        ).to(device, torch.bfloat16)
        rate = 0.1 if geometry else 0.0
        kw = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=rate,
                  deterministic=rate == 0.0, dropout_seed=99)
        bnd, w, geo, r, seed = attn._resolve(q, kw.get("boundary"), kw.get("w0"),
                                             kw.get("w1"), None, 0, 0, rate,
                                             rate == 0.0, 99)
        row["kernel_ms"] = time_ms(
            lambda: attn._launch_bwd(q, k, v, mask, g, HEADS, bnd, w, geo, r, seed))
        row["plain_ms"] = time_ms(
            lambda: attn.fused_attention_bwd_reference(q, k, v, mask, g, HEADS, **kw))
        row["library_ms"] = None
        if not geometry:
            def heads(x):
                return x.view(TRAIN_BATCH, x.shape[1], HEADS, HEAD_DIM).transpose(1, 2)

            qh, kh, vh = (heads(x).detach().requires_grad_(True) for x in (q, k, v))
            gh = heads(g)
            bias = None
            if lk != lq:
                bias = ((1.0 - mask) * -10000.0).to(torch.bfloat16)[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(), (qh, kh, vh), gh)

            fwd_ms, both_ms = time_ms(sdpa), time_ms(sdpa_fwd_bwd)
            row["library_fwd_bwd_ms"] = both_ms
            row["library_ms"] = both_ms - fwd_ms  # the backward alone
        row["bytes_ms"], row["operations_ms"] = bwd_bound_times(TRAIN_BATCH, lq, lk, 2)
        row["bound_ms"] = max(row["bytes_ms"], row["operations_ms"])
        row["bound_by"] = bound_by(row["bytes_ms"], row["operations_ms"])
        rows.append(row)
        emit(dict(phase="kernel_bwd", **row))
    return rows


def model_phase(device):
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
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
            set_backend(model, "single" if fused else "plain")
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


class _AnalogyVocab:
    """What MarTTrainer reads of a KGVocab for a fine-tune step: the rows of
    the 2,063 analogy entities."""
    analogy_entity_ids = list(range(20000, 22063))


def train_batch(device, b=TRAIN_BATCH, length=128, seed=1):
    """A full-width fine-tune batch in the feature layout of data/prompt.py:
    padded prompts, the sep/mask/relation/head positions, labels over the
    analogy entities, two 224-px images per example."""
    import torch

    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(48, length + 1, (b,), generator=g)
    pos = torch.stack([torch.randint(1, 40, (b,), generator=g) for _ in range(6)], 1)
    batch = dict(
        input_ids=torch.randint(0, 42112, (b, length), generator=g),
        attention_mask=(torch.arange(length)[None] < lens[:, None]).int(),
        token_type_ids=torch.zeros(b, length, dtype=torch.int32),
        pixel_values=torch.randn(b, 2, 3, 224, 224, generator=g),
        mask_idx=pos[:, 0], rel_idx=pos[:, 1:3], q_head_idx=pos[:, 3],
        a_head_idx=pos[:, 4],
        sep_idx=torch.stack([pos[:, 5], pos[:, 5] + 1, lens // 2], 1).int(),
        label=torch.randint(0, 2063, (b,), generator=g),
    )
    return {k: v.to(device) for k, v in batch.items()}


def train_phase(device):
    """The full-width fine-tune step. (1) fp32 through the kernels against
    fp32 through the plain attention (autograd through the plain forward),
    from one state dict and batch, with dropout on and the same seeds, so
    both draw the same masks. Bars: the loss within 1e-5 relative (the same
    fp32 forward, summed in other orders); each gradient leaf within 1e-3 of
    that leaf's largest |gradient| plus 1e-6 of the model's largest (24
    layers of fp32 backward, summed in other orders, amplify the kernel's
    last-bit differences; the floor covers leaves whose exact gradient is 0,
    the key biases, which carry round-off only). (2) bf16 through the
    kernels, the main path: 8 AdamW steps on one batch, the loss finite and
    falling, 24 forward and 24 backward launches a step."""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.models.common import DropoutRNG
    from mkg_analogy_tpu_torch.models.unimo import UnimoConfig, UnimoForMaskedLM
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    batch = train_batch(device)
    out = {}
    with torch.device(device):
        model = UnimoForMaskedLM(UnimoConfig(dtype="float32"))
    model.init_params(torch.Generator(device=device).manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(), device=device)
    runs = {}
    for fused in (True, False):
        model.load_state_dict(state)
        set_backend(model, "single" if fused else "plain")
        model.zero_grad(set_to_none=True)
        attn.LAUNCHES = attn.LAUNCHES_BWD = 0
        loss, _ = trainer._finetune_loss(batch, DropoutRNG.from_seed(5, device))
        loss.backward()
        torch.cuda.synchronize()
        launches = (attn.LAUNCHES, attn.LAUNCHES_BWD)
        if launches != ((24, 24) if fused else (0, 0)):
            raise AssertionError(f"fp32 step fused={fused}: launches {launches}")
        runs[fused] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
    (lk, gk), (lp, gp) = runs[True], runs[False]
    if not (math.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
        raise AssertionError(f"fp32 step loss: kernels {lk} vs plain {lp}")
    top = max(g.abs().max().item() for g in gp.values())
    worst, worst_name = 0.0, ""
    for name, want in gp.items():
        err = (gk[name] - want).abs().max().item()
        bound = 1e-3 * want.abs().max().item() + 1e-6 * top
        if not err <= bound:
            raise AssertionError(f"fp32 grad {name}: kernels vs plain {err} > {bound}")
        if err / bound > worst:
            worst, worst_name = err / bound, name
    out["fp32"] = dict(loss_kernels=lk, loss_plain=lp, loss_rel_diff=abs(lk - lp) / abs(lp),
                       grad_leaves=len(gp), worst_err_over_bound=worst,
                       worst_leaf=worst_name, largest_grad=top)
    del runs, gk, gp, model, trainer
    torch.cuda.empty_cache()

    with torch.device(device):
        model = UnimoForMaskedLM(UnimoConfig(dtype="bfloat16"))
    model.load_state_dict(state)
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(seed=3), device=device)
    opt = make_optimizer(model, 1e-4, 100, warmup_ratio=0.0)
    losses, times, launches = [], [], []
    for step in range(8):
        attn.LAUNCHES = attn.LAUNCHES_BWD = 0
        t0 = time.perf_counter()
        metrics = trainer._train_step(opt, batch, step)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append((attn.LAUNCHES, attn.LAUNCHES_BWD))
        losses.append(metrics["loss"].item())
    if any(n != (24, 24) for n in launches):
        raise AssertionError(f"bf16 steps: launches {launches}, expected 24 + 24 a step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 loss did not fall: {losses}")
    step_ms = statistics.median(times[2:])
    out["bf16"] = dict(losses=losses, step_ms=times, median_step_ms=step_ms,
                       examples_per_sec=TRAIN_BATCH / step_ms * 1e3,
                       launches_per_step=dict(fwd=24, bwd=24),
                       peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                       device_profile_step=device_profile(
                           lambda: trainer._train_step(opt, batch, 8), top=15))
    emit(dict(phase="train", B=TRAIN_BATCH, L=128, **out))
    return out


WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lamda mu nu "
         "xi omicron pi rho sigma tau upsilon").split()


def write_dataset(root, n_ent=64, n_rel=8, n_triples=200, n_train=128, n_test=200,
                  seed=0):
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
    for split, n in (("train", n_train), ("dev", 16), ("test", n_test)):
        with open(os.path.join(mars, f"{split}.json"), "w") as f:
            for i in range(n):
                f.write(json.dumps(dict(
                    example=[rng.choice(ents), rng.choice(ents)],
                    question=rng.choice(ents), answer=rng.choice(analogy_ents),
                    relation=rng.choice(analogy_rels), mode=i % 3)) + "\n")
    return markg, mars


def cli_phase():
    """The evaluation path (slice 1's main path): the CLI's --only_test
    evaluation in bf16 through the kernel (launches counted from 0). Then the reference check: the same
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


def cli_train_phase():
    """The main path of the training slice: the CLI fine-tune, bf16, through
    the kernels, with both counts set to 0 just before and read just after.
    128 training examples at B=32 are 4 steps (24 + 24 launches each); the
    dev split (16) is one eval batch and the test split (200) two, 24
    forward launches each. The best-dev checkpoint is written and restored
    for the test; ``--only_test --checkpoint`` on it must give the same
    ranks."""
    import numpy as np

    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.train import checkpoint

    n_train, n_test = 128, 200
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_", dir=".") as root:
        markg, mars = write_dataset(root, n_train=n_train, n_test=n_test)

        def argv(out_dir, *extra):
            return ["--data_dir", mars, "--pretrain_path", markg, "--device", "cuda",
                    "--dtype", "bfloat16", "--max_seq_length", "128",
                    "--image_features", "synthetic", "--output_dir", out_dir,
                    "--log_dir", os.path.join(root, "logs"),
                    "--cache_dir", os.path.join(root, "cache"), *extra]

        fit_dir = os.path.join(root, "fit")
        attn.LAUNCHES = attn.LAUNCHES_BWD = 0
        t0 = time.perf_counter()
        metrics = cli.main(argv(fit_dir, "--max_epochs", "1", "--batch_size", "32"))
        seconds = time.perf_counter() - t0
        launches = dict(fwd=attn.LAUNCHES, bwd=attn.LAUNCHES_BWD)
        steps = n_train // 32
        expect = dict(fwd=24 * (steps + 1 + math.ceil(n_test / 128)), bwd=24 * steps)
        if launches != expect:
            raise AssertionError(f"cli fine-tune: launches {launches}, expected {expect}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cli fine-tune: non-finite test metrics {metrics}")
        ckpt = os.path.join(fit_dir, "ckpt")
        saved = checkpoint.list_steps(ckpt)
        if saved != [steps] or not os.path.exists(os.path.join(ckpt, f"metrics_{steps}.json")):
            raise AssertionError(f"cli fine-tune: checkpoint steps {saved} in {ckpt}")
        with open(os.path.join(ckpt, f"metrics_{steps}.json")) as f:
            dev = json.load(f)
        if not all(math.isfinite(v) for v in dev.values()):
            raise AssertionError(f"cli fine-tune: non-finite dev metrics {dev}")
        ranks = np.load(os.path.join(fit_dir, "test_ranks.npz"))["ranks"]

        test_dir = os.path.join(root, "retest")
        attn.LAUNCHES = attn.LAUNCHES_BWD = 0
        retest = cli.main(argv(test_dir, "--only_test", "--checkpoint", ckpt))
        retest_launches = dict(fwd=attn.LAUNCHES, bwd=attn.LAUNCHES_BWD)
        again = np.load(os.path.join(test_dir, "test_ranks.npz"))["ranks"]
        if not np.array_equal(again, ranks) or retest != metrics:
            raise AssertionError("--only_test --checkpoint did not reproduce the fit's "
                                 f"test ranks ({float((again == ranks).mean())} alike)")
        with open(os.path.join(root, "logs", "train_metrics.jsonl")) as f:
            train_log = [json.loads(line) for line in f]
    epoch = next(r for r in train_log if "train/examples_per_sec" in r)
    emit(dict(phase="cli_train", dtype="bfloat16", train_examples=n_train,
              batch_size=32, steps=steps, launches=launches, seconds=seconds,
              dev_mrr=dev["Eval_entity/mrr"], dev_hits10=dev["Eval_entity/hits10"],
              test_mrr=metrics["Eval_entity/mrr"],
              test_hits10=metrics["Eval_entity/hits10"],
              examples_per_sec_after_step_1=epoch["train/examples_per_sec"],
              last_loss=epoch["train/last_loss"], retest_launches=retest_launches,
              retest_ranks_identical=True))
    return launches


# The flash kernels' shapes: (name, B, Lq, Lk, mask kind, analogy geometry,
# launches per triple pre-train step). The triple pre-train step (B=64,
# L=96) runs 12 text, 8 vision and 4 vision-over-text calls; the analogy
# pre-train shapes (B=64, L=128; its vision shape is the one above); two Q
# tiles (512 x 512) and two K tiles, the second ragged (99 x 611), at B=8;
# attention alone at L=2048 (8 Q tiles x 4 K tiles).
FLASH_SHAPES = [
    ("triple_text", 64, 96, 96, "text", False, 12),
    ("vision", 64, 99, 99, "vision", False, 8),
    ("triple_vision_text", 64, 99, 195, "vision_text", False, 4),
    ("analogy_text", 64, 128, 128, "text", True, 0),
    ("analogy_vision_text", 64, 99, 227, "vision_text", False, 0),
    ("long_text", 8, 512, 512, "text", True, 0),
    ("long_vision_text", 8, 99, 611, "vision_text", False, 0),
    ("attention_2048", 8, 2048, 2048, "text", False, 0),
]
PRETRAIN_BATCH, PRETRAIN_LEN = 64, 96  # scripts/run_pretrain_mkgformer.sh


def flash_inputs(b, lq, lk, kind, geometry, dtype, device, seed):
    """q, k, v, a cotangent, the (B, Lk) mask and the geometry arguments:
    text keys padded to a random length, vision keys unpadded, vision over
    [text K/V ; vision] with the text part padded."""
    import torch

    g = torch.Generator().manual_seed(seed)
    hd = HEADS * HEAD_DIM
    q, k, v, go = (torch.randn(b, n, hd, generator=g).to(device, dtype)
                   for n in (lq, lk, lk, lq))
    if kind == "vision":
        mask = torch.ones(b, lk)
    else:
        n_text = lk if kind == "text" else lk - lq
        lens = torch.randint(int(0.4 * n_text), n_text + 1, (b,), generator=g)
        mask = (torch.arange(n_text)[None] < lens[:, None]).float()
        if kind == "vision_text":
            mask = torch.cat([mask, torch.ones(b, lq)], dim=1)
    kw = {}
    if geometry:
        kw = dict(boundary=(lens // 2).to(device, torch.int32),
                  w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device))
    return q, k, v, go, mask.to(device), kw


def flash_bound_times(kernel, b, lq, lk, dtype_bytes):
    """(ms for the bytes, ms for the operations) of one call of a flash
    kernel: each input read once and each output written once over the HBM
    rate (q, k, v and the (B, heads, Lq) fp32 lse out for the forward; q, k,
    v, g, lse and delta in and dk, dv or dq out for the backward kernels;
    the fp32 mask and the int32 boundary), and the products it does, each
    2·B·heads·Lq·Lk·64 flops (forward QKᵀ and PV: 2; dK/dV QKᵀ, dV, dP and
    dK: 4; dQ QKᵀ, dP and dQ: 3) over the bf16 tensor-core peak."""
    hd = HEADS * HEAD_DIM
    stat = b * HEADS * lq * 4
    small = b * lk * 4 + b * 4
    tensors, stats, products = {"fwd": ((2 * lq + 2 * lk), 1, 2),
                                "dkv": ((2 * lq + 4 * lk), 2, 4),
                                "dq": ((3 * lq + 2 * lk), 2, 3)}[kernel]
    nbytes = b * tensors * hd * dtype_bytes + stats * stat + small
    flops = products * 2 * b * HEADS * lq * lk * HEAD_DIM
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def flash_dw_scales(fa, q, k, v, mask, go, lse, delta, bnd, w, geo, rate, seed):
    """sum |dS · S_raw| over each analogy region, walking the logical tiles
    as the plain backward does: the scale of the dw0/dw1 sums."""
    import torch

    tiles = fa._Tiles(q.float(), k.float(), mask, HEADS, bnd, w, geo, rate, seed,
                      fa.BLOCK_Q, fa.BLOCK_K)
    qh, kh, vh, gh = (fa._split_heads(x, HEADS, torch.float32) for x in (q, k, v, go))
    scales = [0.0, 0.0]
    for qb in range(tiles.n_qblk):
        r0, r1 = tiles.rows(qb, q.shape[1])
        for kb in range(tiles.n_kblk):
            s_raw, planes, s = tiles.scores(qh[:, :, r0:r1], tiles.keys(kh, kb), qb, kb, r0, r1)
            p = torch.exp(s - lse[:, :, r0:r1, None])
            dp = torch.matmul(gh[:, :, r0:r1], tiles.keys(vh, kb).transpose(-1, -2))
            keep = tiles.keep(qb, kb, r0, r1, q.device)
            if keep is not None:
                dp = torch.where(keep, dp / (1.0 - rate), 0.0)
            terms = (p * (dp - delta[:, :, r0:r1, None]) * s_raw).abs()
            scales[0] += (terms * planes[1]).sum().item()
            scales[1] += (terms * planes[2]).sum().item()
    return scales


def flash_kernel_phase(device):
    """The three flash kernels against their plain versions at every shape
    of FLASH_SHAPES, in fp32 (TF32 off) and bf16, dropout 0 and 0.1 (the
    same seed, so the masks must agree). Bars: forward 2e-5 fp32 / 2e-2
    bf16 absolute (the forward bars of the single-block kernel), lse 1e-5;
    backward, from the kernel forward's out and lse, 2e-5 fp32 / 2^-7 bf16
    of each result's largest |value| (a term rounded at a cast point can
    land one bf16 ulp apart), dw within 1e-5 of its sum of |terms|. Then
    the times in bf16 (dropout 0.1 on text keys as the text tower trains):
    each kernel, the plain forward and the plain backward (one walk computes
    dq, dk and dv, so both backward kernels' rows carry its time), SDPA's
    forward and backward (forward-and-backward minus forward) where no
    analogy multiplier applies, and the bounds."""
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    rows = []
    for name, b, lq, lk, kind, geometry, per_step in FLASH_SHAPES:
        row = dict(shape=name, B=b, Lq=lq, Lk=lk, heads=HEADS, head_dim=HEAD_DIM,
                   geometry=geometry, launches_per_triple_step=per_step,
                   tiles=list(fa._blocks(lq, lk, fa.BLOCK_Q, fa.BLOCK_K)))
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for rate in (0.0, 0.1):
                key = f"{tag}{'_dropout' if rate else ''}"
                q, k, v, go, mask, kw = flash_inputs(b, lq, lk, kind, geometry, dtype,
                                                     device, seed=lq + lk)
                kw = dict(kw, compute_dtype=dtype, dropout_rate=rate,
                          deterministic=rate == 0.0, dropout_seed=4321)
                args = (HEADS, *fa._resolve(q, kw.get("boundary"), kw.get("w0"),
                                            kw.get("w1"), None, 0, 0, rate, rate == 0.0,
                                            4321), fa.BLOCK_Q, fa.BLOCK_K)
                out, lse = fa._launch_fwd(q, k, v, mask, *args)
                delta = fa._delta(go, out, HEADS)
                got = fa._launch_bwd(q, k, v, mask, go, lse, delta, *args)
                want_out, want_lse = fa._plain_fwd(q, k, v, mask, *args[:6], dtype,
                                                   *args[6:])
                want = fa.flash_attention_bwd_reference(q, k, v, mask, go, HEADS, out=out,
                                                        lse=lse, **kw)
                torch.cuda.synchronize()
                err = (out.float() - want_out.float()).abs().max().item()
                lse_err = (lse - want_lse).abs().max().item()
                row[f"fwd_max_abs_err_{key}"] = err
                row[f"lse_max_abs_err_{key}"] = lse_err
                bar = 2e-5 if dtype == torch.float32 else 2e-2
                if not (err <= bar and lse_err <= 1e-5):
                    raise AssertionError(f"flash fwd {name} {key}: out {err} > {bar} "
                                         f"or lse {lse_err} > 1e-5")
                bar = 2e-5 if dtype == torch.float32 else 2.0 ** -7
                for t_name, a, c in zip(("dq", "dk", "dv"), got[:3], want[:3]):
                    err = (a.float() - c.float()).abs().max().item()
                    top = c.float().abs().max().item()
                    row[f"max_abs_err_{t_name}_{key}"] = err
                    if not err <= bar * top:
                        raise AssertionError(f"flash bwd {name} {key} {t_name}: {err} > "
                                             f"{bar} * {top}")
                if geometry:
                    scales = flash_dw_scales(fa, q, k, v, mask, go, lse, delta, *args[1:6])
                    for i in range(2):
                        err = abs(got[3][i].item() - want[3][i].item())
                        row[f"dw{i}_err_{key}"] = err
                        if not err <= 1e-5 * scales[i]:
                            raise AssertionError(f"flash bwd {name} {key} dw{i}: {err} > "
                                                 f"1e-5 * {scales[i]}")
                elif got[3].abs().max().item() != 0.0:
                    raise AssertionError(f"flash bwd {name}: dw without a geometry")
                del q, k, v, go, out, lse, delta, got, want, want_out
        # timing in the main path's dtype
        rate = 0.1 if kind == "text" else 0.0
        q, k, v, go, mask, kw = flash_inputs(b, lq, lk, kind, geometry, torch.bfloat16,
                                             device, seed=7)
        kw = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=rate,
                  deterministic=rate == 0.0, dropout_seed=99)
        args = (HEADS, *fa._resolve(q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), None,
                                    0, 0, rate, rate == 0.0, 99), fa.BLOCK_Q, fa.BLOCK_K)
        out, lse = fa._launch_fwd(q, k, v, mask, *args)
        delta = fa._delta(go, out, HEADS)
        n = dict(samples=7, per_sample=3) if lq >= 2048 else {}
        row["fwd_ms"] = time_ms(lambda: fa._launch_fwd(q, k, v, mask, *args), **n)
        row["dkv_ms"] = time_ms(lambda: fa._launch_bwd_dkv(q, k, v, mask, go, lse, delta,
                                                           *args), **n)
        row["dq_ms"] = time_ms(lambda: fa._launch_bwd_dq(q, k, v, mask, go, lse, delta,
                                                         *args), **n)
        row["plain_fwd_ms"] = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, mask, HEADS, **kw), **n)
        row["plain_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, mask, go, HEADS, out=out, lse=lse, **kw), **n)
        row["library_fwd_ms"] = row["library_bwd_ms"] = None
        if geometry:
            row["library_note"] = "no single PyTorch call applies the analogy multiplier"
        else:
            def heads(x):
                return x.view(b, x.shape[1], HEADS, HEAD_DIM).transpose(1, 2)

            qh, kh, vh = (heads(x).detach().requires_grad_(True) for x in (q, k, v))
            gh = heads(go)
            bias = None
            if kind != "vision":
                bias = ((1.0 - mask) * -10000.0).to(torch.bfloat16)[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                      dropout_p=0.0)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(), (qh, kh, vh), gh)

            row["library_fwd_ms"] = time_ms(sdpa, **n)
            row["library_bwd_ms"] = time_ms(sdpa_fwd_bwd, **n) - row["library_fwd_ms"]
            row["library_note"] = ("SDPA without dropout" + (" with the padding mask as a "
                                   "bias" if bias is not None else ""))
        for kernel in ("fwd", "dkv", "dq"):
            t_bytes, t_ops = flash_bound_times(kernel, b, lq, lk, 2)
            row[f"{kernel}_bytes_ms"], row[f"{kernel}_operations_ms"] = t_bytes, t_ops
            row[f"{kernel}_bound_ms"] = max(t_bytes, t_ops)
            row[f"{kernel}_bound_by"] = bound_by(t_bytes, t_ops)
        rows.append(row)
        emit(dict(phase="flash_kernel", **row))
        del q, k, v, go, out, lse, delta
        torch.cuda.empty_cache()
    return rows


class _PretrainVocab:
    """What MarTTrainer reads of a KGVocab for a triple pre-train step: the
    MarKG id ranges (a 30,522-token wordpiece base, 11,292 entities, 192
    relations; SURVEY.md)."""
    entity_id_st, entity_id_ed = 30522, 30522 + 11292
    relation_id_st, relation_id_ed = 30522 + 11292, 30522 + 11292 + 192
    analogy_entity_ids = list(range(entity_id_st, entity_id_st + 2063))


def pretrain_batch(device, b=PRETRAIN_BATCH, length=PRETRAIN_LEN, seed=2):
    """A full-width triple pre-train batch in the feature layout of
    data/prompt.py: padded prompts, the mask position, pre_type 1 (link
    prediction, an entity label) or 2 (relation prediction, a relation
    label), two 224-px images per example."""
    import torch

    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, length + 1, (b,), generator=g)
    pre_type = torch.randint(1, 3, (b,), generator=g)
    label = torch.where(pre_type == 2, torch.randint(0, 192, (b,), generator=g),
                        torch.randint(0, 11292, (b,), generator=g))
    batch = dict(
        input_ids=torch.randint(0, 42112, (b, length), generator=g),
        attention_mask=(torch.arange(length)[None] < lens[:, None]).int(),
        token_type_ids=torch.zeros(b, length, dtype=torch.int32),
        pixel_values=torch.randn(b, 2, 3, 224, 224, generator=g),
        mask_idx=torch.randint(1, 16, (b,), generator=g), pre_type=pre_type.int(),
        label=label.int(),
    )
    return {k: v.to(device) for k, v in batch.items()}


def flash_counts():
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    return dict(fwd=fa.LAUNCHES_FLASH, dkv=fa.LAUNCHES_FLASH_DKV, dq=fa.LAUNCHES_FLASH_DQ)


def reset_counts():
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    attn.LAUNCHES = attn.LAUNCHES_BWD = 0
    fa.LAUNCHES_FLASH = fa.LAUNCHES_FLASH_DKV = fa.LAUNCHES_FLASH_DQ = 0


def set_backend(model, backend):
    from mkg_analogy_tpu_torch.models.common import AttentionCore

    for m in model.modules():
        if isinstance(m, AttentionCore):
            m.backend = backend


def leaf_ratios(got, want):
    """The largest of err / bar over the gradient leaves, and its leaf, for
    the bar 1e-3 of the leaf's largest |gradient| plus 1e-6 of the model's
    largest (PR 2's fine-tune-step bar); leaves without a gradient (the
    adaptive scalars: the triple prompt has no analogy boundary) must lack
    one on both sides."""
    top = max(g.abs().max().item() for g in want.values() if g is not None)
    worst, worst_name = 0.0, ""
    for name, w in want.items():
        if w is None or got[name] is None:
            if (w is None) != (got[name] is None):
                raise AssertionError(f"gradient of {name} on one side only")
            continue
        ratio = (got[name] - w).abs().max().item() / (1e-3 * w.abs().max().item() + 1e-6 * top)
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def pretrain_phase(device):
    """The full-width triple pre-train step (B=64, L=96, entity + relation
    CE over one decoder product, AdamW), dropout on. (1) fp32, from one
    state dict, batch and seeds, through the flash kernels, through autograd
    of the kernels' plain version (flash_attention_reference: the same
    tiles, the same cast points) and through the plain attention of
    --fused_attention 0 (the einsum path). Gates: the kernels' loss within
    1e-5 relative of both; each gradient leaf within 1e-3 of that leaf's
    largest |gradient| plus 1e-6 of the model's largest against the kernels'
    plain version. Against the einsum path the leaves are reported, as is
    the single-block kernel's ratio there: with random weights the network
    amplifies last-bit differences of any attention formulation (BertFusion's
    unscaled softmax), so that ratio measures the model, not the kernel.
    (2) bf16 through the flash kernels, 8 steps on one batch: the loss finite
    and falling, 24 forward, 24 dK/dV and 24 dQ launches a step, the median
    step over steps 3-8, a device profile of one step."""
    import torch

    from mkg_analogy_tpu_torch.kernels import flash_attention as fa
    from mkg_analogy_tpu_torch.models import common
    from mkg_analogy_tpu_torch.models.common import DropoutRNG
    from mkg_analogy_tpu_torch.models.unimo import UnimoConfig, UnimoForMaskedLM
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    batch = pretrain_batch(device)
    out = {}
    with torch.device(device):
        model = UnimoForMaskedLM(UnimoConfig(dtype="float32"))
    model.init_params(torch.Generator(device=device).manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = MarTTrainer(model, _PretrainVocab(), TrainConfig(pretrain=True), device=device)
    runs = {}
    common.ATTENTION_BACKENDS["flash_plain"] = fa.flash_attention_reference
    try:
        for backend in ("flash", "flash_plain", "plain", "single"):
            model.load_state_dict(state)
            set_backend(model, backend)
            model.zero_grad(set_to_none=True)
            reset_counts()
            loss, _ = trainer._pretrain_loss(batch, DropoutRNG.from_seed(5, device))
            loss.backward()
            torch.cuda.synchronize()
            n = 24 if backend == "flash" else 0
            if flash_counts() != dict(fwd=n, dkv=n, dq=n):
                raise AssertionError(f"fp32 pre-train step {backend}: launches {flash_counts()}")
            runs[backend] = (loss.item(), {k: None if p.grad is None else p.grad.clone()
                                           for k, p in model.named_parameters()})
    finally:
        del common.ATTENTION_BACKENDS["flash_plain"]
    lk = runs["flash"][0]
    for ref in ("flash_plain", "plain"):
        if not (math.isfinite(lk) and abs(lk - runs[ref][0]) <= 1e-5 * abs(runs[ref][0])):
            raise AssertionError(f"fp32 pre-train loss: kernels {lk} vs {ref} {runs[ref][0]}")
    worst, worst_name = leaf_ratios(runs["flash"][1], runs["flash_plain"][1])
    if not worst <= 1.0:
        raise AssertionError(f"fp32 pre-train grad {worst_name}: kernels vs their plain "
                             f"version at {worst} of the bar")
    vs_plain = leaf_ratios(runs["flash"][1], runs["plain"][1])
    single_vs_plain = leaf_ratios(runs["single"][1], runs["plain"][1])
    out["fp32"] = dict(
        loss_kernels=lk, loss_kernels_plain_version=runs["flash_plain"][0],
        loss_plain_attention=runs["plain"][0],
        loss_rel_diff_plain_attention=abs(lk - runs["plain"][0]) / abs(runs["plain"][0]),
        worst_err_over_bar_vs_plain_version=worst, worst_leaf=worst_name,
        worst_err_over_bar_vs_plain_attention=vs_plain,
        single_block_kernels_worst_err_over_bar_vs_plain_attention=single_vs_plain)
    del runs, model, trainer
    torch.cuda.empty_cache()

    with torch.device(device):
        model = UnimoForMaskedLM(UnimoConfig(dtype="bfloat16", attention="flash"))
    model.load_state_dict(state)
    trainer = MarTTrainer(model, _PretrainVocab(), TrainConfig(pretrain=True, seed=3),
                          device=device)
    opt = make_optimizer(model, 1e-4, 100, warmup_ratio=0.0)
    losses, times, launches = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(8):
        reset_counts()
        t0 = time.perf_counter()
        metrics = trainer._train_step(opt, batch, step)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(flash_counts())
        losses.append(metrics["loss"].item())
    if any(n != dict(fwd=24, dkv=24, dq=24) for n in launches):
        raise AssertionError(f"bf16 pre-train steps: launches {launches}, expected 24 each")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 pre-train loss did not fall: {losses}")
    step_ms = statistics.median(times[2:])
    out["bf16"] = dict(losses=losses, step_ms=times, median_step_ms=step_ms,
                       examples_per_sec=PRETRAIN_BATCH / step_ms * 1e3,
                       launches_per_step=launches[-1],
                       peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                       device_profile_step=device_profile(
                           lambda: trainer._train_step(opt, batch, 8), top=15))
    emit(dict(phase="pretrain", B=PRETRAIN_BATCH, L=PRETRAIN_LEN, format="triple", **out))
    del model, trainer, opt
    torch.cuda.empty_cache()
    return out


def long_phase(device):
    """Two Q tiles and a ragged second K tile inside the model: a full-width
    bf16 fine-tune step at B=8, L=512 through the flash kernels (text
    512 x 512 with the analogy geometry, vision over [text K/V ; vision]
    99 x 611), 24 + 24 + 24 launches a step, 3 steps; then a forward at
    L=512 on the plain route (--fused_attention 0): the 12 text layers take
    the flash forward (the auto-route from FLASH_AUTO_MIN_LEN), the 12
    vision layers (99 queries) the plain attention, the single-block kernel
    none."""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.models.unimo import UnimoConfig, UnimoForMaskedLM
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig, finetune_positions

    b, length = 8, 512
    batch = train_batch(device, b=b, length=length, seed=4)
    with torch.device(device):
        model = UnimoForMaskedLM(UnimoConfig(dtype="bfloat16", attention="flash"))
    model.init_params(torch.Generator(device=device).manual_seed(0))
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(seed=3), device=device)
    opt = make_optimizer(model, 1e-4, 100, warmup_ratio=0.0)
    losses, times = [], []
    for step in range(3):
        reset_counts()
        t0 = time.perf_counter()
        metrics = trainer._train_step(opt, batch, step)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        if flash_counts() != dict(fwd=24, dkv=24, dq=24) or attn.LAUNCHES or attn.LAUNCHES_BWD:
            raise AssertionError(f"L=512 step: flash {flash_counts()}, single "
                                 f"{attn.LAUNCHES}/{attn.LAUNCHES_BWD}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"L=512 step: losses {losses}")
    set_backend(model, "plain")
    reset_counts()
    with torch.inference_mode():
        trans = model(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"],
                      token_type_ids=batch["token_type_ids"],
                      pixel_values=batch["pixel_values"], positions=finetune_positions(batch),
                      boundary=batch["sep_idx"][:, 2])
        torch.cuda.synchronize()
    auto = dict(flash_counts(), single=attn.LAUNCHES)
    if auto != dict(fwd=12, dkv=0, dq=0, single=0) or not torch.isfinite(trans).all():
        raise AssertionError(f"L=512 plain-route forward: launches {auto}")
    emit(dict(phase="long", B=b, L=length, dtype="bfloat16", losses=losses, step_ms=times,
              launches_per_step=dict(fwd=24, dkv=24, dq=24),
              plain_route_forward_launches=auto))
    del model, trainer, opt
    torch.cuda.empty_cache()


def cli_pretrain_phase():
    """The main path of this slice: ``--pretrain 1 --fused_attention flash``
    through the CLI, bf16, on the dataset of write_dataset (400 triple-format
    and ~400 pseudo-analogy examples), for each of triple (L=96), analogy
    and mixed (L=128), at B=64 and 3 steps each (--limit_train_batches 3),
    with the dev and test evaluation on the training features; the counts
    set to 0 before each run and read after it. Then a fine-tune on MARS
    from the triple run's checkpoint (--checkpoint), through the flash
    kernels: 4 steps, dev and test."""
    import numpy as np

    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.train import checkpoint

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pretrain_", dir=".") as root:
        markg, mars = write_dataset(root)

        def argv(out_dir, *extra):
            return ["--data_dir", mars, "--pretrain_path", markg, "--device", "cuda",
                    "--dtype", "bfloat16", "--fused_attention", "flash",
                    "--image_features", "synthetic", "--output_dir", out_dir,
                    "--log_dir", os.path.join(root, "logs"),
                    "--cache_dir", os.path.join(root, "cache"), *extra]

        reset_counts()
        for fmt, length in (("triple", 96), ("analogy", 128), ("mixed", 128)):
            out_dir = os.path.join(root, fmt)
            before = flash_counts()
            t0 = time.perf_counter()
            metrics = cli.main(argv(out_dir, "--pretrain", "1", "--pretrain_format", fmt,
                                    "--max_seq_length", str(length), "--batch_size", "64",
                                    "--max_epochs", "1", "--limit_train_batches", "3"))
            seconds = time.perf_counter() - t0
            launches = {k: n - before[k] for k, n in flash_counts().items()}
            n_eval = len(np.load(os.path.join(out_dir, "test_ranks.npz"))["ranks"])
            # 3 steps; the dev and the test evaluation on n_eval examples
            expect = dict(fwd=24 * (3 + 2 * math.ceil(n_eval / 128)), dkv=24 * 3, dq=24 * 3)
            if launches != expect or attn.LAUNCHES or attn.LAUNCHES_BWD:
                raise AssertionError(f"cli pretrain {fmt}: flash {launches} (expected "
                                     f"{expect}), single {attn.LAUNCHES}/{attn.LAUNCHES_BWD}")
            if not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"cli pretrain {fmt}: non-finite metrics {metrics}")
            if ("Eval_relation/mrr" in metrics) != (fmt == "triple"):
                raise AssertionError(f"cli pretrain {fmt}: metric names {sorted(metrics)}")
            if len(checkpoint.list_steps(os.path.join(out_dir, "ckpt"))) != 1:
                raise AssertionError(f"cli pretrain {fmt}: no checkpoint")
            runs[fmt] = dict(launches=launches, eval_examples=n_eval, seconds=seconds,
                             mrr=metrics["Eval_entity/mrr"],
                             relation_mrr=metrics.get("Eval_relation/mrr"))
        total = flash_counts()  # the main path's launches, all three formats

        ft_dir = os.path.join(root, "finetune")
        reset_counts()
        metrics = cli.main(argv(ft_dir, "--checkpoint", os.path.join(root, "triple", "ckpt"),
                                "--max_seq_length", "128", "--batch_size", "32",
                                "--max_epochs", "1"))
        launches = flash_counts()
        expect = dict(fwd=24 * (4 + 1 + 2), dkv=24 * 4, dq=24 * 4)
        if launches != expect or attn.LAUNCHES or attn.LAUNCHES_BWD:
            raise AssertionError(f"cli fine-tune from the pre-train checkpoint: {launches}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cli fine-tune from the pre-train checkpoint: {metrics}")
        runs["finetune_from_triple"] = dict(launches=launches, mrr=metrics["Eval_entity/mrr"])
    emit(dict(phase="cli_pretrain", dtype="bfloat16", batch_size=64, steps_per_format=3,
              launches=total, **runs))
    return total


FLASH_KERNELS = {
    "fwd": ("flash_attention_fwd", "flash_attention_fwd.cu", 98),
    "dkv": ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", 183),
    "dq": ("flash_attention_bwd_dq", "flash_attention_bwd.cu", 271),
}


def flash_entry(rows, kernel, launches):
    """One flash kernel's entry of the {"kernels": ...} line. Its times and
    bounds are per triple pre-train step at B=64 (12 text 96 x 96, 8 vision
    99 x 99 and 4 vision-text 99 x 195 calls, no analogy multiplier, so SDPA
    is the library yardstick of every call); plain_ms is the plain forward,
    or for both backward kernels the plain backward, which computes dq, dk
    and dv in one walk; library_ms likewise SDPA's forward or its whole
    backward. Errors are the largest over every shape."""
    name, source, line = FLASH_KERNELS[kernel]
    step = [r for r in rows if r["launches_per_triple_step"]]

    def per_step(key):
        return sum(r[key] * r["launches_per_triple_step"] for r in step)

    t_bytes, t_ops = per_step(f"{kernel}_bytes_ms"), per_step(f"{kernel}_operations_ms")
    if kernel == "fwd":
        err = [r[f"fwd_max_abs_err_{d}"] for r in rows for d in ("bf16", "bf16_dropout")]
        err32 = [r[f"fwd_max_abs_err_{d}"] for r in rows for d in ("fp32", "fp32_dropout")]
    else:
        grads = ("dq",) if kernel == "dq" else ("dk", "dv")
        err = [r[f"max_abs_err_{t}_{d}"] for r in rows for t in grads
               for d in ("bf16", "bf16_dropout")]
        err32 = [r[f"max_abs_err_{t}_{d}"] for r in rows for t in grads
                 for d in ("fp32", "fp32_dropout")]
    plain = "plain_fwd_ms" if kernel == "fwd" else "plain_bwd_ms"
    library = "library_fwd_ms" if kernel == "fwd" else "library_bwd_ms"
    return dict(
        name=name, route="cuda", source=f"mkg_analogy_tpu_torch/csrc/{source}",
        replaces=f"mkg_analogy_tpu/kernels/flash_attention.py:{line}", ok=True,
        launches=launches, max_abs_err=max(err), max_abs_err_fp32=max(err32),
        ms=per_step(f"{kernel}_ms"), plain_ms=per_step(plain),
        bound_ms=max(t_bytes, t_ops), bound_by=bound_by(t_bytes, t_ops),
        library_ms=per_step(library),
        shapes=[{k: v for k, v in r.items()
                 if k.startswith((kernel, "shape", "B", "L", "tiles", plain, library))}
                for r in rows])


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
    bwd_rows = kernel_bwd_phase(device)
    model_phase(device)
    train_phase(device)
    eval_launches = cli_phase()
    launches = cli_train_phase()
    if not launches["fwd"] or not launches["bwd"]:
        raise AssertionError(f"the main path launched no kernel: {launches}")
    flash_rows = flash_kernel_phase(device)
    pretrain_phase(device)
    long_phase(device)
    flash_launches = cli_pretrain_phase()
    if not all(flash_launches.values()):
        raise AssertionError(f"the pre-train path launched no flash kernel: {flash_launches}")

    def per_call_set(rows, key, n):
        return sum(r[key] * r[n] for r in rows)

    t_bytes = per_call_set(rows, "bytes_ms", "launches_per_forward")
    t_ops = per_call_set(rows, "operations_ms", "launches_per_forward")
    b_bytes = per_call_set(bwd_rows, "bytes_ms", "launches_per_step")
    b_ops = per_call_set(bwd_rows, "operations_ms", "launches_per_step")
    emit({"kernels": [dict(
        name="fused_attention_fwd", route="cuda",
        source="mkg_analogy_tpu_torch/csrc/fused_attention_fwd.cu",
        replaces="mkg_analogy_tpu/kernels/attention.py:124",
        ok=True, launches=launches["fwd"], launches_eval_path=eval_launches,
        max_abs_err=max(r["max_abs_err_bf16"] for r in rows),
        max_abs_err_fp32=max(r["max_abs_err_fp32"] for r in rows),
        # per full-width forward at B=128: 12 text + 8 vision + 4 vision-text calls
        ms=per_call_set(rows, "kernel_ms", "launches_per_forward"),
        plain_ms=per_call_set(rows, "plain_ms", "launches_per_forward"),
        bound_ms=max(t_bytes, t_ops), bound_by=bound_by(t_bytes, t_ops),
        library_ms=None,  # no single PyTorch call applies the analogy multiplier
        shapes=rows,
    ), dict(
        name="fused_attention_bwd", route="cuda",
        source="mkg_analogy_tpu_torch/csrc/fused_attention_bwd.cu",
        replaces="mkg_analogy_tpu/kernels/attention.py:159",
        ok=True, launches=launches["bwd"],
        max_abs_err=max(r[f"max_abs_err_{t}_bf16{d}"] for r in bwd_rows
                        for t in ("dq", "dk", "dv") for d in ("", "_dropout")),
        max_abs_err_fp32=max(r[f"max_abs_err_{t}_fp32{d}"] for r in bwd_rows
                             for t in ("dq", "dk", "dv") for d in ("", "_dropout")),
        # per full-width train step at B=32: 12 text + 8 vision + 4 vision-text calls
        ms=per_call_set(bwd_rows, "kernel_ms", "launches_per_step"),
        plain_ms=per_call_set(bwd_rows, "plain_ms", "launches_per_step"),
        bound_ms=max(b_bytes, b_ops), bound_by=bound_by(b_bytes, b_ops),
        library_ms=None,  # per shape below: SDPA's backward at the vision shapes
        shapes=bwd_rows,
    )] + [flash_entry(flash_rows, kernel, flash_launches[kernel]) for kernel in
          ("fwd", "dkv", "dq")]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
