#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the quickest proof that
the port builds, is right and runs its main path on the GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, prints its traceback and
exits non-zero:

1. card       — name and power limit (nvidia-smi);
2. build      — nvcc builds every kernel under mkg_analogy_tpu_torch/csrc
                (one process per source, all started together); what
                ``ptxas -v`` said of the tensor-core attention kernels, the
                single-block and the flash backward (registers a thread,
                spill bytes, static shared memory);
3. kernel     — the fused-attention forward kernels against their plain
                PyTorch version at the three MKGformer shapes and at ViLT's
                (418 x 418: 128 text and 290 image tokens, the multiplier
                over the text block from row 1, and with the boundary
                shifted by 290; bf16 only, above the 400 fp32 keys), B=128:
                fp32 (the CUDA-core kernel, TF32 off) at atol 2e-5, bf16 (the
                tensor-core kernel) at 2e-2, each also with dropout (same
                seed, so the masks must agree); then the tensor-core kernel
                at the ragged edges (EDGE_CASES: lengths of 1, 15, 17, 99,
                227 and 418, a row whose keys are all masked, the boundary
                on the geometry's edges, B=1); times of the kernel, of the
                CUDA-core kernel it took over from in bf16 (``earlier_ms``,
                which it must beat), of the plain version (which it must
                beat at 418 keys) and of scaled_dot_product_attention (a
                yardstick only, at the two vision shapes; no single PyTorch
                call applies the analogy multiplier of the text shape), and
                the bound;
4. kernel_bwd — the backward kernels against their plain version at the same
                shapes and B=32 (the training batch) and at the same edge
                cases: dq, dk, dv and dw in fp32 (CUDA cores) and bf16
                (tensor cores), with and without dropout; the times as in
                phase 3, and the backward of scaled_dot_product_attention
                at the vision shapes;
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
9. flash_kernel — the three flash kernels (forward, dK/dV, dQ; the
                backward pair on the tensor cores in bf16, on the CUDA cores
                in fp32) against their plain versions at the triple
                pre-train shapes (B=64: text 96x96, vision 99x99,
                vision-text 99x195), the analogy ones (128x128 with the
                geometry, 99x227), two Q tiles (512x512, B=8), two K tiles
                with a ragged second (99x611, B=8), L=2048 (B=8, 8 x 4
                tiles), FLAVA's three towers (B=24: 393x393, 128x128 with the
                multiplier from row 1, 522x522) and ViLT's fp32 route (B=32,
                418x418), fp32 and bf16, dropout 0 and 0.1; the times of each
                kernel, of the CUDA-core backward pair in bf16
                (``earlier_ms``, which the tensor-core pair must beat at
                every shape), the plain versions and SDPA (where no analogy
                multiplier applies), and the bounds; then the tensor-core
                backward at the flash edge cases (FLASH_EDGE_CASES: Lq and
                Lk of 1, 255, 257, 511, 513 and 611, a row whose keys are all
                masked, row_start 1, the +290 offset, 64-row chunks that
                straddle logical tiles of 96 x 160), bf16, dropout 0 and 0.1;
10. pretrain  — the full-width triple pre-train step (B=64, L=96) through
                the flash kernels: fp32 against the plain attention (loss
                within 1e-5 relative, every gradient leaf within its bound),
                then 8 bf16 steps on one batch: the loss falls, 24 + 24 + 24
                launches a step (the backward pair's on the tensor cores),
                step time and a device profile;
11. long      — a full-width bf16 fine-tune step at B=8, L=512 through the
                flash kernels (multi-tile and ragged shapes inside the
                model), and a forward at L=512 on the plain route that takes
                the flash forward in the 12 text layers only (the
                auto-route);
12. cli_pretrain — the main path of this slice: ``--pretrain 1
                --fused_attention flash`` through the CLI for the triple,
                analogy and mixed formats (3 steps each, dev and test), the
                counts set to 0 before the three runs and read after them;
                then a fine-tune from the triple run's checkpoint;
13. image_kernel — the resize-and-normalise kernel against its plain version
                (interpolation matrices and two einsums) at the image tool's
                shapes: B=64 to 224 px (CLIP statistics) with every image the
                full 512 x 512 canvas and with mixed extents, B=64 to 384 px
                (ViLT statistics), B=1; within 1e-5 absolute; the kernel's
                time, the plain version's, the bound from this run's
                extents, and one F.interpolate call where every image has
                the same extent (the full canvases, B=1);
14. image_tool — ``mkg_analogy_tpu_torch.tools.encode_images`` over an
                entity-image tree written here with PIL (PNG and JPEG, 1 x 1
                to 700 x 600): ``pixels`` at 224 and 384 px (equal to the
                plain version's output for the same files within 1e-5),
                ``vgg`` (VGG16, full width) and ``vit`` (ViT-B/16, full width,
                its attention through the single-block kernel; equal to the
                plain attention's store within 1e-4 of its largest value);
                launches counted from 0 in each mode;
15. vilt, flava — a full-width fine-tune step of each family at its recipe
                (ViLT B=32, 384 px, 418 tokens; FLAVA B=24, 224 px, towers of
                393, 128 and 522 tokens), L=128: fp32 through the flash
                kernels against their plain version and the plain attention
                (loss within 1e-5 relative, every gradient leaf within its
                bound), then a bf16 forward and 6 bf16 steps through the
                family's default kernels (ViLT the single-block ones, 12 + 12
                launches a step; FLAVA the flash ones, 30 + 30 + 30): the
                loss falls, step time and a device profile; ViLT's step also
                through the flash kernels, for comparison;
16. cli_image — the main path of the image slice: the tool writes a pixel
                store for a dataset written here, ``cli.main --model_class
                ViltKGC|FlavaKGC --image_features <store>`` fine-tunes one
                epoch in bf16 and tests, ``--only_test --checkpoint``
                reproduces the ranks; the counts set to 0 before each
                family's run and read after it.

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
# (name, Lq, Lk, analogy geometry, launches per MKGformer forward). The
# geometry is None or (row_start, text_len, offset); text_len None is Lq.
# MKGformer: 12 text layers, 8 vision layers, 4 vision layers over the
# previous text layer's K/V. ViLT (the image path, 12 layers a forward):
# 128 text + 2 x 145 image tokens, the multiplier over the text block from
# row 1, and with compat_ref_mask_offset the boundary shifted by the 290
# image tokens over the whole sequence.
SHAPES = [("text", 128, 128, (0, None, 0), 12), ("vision", 99, 99, None, 8),
          ("vision_text", 99, 227, None, 4),
          ("vilt", 418, 418, (1, 128, 0), 0),
          ("vilt_compat_offset", 418, 418, (1, None, 290), 0)]
TEXT_LEN = 128       # text keys of SHAPES, padded to 40-128
FP32_MAX_KEYS = 400  # the single-block kernels take 400 keys in fp32 (717 in bf16)
# The ragged edges of the tensor-core kernels' 64-row tiles and 64-key
# chunks: (name, B, Lq, Lk, geometry or None as (boundary per batch row,
# row_start, text_len, offset), batch row whose keys are all masked or None).
# The boundary at row_start, at text_len and past it; row_start 1; the +290
# offset; B=1.
EDGE_CASES = [
    ("1x1", 1, 1, 1, None, None),
    ("15x17_boundary_at_row_start_and_text_len", 2, 15, 17, ((1, 15), 1, None, 0), 0),
    ("17x15_boundary_at_and_past_text_len", 2, 17, 15, ((15, 20), 0, 15, 0), 1),
    ("99x99", 2, 99, 99, None, 0),
    ("99x227", 2, 99, 227, None, 1),
    ("1x227", 2, 1, 227, None, None),
    ("227x1", 2, 227, 1, ((0, 5), 1, None, 0), None),
    ("418x418_rows_from_1_text_128", 1, 418, 418, ((60,), 1, 128, 0), None),
    ("418x418_offset_290", 2, 418, 418, ((1, 128), 1, None, 290), 0),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, samples=21, per_sample=10):
    """Median over ``samples`` of the mean time of ``per_sample``
    back-to-back calls, by CUDA events. A device-side sleep ahead of each
    sample (~5 ms: ten calls of several launches each take the host up to a
    few ms to enqueue) lets the host enqueue the calls before the card
    reaches them, so host launch overhead is not timed."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
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
    text_len = torch.randint(40, TEXT_LEN + 1, (batch,), generator=g)
    text_mask = (torch.arange(TEXT_LEN)[None] < text_len[:, None]).float()
    if geometry is None and lk == lq:  # vision self-attention
        mask = torch.ones(batch, lk)
    else:  # padded text keys, then (vision over text K/V, ViLT) unpadded image keys
        mask = torch.cat([text_mask, torch.ones(batch, lk - TEXT_LEN)], dim=1)
    kw = {}
    if geometry is not None:
        row_start, geo_len, offset = geometry
        kw = dict(boundary=(text_len // 2).to(device, torch.int32),
                  w0=torch.tensor([0.3], device=device),
                  w1=torch.tensor([0.7], device=device),
                  row_start=row_start, text_len=geo_len, offset=offset)
    return q, k, v, mask.to(device), kw


def edge_inputs(case, device):
    """(q, k, v, g, mask, geometry keywords) of an edge case, bf16, from a
    seed: the last eighth of the keys padded, one batch row fully masked."""
    import torch

    name, b, lq, lk, geometry, masked_row = case
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    hd = HEADS * HEAD_DIM
    q, k, v, g = (torch.randn(b, n, hd, generator=gen).to(device, torch.bfloat16)
                  for n in (lq, lk, lk, lq))
    mask = torch.ones(b, lk)
    mask[:, lk - lk // 8:] = 0.0
    if masked_row is not None:
        mask[masked_row] = 0.0
    kw = {}
    if geometry is not None:
        boundary, row_start, text_len, offset = geometry
        kw = dict(boundary=torch.tensor(boundary, dtype=torch.int32, device=device),
                  w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device),
                  row_start=row_start, text_len=text_len, offset=offset)
    return q, k, v, g, mask.to(device), kw


def resolve_geometry(mod, q, kw, rate, seed):
    """(boundary, w, geometry, rate, seed) of a call with the keyword
    arguments ``kw``, as the wrapper of ``mod`` resolves them."""
    return mod._resolve(q, kw.get("boundary"), kw.get("w0"), kw.get("w1"),
                        kw.get("text_len"), kw.get("row_start", 0), kw.get("offset", 0),
                        rate, rate == 0.0, seed)


def kernel_phase(device):
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.kernels import attention as attn

    rows = []
    for name, lq, lk, geometry, per_fwd in SHAPES:
        row = dict(shape=name, B=BATCH, Lq=lq, Lk=lk, heads=HEADS,
                   head_dim=HEAD_DIM, geometry=geometry, launches_per_forward=per_fwd)
        dropout = dict(dropout_rate=0.1, deterministic=False, dropout_seed=1234)
        checks = [("fp32", torch.float32, 2e-5, {}),
                  ("bf16", torch.bfloat16, 2e-2, {}),
                  ("fp32_dropout", torch.float32, 2e-5, dropout),
                  ("bf16_dropout", torch.bfloat16, 2e-2, dropout)]
        if lk > FP32_MAX_KEYS:
            checks = [c for c in checks if c[1] != torch.float32]
            row["fp32"] = f"not run: above the kernel's {FP32_MAX_KEYS} fp32 keys"
        for tag, dtype, atol, extra in checks:
            q, k, v, mask, kw = attention_inputs(lq, lk, geometry, dtype, device, seed=lq + lk)
            kw = dict(kw, compute_dtype=dtype, **extra)
            before = attn.LAUNCHES
            got = attn.fused_attention(q, k, v, mask, HEADS, **kw)
            if attn.LAUNCHES != before + 1:
                raise AssertionError(f"{name} {tag}: the wrapper counted no launch")
            want = attn.fused_attention_reference(q, k, v, mask, HEADS, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            row[f"max_abs_err_{tag}"] = err
            if not err <= atol:
                raise AssertionError(f"{name} {tag}: kernel vs plain {err} > {atol}")
        # timing in the main path's dtype: the tensor-core kernel, the
        # CUDA-core kernel it took over from (bf16 reaches it only here), the
        # plain version
        q, k, v, mask, kw = attention_inputs(lq, lk, geometry, torch.bfloat16, device, seed=7)
        kw = dict(kw, compute_dtype=torch.bfloat16)
        resolved = resolve_geometry(attn, q, kw, 0.0, 0)
        row["kernel_ms"] = time_ms(lambda: attn.fused_attention(q, k, v, mask, HEADS, **kw))
        row["earlier_ms"] = time_ms(
            lambda: attn._launch_fwd_cuda_cores(q, k, v, mask, HEADS, *resolved),
            samples=7, per_sample=4)
        row["plain_ms"] = time_ms(
            lambda: attn.fused_attention_reference(q, k, v, mask, HEADS, **kw))
        if not row["kernel_ms"] < row["earlier_ms"]:
            raise AssertionError(f"{name}: the tensor-core forward ({row['kernel_ms']} ms) is "
                                 f"no faster than the CUDA-core one ({row['earlier_ms']} ms)")
        if lk > FP32_MAX_KEYS and not row["kernel_ms"] < row["plain_ms"]:
            raise AssertionError(f"{name}: the forward kernel ({row['kernel_ms']} ms) is no "
                                 f"faster than its plain version ({row['plain_ms']} ms)")
        row["library_ms"] = None
        if geometry is None:
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
    edges = {}
    for case in EDGE_CASES:
        q, k, v, _, mask, kw = edge_inputs(case, device)
        for rate in (0.0, 0.1):
            call = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=rate,
                        deterministic=rate == 0.0, dropout_seed=21)
            before = attn.LAUNCHES
            got = attn.fused_attention(q, k, v, mask, HEADS, **call)
            want = attn.fused_attention_reference(q, k, v, mask, HEADS, **call)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if attn.LAUNCHES != before + 1 or not err <= 2e-2:
                raise AssertionError(f"edge {case[0]} rate {rate}: kernel vs plain {err} > 2e-2 "
                                     f"(launches {attn.LAUNCHES - before})")
            edges[f"{case[0]}{'_dropout' if rate else ''}"] = err
    emit(dict(phase="kernel", edges_bf16_max_abs_err=edges))
    return rows, max(edges.values())


def bwd_errors(attn, what, key, q, k, v, mask, g, kw, rate, seed, bar):
    """One backward launch against fused_attention_bwd_reference: the
    errors of dq, dk, dv (each within ``bar`` of its largest |value|) and of
    dw0/dw1 (within 1e-5 of the sum of |ds * s_raw| over their region), as
    ``{name_key: value}``; raises beyond a bar."""
    import torch

    out = {}
    bnd, w, geo, r, seed = resolve_geometry(attn, q, kw, rate, seed)
    before = attn.LAUNCHES_BWD
    got = attn._launch_bwd(q, k, v, mask, g, HEADS, bnd, w, geo, r, seed)
    if attn.LAUNCHES_BWD != before + 1:
        raise AssertionError(f"bwd {what}: the wrapper counted no launch")
    want = attn.fused_attention_bwd_reference(q, k, v, mask, g, HEADS, **kw)
    torch.cuda.synchronize()
    for t_name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        err = (a.float() - b.float()).abs().max().item()
        top = b.float().abs().max().item()
        out[f"max_abs_err_{t_name}_{key}"] = err
        if not err <= bar * top:
            raise AssertionError(f"bwd {what} {t_name}: kernel vs plain {err} > {bar} * {top}")
    if geo is not None:
        # the scale of the dw sums: sum |ds * s_raw| over the regions
        with torch.no_grad():
            qf, kf = q.float(), k.float()
            s_raw, planes, p = attn._scores(qf, kf, mask, HEADS, bnd, w, geo)
            gh = attn._split_heads(g, HEADS, torch.float32)
            dp = gh @ attn._split_heads(v, HEADS, torch.float32).transpose(-1, -2)
            if r > 0.0:
                keep = attn.dropout_keep(q.shape[0], HEADS, q.shape[1], k.shape[1], r, seed,
                                         q.device)
                dp = torch.where(keep, dp / (1.0 - r), 0.0)
            ds = p * (dp - (dp * p).sum(-1, keepdim=True))
            terms = (ds * s_raw).abs()
            scales = [(terms * planes[1]).sum().item(), (terms * planes[2]).sum().item()]
        for i in range(2):
            err = abs(got[3][i].item() - want[3][i].item())
            out[f"dw{i}_err_{key}"] = err
            out[f"dw{i}_{key}"] = want[3][i].item()
            if not err <= 1e-5 * scales[i]:
                raise AssertionError(f"bwd {what} dw{i}: {err} > 1e-5 * {scales[i]}")
    elif got[3].abs().max().item() != 0.0:
        raise AssertionError(f"bwd {what}: dw without a geometry")
    return out


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
                   head_dim=HEAD_DIM, geometry=geometry, launches_per_step=per_fwd)
        dtypes = (("fp32", torch.float32), ("bf16", torch.bfloat16))
        if lk > FP32_MAX_KEYS:
            dtypes = dtypes[1:]
            row["fp32"] = f"not run: above the kernel's {FP32_MAX_KEYS} fp32 keys"
        for tag, dtype in dtypes:
            for rate in (0.0, 0.1):
                q, k, v, mask, kw = attention_inputs(lq, lk, geometry, dtype, device,
                                                     seed=lq + lk, batch=TRAIN_BATCH)
                g = torch.randn(q.shape, generator=torch.Generator().manual_seed(lq)
                                ).to(device, dtype)
                kw = dict(kw, compute_dtype=dtype, dropout_rate=rate,
                          deterministic=rate == 0.0, dropout_seed=4321)
                key = f"{tag}{'_dropout' if rate else ''}"
                row.update(bwd_errors(attn, f"{name} {key}", key, q, k, v, mask, g, kw, rate,
                                      4321, 2e-5 if dtype == torch.float32 else 2.0 ** -7))
        # timing in the main path's dtype, dropout as the text tower trains
        q, k, v, mask, kw = attention_inputs(lq, lk, geometry, torch.bfloat16, device,
                                             seed=7, batch=TRAIN_BATCH)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)
                        ).to(device, torch.bfloat16)
        rate = 0.1 if geometry is not None else 0.0
        kw = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=rate,
                  deterministic=rate == 0.0, dropout_seed=99)
        bnd, w, geo, r, seed = resolve_geometry(attn, q, kw, rate, 99)
        row["kernel_ms"] = time_ms(
            lambda: attn._launch_bwd(q, k, v, mask, g, HEADS, bnd, w, geo, r, seed))
        row["earlier_ms"] = time_ms(
            lambda: attn._launch_bwd_cuda_cores(q, k, v, mask, g, HEADS, bnd, w, geo, r, seed),
            samples=7, per_sample=4)
        row["plain_ms"] = time_ms(
            lambda: attn.fused_attention_bwd_reference(q, k, v, mask, g, HEADS, **kw))
        if not row["kernel_ms"] < row["earlier_ms"]:
            raise AssertionError(f"{name}: the tensor-core backward ({row['kernel_ms']} ms) is "
                                 f"no faster than the CUDA-core one ({row['earlier_ms']} ms)")
        # the call's device time by kernel: the dq pass, the dk/dv pass, the
        # sum of the dw partials
        row["device_ms_by_kernel"] = {
            t["name"].replace("(anonymous namespace)::", "")[:40]: t["ms"]
            for t in device_profile(
                lambda: attn._launch_bwd(q, k, v, mask, g, HEADS, bnd, w, geo, r, seed),
                top=4)["top"]}
        row["library_ms"] = None
        if geometry is None:
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
    edges = {}
    for case in EDGE_CASES:
        q, k, v, g, mask, kw = edge_inputs(case, device)
        for rate in (0.0, 0.1):
            call = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=rate,
                        deterministic=rate == 0.0, dropout_seed=23)
            key = f"{case[0]}{'_dropout' if rate else ''}"
            errs = bwd_errors(attn, f"edge {key}", key, q, k, v, mask, g, call, rate, 23,
                              2.0 ** -7)
            edges.update({n: e for n, e in errs.items() if "err" in n})
    emit(dict(phase="kernel_bwd", edges_bf16=edges))
    return rows, max(e for n, e in edges.items() if n.startswith("max_abs_err"))


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
# attention alone at L=2048 (8 Q tiles x 4 K tiles). The image path: FLAVA's
# fine-tune step (B=24) runs 12 image layers over 393 unpadded tokens, 12
# text layers over 128 with the multiplier from row 1, and 6 multimodal
# layers over 1 + 393 + 128 tokens without a mask; ViLT in fp32 takes these
# kernels over its 128 padded text + 290 image tokens (B=32). The geometry
# is None or (row_start, text_len, offset); text_len None is Lq.
FLASH_SHAPES = [
    ("triple_text", 64, 96, 96, "text", None, 12),
    ("vision", 64, 99, 99, "vision", None, 8),
    ("triple_vision_text", 64, 99, 195, "vision_text", None, 4),
    ("analogy_text", 64, 128, 128, "text", (0, None, 0), 0),
    ("analogy_vision_text", 64, 99, 227, "vision_text", None, 0),
    ("long_text", 8, 512, 512, "text", (0, None, 0), 0),
    ("long_vision_text", 8, 99, 611, "vision_text", None, 0),
    ("attention_2048", 8, 2048, 2048, "text", None, 0),
    ("flava_image", 24, 393, 393, "vision", None, 0),
    ("flava_text", 24, 128, 128, "text", (1, None, 0), 0),
    ("flava_multimodal", 24, 522, 522, "vision", None, 0),
    ("vilt_fp32_route", 32, 418, 418, "text_image", (1, 128, 0), 0),
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
        n_text = {"text": lk, "vision_text": lk - lq, "text_image": TEXT_LEN}[kind]
        lens = torch.randint(int(0.4 * n_text), n_text + 1, (b,), generator=g)
        mask = (torch.arange(n_text)[None] < lens[:, None]).float()
        mask = torch.cat([mask, torch.ones(b, lk - n_text)], dim=1)
    kw = {}
    if geometry is not None:
        row_start, geo_len, offset = geometry
        kw = dict(boundary=(lens // 2).to(device, torch.int32),
                  w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device),
                  row_start=row_start, text_len=geo_len, offset=offset)
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


def flash_dw_scales(fa, q, k, v, mask, go, lse, delta, bnd, w, geo, rate, seed,
                    block_q=None, block_k=None):
    """sum |dS · S_raw| over each analogy region, walking the logical tiles
    (by default JAX's (256, 512)) as the plain backward does: the scale of
    the dw0/dw1 sums."""
    import torch

    tiles = fa._Tiles(q.float(), k.float(), mask, HEADS, bnd, w, geo, rate, seed,
                      block_q or fa.BLOCK_Q, block_k or fa.BLOCK_K)
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
    each kernel, the CUDA-core backward pair in bf16 (``earlier_ms``: FAIL
    where a tensor-core kernel is not faster), the plain forward and the
    plain backward (one walk computes dq, dk and dv, so both backward
    kernels' rows carry its time), SDPA's forward and backward
    (forward-and-backward minus forward) where no analogy multiplier
    applies, and the bounds."""
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
                args = (HEADS, *resolve_geometry(fa, q, kw, rate, 4321),
                        fa.BLOCK_Q, fa.BLOCK_K)
                before, before_mma = flash_counts(), flash_mma_counts()
                out, lse = fa._launch_fwd(q, k, v, mask, *args)
                delta = fa._delta(go, out, HEADS)
                got = fa._launch_bwd(q, k, v, mask, go, lse, delta, *args)
                mma = int(dtype == torch.bfloat16)  # the dtype alone picks the route
                if (flash_counts() != {kernel: n + 1 for kernel, n in before.items()}
                        or flash_mma_counts() != {k_: n + mma for k_, n in before_mma.items()}):
                    raise AssertionError(f"flash {name} {key}: a wrapper counted no launch, or "
                                         "the backward took the other route")
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
                if geometry is not None:
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
        rate = 0.1 if kind in ("text", "text_image") else 0.0
        q, k, v, go, mask, kw = flash_inputs(b, lq, lk, kind, geometry, torch.bfloat16,
                                             device, seed=7)
        kw = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=rate,
                  deterministic=rate == 0.0, dropout_seed=99)
        args = (HEADS, *resolve_geometry(fa, q, kw, rate, 99), fa.BLOCK_Q, fa.BLOCK_K)
        out, lse = fa._launch_fwd(q, k, v, mask, *args)
        delta = fa._delta(go, out, HEADS)
        n = dict(samples=7, per_sample=3) if lq >= 2048 else {}
        row["fwd_ms"] = time_ms(lambda: fa._launch_fwd(q, k, v, mask, *args), **n)
        row["dkv_ms"] = time_ms(lambda: fa._launch_bwd_dkv(q, k, v, mask, go, lse, delta,
                                                           *args), **n)
        row["dq_ms"] = time_ms(lambda: fa._launch_bwd_dq(q, k, v, mask, go, lse, delta,
                                                         *args), **n)
        # the CUDA-core pair in bf16, which these calls ran before: the
        # tensor-core pair must beat it at every shape
        slow = dict(samples=7, per_sample=3)
        row["dkv_earlier_ms"] = time_ms(lambda: fa._launch_bwd_dkv_cuda_cores(
            q, k, v, mask, go, lse, delta, *args), **slow)
        row["dq_earlier_ms"] = time_ms(lambda: fa._launch_bwd_dq_cuda_cores(
            q, k, v, mask, go, lse, delta, *args), **slow)
        for kernel in ("dkv", "dq"):
            if not row[f"{kernel}_ms"] < row[f"{kernel}_earlier_ms"]:
                print(f"FAIL flash {name}: the tensor-core {kernel} kernel "
                      f"({row[f'{kernel}_ms']} ms) is no faster than the CUDA-core one "
                      f"({row[f'{kernel}_earlier_ms']} ms)", flush=True)
                raise AssertionError(f"flash {name}: {kernel} no faster than the CUDA-core "
                                     "kernel")
        row["plain_fwd_ms"] = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, mask, HEADS, **kw), **n)
        row["plain_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, mask, go, HEADS, out=out, lse=lse, **kw), **n)
        row["library_fwd_ms"] = row["library_bwd_ms"] = None
        if geometry is not None:
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


# The flash kernels' ragged edges, above all the tensor-core backward's
# 64-row chunks against the logical tiles (tests/test_torch_port_flash_edges
# .py holds the plain versions to JAX at the same cases): (name, B, Lq, Lk,
# geometry or None as (boundary per batch row, row_start, text_len, offset),
# batch row whose keys are all masked or None, (block_q, block_k)). Lq and
# Lk of 1, 255, 257, 511, 513 and 611; row_start 1 and the +290 offset; at
# 393 x 393 logical tiles of 96 x 160, which 64-row chunks straddle.
FLASH_EDGE_CASES = [
    ("1x1", 1, 1, 1, None, None, (256, 512)),
    ("255x257_masked_row", 2, 255, 257, None, 1, (256, 512)),
    ("257x255_rows_from_1", 2, 257, 255, ((100, 200), 1, None, 0), 0, (256, 512)),
    ("511x513", 2, 511, 513, None, 0, (256, 512)),
    ("513x511_offset_290", 2, 513, 511, ((1, 128), 1, None, 290), 1, (256, 512)),
    ("611x1", 2, 611, 1, None, None, (256, 512)),
    ("1x611", 2, 1, 611, ((0, 300), 0, 611, 0), 0, (256, 512)),
    ("393x393_tiles_96x160", 2, 393, 393, ((60, 100), 1, None, 0), 1, (96, 160)),
]


def flash_bwd_sizes(want, q, k, v, go, lk):
    """The size each of dq, dk and dv is held to 2^-7 of: its largest
    |value|. With one key (Lk = 1) p is 1 and every dS = dP - delta cancels
    to fp32 rounding noise on both sides (delta = rowsum(g * out) is summed
    outside the kernels, as JAX does, dP inside them), so dq and dk are held
    to the size they would have without the cancellation, scale·max|dP|·
    max(|q|, |k|)."""
    sizes = [c.float().abs().max().item() for c in want[:3]]
    if lk == 1:
        dp = (go.float().unflatten(-1, (HEADS, HEAD_DIM))
              * v.float().unflatten(-1, (HEADS, HEAD_DIM))).sum(-1).abs().max().item()
        top = HEAD_DIM ** -0.5 * dp * max(q.float().abs().max().item(),
                                          k.float().abs().max().item())
        sizes[0], sizes[1] = max(sizes[0], top), max(sizes[1], top)
    return sizes


def flash_edge_phase(device):
    """The flash kernels in bf16 (the backward pair on the tensor cores)
    against their plain versions at FLASH_EDGE_CASES (12 heads of 64; the
    last eighth of the keys padded), dropout 0 and 0.1 with the same seed,
    so the masks must agree: the forward within 2e-2 absolute; the backward,
    from the kernel forward's out and lse, within 2^-7 of each result's size
    (flash_bwd_sizes), dw within 1e-5 of its sum of |terms|. Returns the
    largest backward error."""
    import torch

    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    errs = {}
    for case in FLASH_EDGE_CASES:
        name, lq, lk, (bq, bk) = case[0], case[2], case[3], case[6]
        q, k, v, go, mask, kw = edge_inputs(case[:6], device)
        for rate in (0.0, 0.1):
            key = f"{name}{'_dropout' if rate else ''}"
            call = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=rate,
                        deterministic=rate == 0.0, dropout_seed=23, block_q=bq, block_k=bk)
            args = (HEADS, *resolve_geometry(fa, q, kw, rate, 23), bq, bk)
            before = flash_mma_counts()
            out, lse = fa._launch_fwd(q, k, v, mask, *args)
            delta = fa._delta(go, out, HEADS)
            got = fa._launch_bwd(q, k, v, mask, go, lse, delta, *args)
            if flash_mma_counts() != {n: c + 1 for n, c in before.items()}:
                raise AssertionError(f"flash edge {key}: the tensor-core pair was not launched")
            want_out, _ = fa._plain_fwd(q, k, v, mask, *args[:6], torch.bfloat16, bq, bk)
            want = fa.flash_attention_bwd_reference(q, k, v, mask, go, HEADS, out=out, lse=lse,
                                                    **call)
            torch.cuda.synchronize()
            err = (out.float() - want_out.float()).abs().max().item()
            errs[f"fwd_max_abs_err_{key}"] = err
            if not err <= 2e-2:
                raise AssertionError(f"flash edge fwd {key}: {err} > 2e-2")
            sizes = flash_bwd_sizes(want, q, k, v, go, lk)
            for t_name, a, c, size in zip(("dq", "dk", "dv"), got[:3], want[:3], sizes):
                err = (a.float() - c.float()).abs().max().item()
                errs[f"max_abs_err_{t_name}_{key}"] = err
                if not err <= 2.0 ** -7 * size:
                    raise AssertionError(f"flash edge bwd {key} {t_name}: {err} > 2^-7 * {size}")
            if kw:
                scales = flash_dw_scales(fa, q, k, v, mask, go, lse, delta, *args[1:6], bq, bk)
                for i in range(2):
                    err = abs(got[3][i].item() - want[3][i].item())
                    errs[f"dw{i}_err_{key}"] = err
                    if not err <= 1e-5 * scales[i]:
                        raise AssertionError(f"flash edge bwd {key} dw{i}: {err} > "
                                             f"1e-5 * {scales[i]}")
            elif got[3].abs().max().item() != 0.0:
                raise AssertionError(f"flash edge bwd {key}: dw without a geometry")
    emit(dict(phase="flash_edges", dtype="bfloat16", **errs))
    return max(e for n, e in errs.items() if n.startswith("max_abs_err"))


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


def flash_mma_counts():
    """Launches of the tensor-core (bf16) flash backward pair alone; the
    dK/dV and dQ counts of flash_counts take either route."""
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    return dict(dkv=fa.LAUNCHES_FLASH_DKV_MMA, dq=fa.LAUNCHES_FLASH_DQ_MMA)


def reset_counts():
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa
    from mkg_analogy_tpu_torch.kernels import image_prep as ip

    attn.LAUNCHES = attn.LAUNCHES_BWD = 0
    fa.LAUNCHES_FLASH = fa.LAUNCHES_FLASH_DKV = fa.LAUNCHES_FLASH_DQ = 0
    fa.LAUNCHES_FLASH_DKV_MMA = fa.LAUNCHES_FLASH_DQ_MMA = 0
    ip.LAUNCHES_RESIZE = 0


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
            if flash_counts() != dict(fwd=n, dkv=n, dq=n) or any(flash_mma_counts().values()):
                raise AssertionError(f"fp32 pre-train step {backend}: launches {flash_counts()}, "
                                     f"tensor-core {flash_mma_counts()}")
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
        launches.append(dict(flash_counts(), **{f"{k}_mma": n
                                                for k, n in flash_mma_counts().items()}))
        losses.append(metrics["loss"].item())
    if any(n != dict(fwd=24, dkv=24, dq=24, dkv_mma=24, dq_mma=24) for n in launches):
        raise AssertionError(f"bf16 pre-train steps: launches {launches}, expected 24 each, "
                             "the backward pair's on the tensor cores")
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
        if (flash_counts() != dict(fwd=24, dkv=24, dq=24) or attn.LAUNCHES or attn.LAUNCHES_BWD
                or flash_mma_counts() != dict(dkv=24, dq=24)):
            raise AssertionError(f"L=512 step: flash {flash_counts()}, tensor-core "
                                 f"{flash_mma_counts()}, single "
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
        # the main path's launches, all three formats; the backward pair's
        # all on the tensor cores
        total = dict(flash_counts(), **{f"{k}_mma": n for k, n in flash_mma_counts().items()})
        if (total["dkv_mma"], total["dq_mma"]) != (total["dkv"], total["dq"]):
            raise AssertionError(f"cli pretrain: a bf16 backward left the tensor cores: {total}")

        ft_dir = os.path.join(root, "finetune")
        reset_counts()
        metrics = cli.main(argv(ft_dir, "--checkpoint", os.path.join(root, "triple", "ckpt"),
                                "--max_seq_length", "128", "--batch_size", "32",
                                "--max_epochs", "1"))
        launches = flash_counts()
        expect = dict(fwd=24 * (4 + 1 + 2), dkv=24 * 4, dq=24 * 4)
        if (launches != expect or attn.LAUNCHES or attn.LAUNCHES_BWD
                or flash_mma_counts() != dict(dkv=24 * 4, dq=24 * 4)):
            raise AssertionError(f"cli fine-tune from the pre-train checkpoint: {launches}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cli fine-tune from the pre-train checkpoint: {metrics}")
        runs["finetune_from_triple"] = dict(launches=launches, mrr=metrics["Eval_entity/mrr"])
    emit(dict(phase="cli_pretrain", dtype="bfloat16", batch_size=64, steps_per_format=3,
              launches=total, **runs))
    return total


# The resize kernel's shapes: (name, B, out size, statistics, extents). The
# image tool resizes 64 decoded canvases a launch (fewer in the last chunk of
# a run and for an entity's few images) and one in its vit mode; 224 px with
# the CLIP or ImageNet statistics, 384 px with ViLT's. "full": every image
# fills the 512 x 512 canvas; "mixed": the true extents vary (full canvas,
# 1 x 1, one row, one column, narrower than the output, non-square) and the
# canvas outside the extent holds 255 in every other image, which must not
# be read; "one": one image of 300 x 200 px, 255 outside. A single
# F.interpolate call computes the same where every image has one extent.
RESIZE_SHAPES = [
    ("full_224_clip", 64, 224, "clip", "full"),
    ("mixed_224_clip", 64, 224, "clip", "mixed"),
    ("mixed_384_vilt", 64, 384, "vilt", "mixed"),
    ("single_224_clip", 1, 224, "clip", "one"),
]
RESIZE_OPS_PER_PIXEL = 70   # fp32 operations of one output pixel (two taps, 3 channels)
FP32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, fp32 outside the tensor cores


def resize_inputs(b, extents, device, seed):
    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.kernels.image_prep import CANVAS

    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (b, CANVAS, CANVAS, 3), dtype=np.uint8)
    if extents == "full":
        sizes = np.full((b, 2), CANVAS, np.int32)
    elif extents == "one":
        sizes = np.tile(np.array([[300, 200]], np.int32), (b, 1))
        canvas[:, 300:] = 255
        canvas[:, :, 200:] = 255
    else:
        sizes = np.stack([rng.integers(1, CANVAS + 1, b), rng.integers(1, CANVAS + 1, b)],
                         1).astype(np.int32)
        fixed = [(CANVAS, CANVAS), (1, 1), (1, CANVAS), (CANVAS, 1), (100, 37), (37, 300),
                 (223, 225), (500, 3)]
        sizes[: len(fixed)] = fixed[:b]
        for i, (h, w) in enumerate(sizes):
            outside = 255 if i % 2 else 0
            canvas[i, h:] = outside
            canvas[i, :, w:] = outside
    return torch.from_numpy(canvas).to(device), torch.from_numpy(sizes).to(device)


def image_kernel_phase(device):
    """The resize-and-normalise kernel against resize_normalize_reference
    (the interpolation matrices and two einsums, fp32 without TF32) at
    RESIZE_SHAPES, within 1e-5 absolute: where the source coordinate lands
    within an ulp of an integer the two may floor to neighbouring pixels, and
    the result is continuous there. Times of the kernel and of the plain
    version; the bound from this run's extents (an image: min(h, 2S) x
    min(w, 2S) x 3 bytes read, since an output pixel takes a 2 x 2 tap and
    above 2S the taps of neighbouring outputs no longer touch, the two int32
    extents read, 3 x S x S fp32 written; the operations bound nothing); and,
    where every image has the same extent (h, w), one F.interpolate call
    (bilinear, align_corners=False, antialias=False) on the (h, w) corner of
    the canvases as fp32 (B, 3, h, w) in [0, 1]: the yardstick's time is that
    call alone, its error is taken after the same normalisation."""
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.kernels import image_prep as ip

    stats = dict(clip=(ip.CLIP_MEAN, ip.CLIP_STD), vilt=(ip.VILT_MEAN, ip.VILT_STD))
    rows = []
    for name, b, size, stat, extents in RESIZE_SHAPES:
        mean, std = stats[stat]
        canvas, sizes = resize_inputs(b, extents, device, seed=size + b)
        before = ip.LAUNCHES_RESIZE
        got = ip.resize_normalize(canvas, sizes, size, mean, std)
        if ip.LAUNCHES_RESIZE != before + 1:
            raise AssertionError(f"resize {name}: the wrapper counted no launch")
        want = ip.resize_normalize_reference(canvas, sizes, size, mean, std)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if got.shape != (b, 3, size, size) or not torch.isfinite(got).all() or not err <= 1e-5:
            raise AssertionError(f"resize {name}: kernel vs plain {err} > 1e-5")
        row = dict(shape=name, B=b, out_size=size, stats=stat, extents=extents,
                   max_abs_err=err)
        row["kernel_ms"] = time_ms(lambda: ip.resize_normalize(canvas, sizes, size, mean, std))
        row["plain_ms"] = time_ms(
            lambda: ip.resize_normalize_reference(canvas, sizes, size, mean, std),
            samples=7, per_sample=2)
        hw = sizes.long().clamp(max=2 * size).prod(dim=1).sum().item()
        row["bytes_ms"] = (3 * hw + 8 * b + b * 3 * size * size * 4) / HBM_BYTES_PER_S * 1e3
        row["operations_ms"] = (b * size * size * RESIZE_OPS_PER_PIXEL
                                / FP32_FLOPS_PER_S * 1e3)
        row["bound_ms"] = max(row["bytes_ms"], row["operations_ms"])
        row["bound_by"] = bound_by(row["bytes_ms"], row["operations_ms"])
        if extents in ("full", "one"):
            h, w = sizes[0].tolist()
            x = (canvas[:, :h, :w].permute(0, 3, 1, 2).float() / 255.0).contiguous()

            def interpolate():
                return F.interpolate(x, size=(size, size), mode="bilinear",
                                     align_corners=False, antialias=False)

            m = torch.tensor(mean, device=device).view(1, 3, 1, 1)
            s = torch.tensor(std, device=device).view(1, 3, 1, 1)
            row["library_max_abs_err"] = ((interpolate() - m) / s - want).abs().max().item()
            row["library_ms"] = time_ms(interpolate)
            # the same function up to its own rounding of the source coordinate,
            # which near coordinate 300 moves a noisy image by several 1e-5
            if not row["library_max_abs_err"] <= 1e-3:
                raise AssertionError(f"resize {name}: F.interpolate is not the same function "
                                     f"({row['library_max_abs_err']} from the plain version)")
            row["library_note"] = ("F.interpolate alone, on images already fp32 NCHW in "
                                   "[0, 1]; the conversion and the normalisation are not timed")
        else:
            row["library_ms"] = None
            row["library_note"] = ("no single PyTorch call resizes images of different "
                                   "extents in one batch")
        rows.append(row)
        emit(dict(phase="image_kernel", **row))
        del canvas, sizes, got, want
    torch.cuda.empty_cache()
    return rows


def write_image_tree(images_dir, entities, seed=0):
    """One folder of 1-5 image files per entity, PNG and JPEG, heights and
    widths from 8 to 320 px; the first entity also gets a 700 x 600 file
    (larger than the canvas: the host downsizes it), a 512 x 512 one and a
    1 x 1 one. Smooth random content (coarse noise, enlarged), so the
    resized values vary."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    n_files = 0
    for i, e in enumerate(entities):
        os.makedirs(os.path.join(images_dir, e))
        shapes = [tuple(rng.integers(8, 321, 2)) for _ in range(rng.integers(1, 6))]
        if i == 0:
            shapes += [(700, 600), (512, 512), (1, 1)]
        for j, (h, w) in enumerate(shapes):
            coarse = rng.integers(0, 256, (-(-h // 8), -(-w // 8), 3), dtype=np.uint8)
            arr = np.kron(coarse, np.ones((8, 8, 1), np.uint8))[:h, :w]
            ext = "jpg" if j % 3 == 2 else "png"
            Image.fromarray(arr).save(os.path.join(images_dir, e, f"{j}.{ext}"))
            n_files += 1
    return n_files


def image_tool_phase(device):
    """The image tool (``mkg_analogy_tpu_torch.tools.encode_images.main``)
    over an entity-image tree written here with PIL: 40 of 48 entities have
    images. ``pixels`` at 224 px (CLIP statistics) and at 384 px (ViLT's),
    ``vgg`` (VGG16 through fc7 at full width, fp32) and ``vit`` (ViT-B/16 at
    full width, fp32, attention through the single-block kernel), the
    encoders from seeded random weights; the launch counts set to 0 before
    each run and read after it. Each store has its shape, is finite, is what
    ``numpy.load`` reads back, has zero rows exactly for the entities without
    images; the pixel stores equal the plain version's output for the same
    files within 1e-5; the vit store equals, within 1e-4 of its largest
    value, the store of the same encoder with the plain attention."""
    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.data.images import open_store
    from mkg_analogy_tpu_torch.data.readers import MarKG
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import image_prep as ip
    from mkg_analogy_tpu_torch.tools import encode_images as tool

    n_ent, n_with = 48, 40
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_images_", dir=".") as root:
        markg_dir, _ = write_dataset(root, n_ent=n_ent)
        images = os.path.join(root, "images")
        n_files = write_image_tree(images, [f"Q{i}" for i in range(n_with)], seed=1)
        markg = MarKG(markg_dir)
        entity_files = tool.list_entity_images(images, markg.entities)
        with_images = sorted(markg.ent2id[e] for e in entity_files)
        without = sorted(set(range(n_ent)) - set(with_images))
        t0 = time.perf_counter()
        decoded = {e: [tool.decode_to_canvas(p) for p in files]
                   for e, files in entity_files.items()}
        decode_seconds = time.perf_counter() - t0

        def run(tag, *flags):
            path = os.path.join(root, f"{tag}.npy")
            reset_counts()
            t0 = time.perf_counter()
            store = tool.main(["--images_dir", images, "--markg", markg_dir, "--out", path,
                               "--device", "cuda", *flags])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(resize=ip.LAUNCHES_RESIZE, attention_fwd=attn.LAUNCHES)
            if not np.array_equal(np.load(path), store) or not np.isfinite(store).all():
                raise AssertionError(f"image tool {tag}: the store on disk is not finite or "
                                     "not what main returned")
            rows = np.abs(store).reshape(store.shape[0], -1).max(axis=1)
            if not (rows[with_images] > 0).all() or rows[without].any():
                raise AssertionError(f"image tool {tag}: zero rows where images are, or "
                                     "values where none is")
            return path, store, seconds, launches

        for tag, size, stat in (("pixels_224_clip", 224, "clip"), ("pixels_384_vilt", 384, "vilt")):
            path, store, seconds, launches = run(tag, "--mode", "pixels", "--size", str(size),
                                                 "--stats", stat, "--seed", "1")
            if store.shape != (n_ent, 3, size, size):
                raise AssertionError(f"image tool {tag}: store {store.shape}")
            if launches != dict(resize=math.ceil(n_with / 64), attention_fwd=0):
                raise AssertionError(f"image tool {tag}: launches {launches}")
            rng = np.random.default_rng(1)
            mean, std = ((ip.CLIP_MEAN, ip.CLIP_STD) if stat == "clip"
                         else (ip.VILT_MEAN, ip.VILT_STD))
            err = 0.0
            for e, files in entity_files.items():
                canvas, hw = decoded[e][rng.integers(len(files))]
                want = ip.resize_normalize_reference(
                    torch.from_numpy(canvas)[None].to(device),
                    torch.tensor([hw], dtype=torch.int32, device=device), size, mean, std)
                err = max(err, float(np.abs(want[0].cpu().numpy()
                                            - store[markg.ent2id[e]]).max()))
            if not err <= 1e-5:
                raise AssertionError(f"image tool {tag}: store vs plain version {err} > 1e-5")
            opened = open_store(path, n_ent, size).gather(np.asarray(with_images[:2]))
            if opened.shape != (2, 1, 3, size, size):
                raise AssertionError(f"image tool {tag}: open_store gathers {opened.shape}")
            out[tag] = dict(store=list(store.shape), images=n_with, seconds=seconds,
                            images_per_sec=n_with / seconds, launches=launches,
                            max_abs_err_vs_plain=err)

        path, store, seconds, launches = run("vgg", "--mode", "vgg")
        if store.shape != (n_ent + 1, 4096) or store[n_ent].any():
            raise AssertionError(f"image tool vgg: store {store.shape} or a pad row with values")
        if launches != dict(resize=n_with, attention_fwd=0):
            raise AssertionError(f"image tool vgg: launches {launches}")
        out["vgg"] = dict(store=list(store.shape), images=n_files, seconds=seconds,
                          images_per_sec=n_files / seconds, launches=launches)

        path, store, seconds, launches = run("vit", "--mode", "vit", "--seed", "1")
        if store.shape != (n_ent, 1000):
            raise AssertionError(f"image tool vit: store {store.shape}")
        if launches != dict(resize=n_with, attention_fwd=12 * n_with):
            raise AssertionError(f"image tool vit: launches {launches}")
        model = tool.make_encoder("vit", device)
        set_backend(model, "plain")
        plain = tool.vit_store(((markg.ent2id[e], d[:8]) for e, d in decoded.items()), n_ent,
                               model, ip.CLIP_MEAN, ip.CLIP_STD, device)
        err, top = float(np.abs(plain - store).max()), float(np.abs(plain).max())
        if not err <= 1e-4 * top:
            raise AssertionError(f"image tool vit: kernel attention vs plain {err} > 1e-4 * {top}")
        n_decoded = sum(min(len(f), 8) for f in entity_files.values())
        out["vit"] = dict(store=list(store.shape), entities=n_with, images_decoded=n_decoded,
                          seconds=seconds, entities_per_sec=n_with / seconds,
                          launches=launches, max_abs_err_vs_plain_attention=err,
                          largest_value=top)
        del model
    torch.cuda.empty_cache()
    total = dict(resize=sum(r["launches"]["resize"] for r in out.values()),
                 attention_fwd=out["vit"]["launches"]["attention_fwd"])
    emit(dict(phase="image_tool", pil=True, entities=n_ent, entities_with_images=n_with,
              image_files=n_files, host_decode_seconds=decode_seconds,
              host_decode_images_per_sec=n_files / decode_seconds, launches=total, **out))
    return total


def all_counts():
    from mkg_analogy_tpu_torch.kernels import attention as attn

    return dict(single_fwd=attn.LAUNCHES, single_bwd=attn.LAUNCHES_BWD,
                **{f"flash_{k}": n for k, n in flash_counts().items()},
                **{f"flash_{k}_mma": n for k, n in flash_mma_counts().items()})


# The two families that read the tool's pixel stores, at the recipes of
# scripts/run_finetune_vilt.sh and scripts/run_finetune_flava.sh (L=128).
# ``calls``: attention calls of one forward (ViLT 12 layers over 128 + 290
# tokens; FLAVA 12 image layers over 393, 12 text layers over 128 and 6
# multimodal layers over 522). ``auto_flash``: the calls whose query length
# reaches FLASH_AUTO_MIN_LEN, which the plain route sends to the flash
# kernels. ``backend``: the card's default (models/registry.py).
FAMILIES = {
    "vilt": dict(model_class="ViltKGC", batch=32, image=384, alpha=0.3, lr=4e-5,
                 stats="vilt", backend="single", calls=12, auto_flash=0),
    "flava": dict(model_class="FlavaKGC", batch=24, image=224, alpha=0.45, lr=5e-5,
                  stats="clip", backend="flash", calls=30, auto_flash=6),
}


def family_counts(backend, calls, backward=True, bf16=True):
    """all_counts of a step (or a forward) through ``backend``; in bf16 the
    flash backward pair runs on the tensor cores."""
    n_b = calls if backward else 0
    zero = dict(single_fwd=0, single_bwd=0, flash_fwd=0, flash_dkv=0, flash_dq=0,
                flash_dkv_mma=0, flash_dq_mma=0)
    if backend == "single":
        return dict(zero, single_fwd=calls, single_bwd=n_b)
    n_mma = n_b if bf16 else 0
    return dict(zero, flash_fwd=calls, flash_dkv=n_b, flash_dq=n_b, flash_dkv_mma=n_mma,
                flash_dq_mma=n_mma)


def family_phase(device, name):
    """A full-width ViLT or FLAVA fine-tune step at its recipe's batch,
    L=128, dropout on. (1) fp32, from one state dict, batch and seeds,
    through the flash kernels (the single-block kernel holds 400 keys in
    fp32, fewer than either family attends over) and through autograd of
    the kernels' plain version. Gates: the loss within 1e-5 relative; each
    gradient leaf within 1e-3 of that leaf's largest |gradient| plus 1e-6 of
    the model's largest. Then, with the attention dropout off and the
    hidden dropout on, through the flash kernels and through the plain
    attention: over more than 256 queries the flash kernels draw their
    dropout mask per (256, 512) tile and the plain attention draws one over
    the whole block, so with attention dropout the two are different draws.
    The plain attention sends FLAVA's 522-token multimodal tower to the
    flash kernels, as in JAX. Gate: the loss within 1e-5 relative; the
    leaves' ratio is printed. (2) bf16 through the family's default
    kernels, the main path: a forward, then 6 AdamW steps on one batch, the
    loss finite and falling, the launches of every step, the median step
    over steps 3-6 and a device profile of one step; for ViLT then four more
    steps of the same model through the flash kernels, the other route its
    418 tokens could take."""
    import torch

    from mkg_analogy_tpu_torch.kernels import flash_attention as fa
    from mkg_analogy_tpu_torch.models import common
    from mkg_analogy_tpu_torch.models.common import DropoutRNG
    from mkg_analogy_tpu_torch.models.registry import create_model
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig, finetune_positions

    fam = FAMILIES[name]
    b, calls = fam["batch"], fam["calls"]
    batch = train_batch(device, b=b, seed=6)
    g = torch.Generator().manual_seed(7)
    batch["pixel_values"] = torch.randn(b, 2, 3, fam["image"], fam["image"],
                                        generator=g).to(device)
    out = {}
    with torch.device(device):
        model = create_model(fam["model_class"], vocab_size=42112, dtype="float32",
                             attention="flash")
    model.init_params(torch.Generator(device=device).manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(alpha=fam["alpha"]),
                          device=device)
    runs = {}
    common.ATTENTION_BACKENDS["flash_plain"] = fa.flash_attention_reference
    try:
        # (run, backend, attention dropout, flash launches of each kind)
        for run, backend, rate, n in (
                ("flash", "flash", 0.1, calls), ("flash_plain", "flash_plain", 0.1, 0),
                ("flash_nodrop", "flash", 0.0, calls),
                ("plain_nodrop", "plain", 0.0, fam["auto_flash"])):
            model.load_state_dict(state)
            for m in model.modules():
                if isinstance(m, common.AttentionCore):
                    m.backend, m.dropout_rate = backend, rate
            model.zero_grad(set_to_none=True)
            reset_counts()
            loss, _ = trainer._finetune_loss(batch, DropoutRNG.from_seed(5, device))
            loss.backward()
            torch.cuda.synchronize()
            if all_counts() != family_counts("flash", n, bf16=False):
                raise AssertionError(f"{name} fp32 step {run}: launches {all_counts()}")
            runs[run] = (loss.item(), {k: None if p.grad is None else p.grad.clone()
                                       for k, p in model.named_parameters()})
    finally:
        del common.ATTENTION_BACKENDS["flash_plain"]
    for got, ref in (("flash", "flash_plain"), ("flash_nodrop", "plain_nodrop")):
        a, c = runs[got][0], runs[ref][0]
        if not (math.isfinite(a) and abs(a - c) <= 1e-5 * abs(c)):
            raise AssertionError(f"{name} fp32 loss: {got} {a} vs {ref} {c}")
    worst, worst_name = leaf_ratios(runs["flash"][1], runs["flash_plain"][1])
    if not worst <= 1.0:
        raise AssertionError(f"{name} fp32 grad {worst_name}: kernels vs their plain version "
                             f"at {worst} of the bar")
    no_grad = sorted(k for k, g in runs["flash"][1].items() if g is None)
    if no_grad:
        raise AssertionError(f"{name} fp32 step: no gradient reached {no_grad}")
    lk, lp = runs["flash_nodrop"][0], runs["plain_nodrop"][0]
    out["fp32"] = dict(
        loss_kernels=runs["flash"][0], loss_kernels_plain_version=runs["flash_plain"][0],
        grad_leaves=len(runs["flash"][1]),
        worst_err_over_bar_vs_plain_version=worst, worst_leaf=worst_name,
        loss_kernels_no_attention_dropout=lk, loss_plain_attention_no_attention_dropout=lp,
        loss_rel_diff_plain_attention=abs(lk - lp) / abs(lp),
        worst_err_over_bar_vs_plain_attention=leaf_ratios(runs["flash_nodrop"][1],
                                                          runs["plain_nodrop"][1]),
        launches=family_counts("flash", calls, bf16=False))
    del runs, model, trainer
    torch.cuda.empty_cache()

    with torch.device(device):
        model = create_model(fam["model_class"], vocab_size=42112, dtype="bfloat16",
                             attention=fam["backend"])
    model.load_state_dict(state)
    del state
    reset_counts()
    with torch.inference_mode():
        trans = model(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"],
                      token_type_ids=batch["token_type_ids"],
                      pixel_values=batch["pixel_values"], positions=finetune_positions(batch),
                      boundary=batch["sep_idx"][:, 2])
        logits = model.logits(trans[:, 0], vocab_ids=torch.arange(20000, 22063, device=device))
        torch.cuda.synchronize()
    if all_counts() != family_counts(fam["backend"], calls, backward=False) \
            or logits.shape != (b, 2063) or not torch.isfinite(logits).all():
        raise AssertionError(f"{name} bf16 forward: launches {all_counts()}, logits "
                             f"{tuple(logits.shape)}")
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(alpha=fam["alpha"], seed=3),
                          device=device)
    opt = make_optimizer(model, 1e-4, 100, warmup_ratio=0.0)
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    expect = family_counts(fam["backend"], calls)
    for step in range(6):
        reset_counts()
        t0 = time.perf_counter()
        metrics = trainer._train_step(opt, batch, step)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if all_counts() != expect:
            raise AssertionError(f"{name} bf16 step {step}: launches {all_counts()}, "
                                 f"expected {expect}")
        losses.append(metrics["loss"].item())
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} bf16 loss did not fall: {losses}")
    step_ms = statistics.median(times[2:])
    out["bf16"] = dict(backend=fam["backend"], losses=losses, step_ms=times,
                       median_step_ms=step_ms, examples_per_sec=b / step_ms * 1e3,
                       launches_per_step=expect,
                       peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                       device_profile_step=device_profile(
                           lambda: trainer._train_step(opt, batch, 6), top=12))
    if fam["backend"] == "single":
        # the same model and optimizer state through the flash kernels: which
        # route is the faster default at this family's lengths
        set_backend(model, "flash")
        flash_times = []
        for step in range(6, 10):
            reset_counts()
            t0 = time.perf_counter()
            trainer._train_step(opt, batch, step)
            torch.cuda.synchronize()
            flash_times.append((time.perf_counter() - t0) * 1e3)
            if all_counts() != family_counts("flash", calls):
                raise AssertionError(f"{name} bf16 flash step: launches {all_counts()}")
        out["bf16_through_flash"] = dict(
            step_ms=flash_times, median_step_ms=statistics.median(flash_times[1:]),
            device_profile_step=device_profile(
                lambda: trainer._train_step(opt, batch, 10), top=6))
        set_backend(model, "single")
    emit(dict(phase=name, B=b, L=128, image_size=fam["image"], **out))
    del model, trainer, opt
    torch.cuda.empty_cache()
    return expect


def cli_image_phase():
    """The main path of the image slice, end to end, for ViLT (384-px store,
    ViLT statistics) and FLAVA (224-px store, CLIP statistics): the image
    tool's ``pixels`` mode writes a store for the dataset of write_dataset
    from an image tree written here (56 of its 64 entities have images);
    ``cli.main --model_class ... --image_features <that store>`` fine-tunes
    one epoch in bf16 at the family's recipe (128 examples: 4 steps at B=32,
    5 at B=24, the last batch dropped), evaluates dev (1 batch) and test (2
    batches) and tests the best-dev checkpoint; ``--only_test --checkpoint``
    reproduces the ranks. The counts are set to 0 before each family's run
    (tool and fine-tune) and read after it."""
    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import image_prep as ip
    from mkg_analogy_tpu_torch.tools import encode_images as tool

    n_train, n_test, n_with = 128, 200, 56
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_image_cli_", dir=".") as root:
        markg, mars = write_dataset(root, n_train=n_train, n_test=n_test)
        images = os.path.join(root, "images")
        write_image_tree(images, [f"Q{i}" for i in range(n_with)], seed=2)
        for name, fam in FAMILIES.items():
            store = os.path.join(root, f"{name}_pixels.npy")

            def argv(out_dir, *extra):
                return ["--data_dir", mars, "--pretrain_path", markg, "--device", "cuda",
                        "--model_class", fam["model_class"], "--image_features", store,
                        "--dtype", "bfloat16", "--max_seq_length", "128",
                        "--output_dir", out_dir, "--log_dir", os.path.join(root, f"logs_{name}"),
                        "--cache_dir", os.path.join(root, "cache"), *extra]

            reset_counts()
            t0 = time.perf_counter()
            tool.main(["--images_dir", images, "--markg", markg, "--out", store,
                       "--mode", "pixels", "--size", str(fam["image"]),
                       "--stats", fam["stats"], "--device", "cuda"])
            tool_seconds = time.perf_counter() - t0
            fit_dir = os.path.join(root, f"{name}_fit")
            t0 = time.perf_counter()
            metrics = cli.main(argv(fit_dir, "--max_epochs", "1",
                                    "--batch_size", str(fam["batch"]), "--lr", str(fam["lr"]),
                                    "--alpha", str(fam["alpha"])))
            seconds = time.perf_counter() - t0
            launches = dict(all_counts(), resize=ip.LAUNCHES_RESIZE)
            steps = n_train // fam["batch"]
            fwd_only = family_counts(fam["backend"], fam["calls"], backward=False)
            both = family_counts(fam["backend"], fam["calls"])
            expect = {k: both[k] * steps + fwd_only[k] * (1 + math.ceil(n_test / 128))
                      for k in both}
            expect["resize"] = math.ceil(n_with / 64)
            if launches != expect:
                raise AssertionError(f"cli {name}: launches {launches}, expected {expect}")
            if not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"cli {name}: non-finite test metrics {metrics}")
            ranks = np.load(os.path.join(fit_dir, "test_ranks.npz"))["ranks"]
            test_dir = os.path.join(root, f"{name}_retest")
            retest = cli.main(argv(test_dir, "--only_test", "--checkpoint",
                                   os.path.join(fit_dir, "ckpt")))
            again = np.load(os.path.join(test_dir, "test_ranks.npz"))["ranks"]
            if len(ranks) != n_test or not np.array_equal(again, ranks) or retest != metrics:
                raise AssertionError(f"cli {name}: --only_test --checkpoint did not reproduce "
                                     f"the fit's test ranks ({float((again == ranks).mean())} "
                                     "alike)")
            with open(os.path.join(root, f"logs_{name}", "train_metrics.jsonl")) as f:
                epoch = next(r for r in map(json.loads, f) if "train/examples_per_sec" in r)
            runs[name] = dict(
                store=[64, 3, fam["image"], fam["image"]], tool_seconds=tool_seconds,
                batch_size=fam["batch"], steps=steps, launches=launches, seconds=seconds,
                test_mrr=metrics["Eval_entity/mrr"], test_hits10=metrics["Eval_entity/hits10"],
                examples_per_sec_after_step_1=epoch["train/examples_per_sec"],
                last_loss=epoch["train/last_loss"], retest_ranks_identical=True)
            torch.cuda.empty_cache()
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["vilt"]["launches"]}
    emit(dict(phase="cli_image", dtype="bfloat16", train_examples=n_train,
              entities_with_images=n_with, launches=total, **runs))
    return total


# (name, source of the main paths' kernel, source of the fp32 route's or
# None, line of the Pallas kernel body it replaces)
FLASH_KERNELS = {
    "fwd": ("flash_attention_fwd", "flash_attention_fwd.cu", None, 98),
    "dkv": ("flash_attention_bwd_dkv", "flash_attention_bwd_mma.cu", "flash_attention_bwd.cu",
            183),
    "dq": ("flash_attention_bwd_dq", "flash_attention_bwd_mma.cu", "flash_attention_bwd.cu",
           271),
}


def flash_entry(rows, kernel, launches, edge_err):
    """One flash kernel's entry of the {"kernels": ...} line. Its times and
    bounds are per triple pre-train step at B=64 (12 text 96 x 96, 8 vision
    99 x 99 and 4 vision-text 99 x 195 calls, no analogy multiplier, so SDPA
    is the library yardstick of every call); plain_ms is the plain forward,
    or for both backward kernels the plain backward, which computes dq, dk
    and dv in one walk; library_ms likewise SDPA's forward or its whole
    backward; a backward kernel's earlier_ms is the CUDA-core kernel's in
    bf16. Errors are the largest over every shape (and, of the backward
    pair, over the edge cases)."""
    name, source, source_fp32, line = FLASH_KERNELS[kernel]
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
    entry = dict(
        name=name, route="cuda", source=f"mkg_analogy_tpu_torch/csrc/{source}",
        replaces=f"mkg_analogy_tpu/kernels/flash_attention.py:{line}", ok=True,
        launches=launches, max_abs_err=max(err), max_abs_err_fp32=max(err32),
        ms=per_step(f"{kernel}_ms"), plain_ms=per_step(plain),
        bound_ms=max(t_bytes, t_ops), bound_by=bound_by(t_bytes, t_ops),
        library_ms=per_step(library),
        shapes=[{k: v for k, v in r.items()
                 if k.startswith((kernel, "shape", "B", "L", "tiles", plain, library))}
                for r in rows])
    if source_fp32:  # bf16 on the tensor cores, fp32 on the CUDA cores
        entry.update(source_fp32=f"mkg_analogy_tpu_torch/csrc/{source_fp32}",
                     earlier_ms=per_step(f"{kernel}_earlier_ms"), max_abs_err_edges=edge_err)
    return entry


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
              kernels=sorted(p.stem for p in build.CSRC.glob("*.cu")),
              # what ptxas -v said of the tensor-core kernels (no profiler of
              # kernel internals runs everywhere)
              resources={name: build.resource_usage(name)
                         for name in ("fused_attention_fwd_mma", "fused_attention_bwd_mma",
                                      "flash_attention_bwd_mma")}))
    rows, edge_err = kernel_phase(device)
    bwd_rows, bwd_edge_err = kernel_bwd_phase(device)
    model_phase(device)
    train_phase(device)
    eval_launches = cli_phase()
    launches = cli_train_phase()
    if not launches["fwd"] or not launches["bwd"]:
        raise AssertionError(f"the main path launched no kernel: {launches}")
    flash_rows = flash_kernel_phase(device)
    flash_edge_err = flash_edge_phase(device)
    pretrain_phase(device)
    long_phase(device)
    flash_launches = cli_pretrain_phase()
    if not all(flash_launches.values()):
        raise AssertionError(f"the pre-train path launched no flash kernel: {flash_launches}")
    resize_rows = image_kernel_phase(device)
    tool_launches = image_tool_phase(device)
    for name in FAMILIES:
        family_phase(device, name)
    image_launches = cli_image_phase()
    if not all(tool_launches.values()) or not all(image_launches.values()):
        raise AssertionError("the image path launched no kernel somewhere: tool "
                             f"{tool_launches}, fine-tune {image_launches}")

    def per_call_set(rows, key, n):
        return sum(r[key] * r[n] for r in rows)

    t_bytes = per_call_set(rows, "bytes_ms", "launches_per_forward")
    t_ops = per_call_set(rows, "operations_ms", "launches_per_forward")
    b_bytes = per_call_set(bwd_rows, "bytes_ms", "launches_per_step")
    b_ops = per_call_set(bwd_rows, "operations_ms", "launches_per_step")
    emit({"kernels": [dict(
        name="fused_attention_fwd", route="cuda",
        source="mkg_analogy_tpu_torch/csrc/fused_attention_fwd_mma.cu",  # bf16, every main path
        source_fp32="mkg_analogy_tpu_torch/csrc/fused_attention_fwd.cu",
        replaces="mkg_analogy_tpu/kernels/attention.py:124",
        ok=True, launches=launches["fwd"], launches_eval_path=eval_launches,
        launches_image_path=image_launches["single_fwd"],
        launches_image_tool=tool_launches["attention_fwd"],
        max_abs_err=max(r[f"max_abs_err_bf16{d}"] for r in rows for d in ("", "_dropout")),
        max_abs_err_edges=edge_err,
        max_abs_err_fp32=max(r["max_abs_err_fp32"] for r in rows if "fp32" not in r),
        # per full-width forward at B=128: 12 text + 8 vision + 4 vision-text calls
        ms=per_call_set(rows, "kernel_ms", "launches_per_forward"),
        # the CUDA-core kernel in bf16, which these calls ran before
        earlier_ms=per_call_set(rows, "earlier_ms", "launches_per_forward"),
        plain_ms=per_call_set(rows, "plain_ms", "launches_per_forward"),
        bound_ms=max(t_bytes, t_ops), bound_by=bound_by(t_bytes, t_ops),
        library_ms=None,  # no single PyTorch call applies the analogy multiplier
        shapes=rows,
    ), dict(
        name="fused_attention_bwd", route="cuda",
        source="mkg_analogy_tpu_torch/csrc/fused_attention_bwd_mma.cu",  # bf16, every main path
        source_fp32="mkg_analogy_tpu_torch/csrc/fused_attention_bwd.cu",
        replaces="mkg_analogy_tpu/kernels/attention.py:159",
        ok=True, launches=launches["bwd"],
        launches_image_path=image_launches["single_bwd"],
        max_abs_err=max(r[f"max_abs_err_{t}_bf16{d}"] for r in bwd_rows
                        for t in ("dq", "dk", "dv") for d in ("", "_dropout")),
        max_abs_err_edges=bwd_edge_err,
        max_abs_err_fp32=max(r[f"max_abs_err_{t}_fp32{d}"] for r in bwd_rows
                             if "fp32" not in r
                             for t in ("dq", "dk", "dv") for d in ("", "_dropout")),
        # per full-width train step at B=32: 12 text + 8 vision + 4 vision-text calls
        ms=per_call_set(bwd_rows, "kernel_ms", "launches_per_step"),
        earlier_ms=per_call_set(bwd_rows, "earlier_ms", "launches_per_step"),
        plain_ms=per_call_set(bwd_rows, "plain_ms", "launches_per_step"),
        bound_ms=max(b_bytes, b_ops), bound_by=bound_by(b_bytes, b_ops),
        library_ms=None,  # per shape below: SDPA's backward at the vision shapes
        shapes=bwd_rows,
    )] + [dict(flash_entry(flash_rows, kernel, flash_launches[mma], flash_edge_err),
               launches_image_path=image_launches[f"flash_{mma}"])
          # the bf16 main paths' launches: the backward pair's on the tensor cores
          for kernel, mma in (("fwd", "fwd"), ("dkv", "dkv_mma"), ("dq", "dq_mma"))] + [dict(
        name="resize_normalize", route="cuda",
        source="mkg_analogy_tpu_torch/csrc/resize_normalize.cu",
        replaces="mkg_analogy_tpu/kernels/image_prep.py:84",
        ok=True, launches=image_launches["resize"],
        launches_image_tool=tool_launches["resize"],
        max_abs_err=max(r["max_abs_err"] for r in resize_rows),
        # one call at B=64, every image the full 512 x 512 canvas, to 224 px:
        # the shape at which one F.interpolate call computes the same
        **{k: resize_rows[0][k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms")},
        ms=resize_rows[0]["kernel_ms"], shapes=resize_rows,
    )]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
