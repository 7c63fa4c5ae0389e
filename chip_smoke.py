#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the quickest proof that
the port builds, is right and runs its main path on the GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, prints its traceback and
exits non-zero:

1. card       — name and power limit (nvidia-smi);
2. build      — nvcc builds every kernel under mkg_analogy_tpu_torch/csrc,
                and the eight attention sources at each padded width of
                phase 23's head widths (one process per library, all
                started together, before any timed phase); what
                ``ptxas -v`` said of the tensor-core attention kernels, the
                single-block pair and the flash forward and backward
                (registers a thread, spill bytes, static shared memory);
3. kernel     — the fused-attention forward kernels against their plain
                PyTorch version at the three MKGformer shapes and at ViLT's
                (418 x 418: 128 text and 290 image tokens, the multiplier
                over the text block from row 1, and with the boundary
                shifted by 290), B=128: fp32 (the tiled CUDA-core kernel,
                one sweep over the keys, TF32 off) at atol 2e-5, bf16 (the
                tensor-core kernel) at 2e-2, each also with dropout (same
                seed, so the masks must agree); then the tensor-core kernel
                at the ragged edges (EDGE_CASES: lengths of 1, 15, 17, 99,
                227 and 418, a row whose keys are all masked, the boundary
                on the geometry's edges, B=1); times of the kernel, of the
                plain version (which it must beat at 418 keys) and of
                scaled_dot_product_attention (a yardstick only, at the two
                vision shapes; no single PyTorch call applies the analogy
                multiplier of the text shape), and the bound; the same for
                the fp32 route at every shape (``kernel_ms_fp32``,
                ``plain_ms_fp32``, ``bound_ms_fp32`` at the fp32 peak,
                ``library_ms_fp32``: SDPA on the fp32 inputs, with the
                backend that ran);
4. kernel_bwd — the backward kernels against their plain version at the same
                shapes and B=32 (the training batch) and at the same edge
                cases: dq, dk, dv and dw in fp32 (CUDA cores) and bf16
                (tensor cores), with and without dropout; the times as in
                phase 3 (the fp32 backward from the forward's out and lse,
                as the main path calls it), and the backward of
                scaled_dot_product_attention at the vision shapes;
    gelu_kernel — row 7, gelu_poly's forward and backward kernels, against
                the plain chain at the FFN activations of MKGformer (B=32,
                L=128) and of FLAVA's three towers (B=24: 128, 393 and 522
                tokens), 3072 wide, bf16 and fp32: every element bit for
                bit; the times of each kernel, of the plain chain and of
                F.gelu in bf16, and the bounds; then a full-width MKGformer
                bf16 fine-tune step through the kernels and through the
                plain chain: 13 + 13 launches, the loss and every gradient
                leaf that two kernel runs give alike bit for bit. Every bf16
                main path below counts row 7's launches beside its attention
                launches, and its plain runs take the plain chain;
    adamw     — row 8, the AdamW kernel, at the parameter sets of the
                benchmark's Kimi-VL (1.61 B), FLAVA and MKGformer
                configurations (built on the meta device as the harness
                builds them), both groups, null gradients for Kimi-VL's
                selection biases and one leaf of each: 3 steps against the
                plain version (PyTorch's foreach update), every parameter
                and moment bit for bit, one launch a step, then a step of
                torch.optim.AdamW(foreach=True) from the plain version's
                state against one more of the kernel; the kernel's, the
                plain version's and torch's step by CUDA events beside the
                bound, 28 bytes a parameter over the HBM rate. The CLI
                fine-tune (cli_train) and the Kimi-VL step (kimi_vl) count
                its launches, one a step;
5. model      — a full-width UnimoForMaskedLM (random weights from a seed,
                B=32, L=128, two 224-px images) forward through the kernel
                and through the plain version (gelu_poly through its plain
                chain too): fp32 logits within 1e-3, bf16 difference and
                top-1 agreement reported, 24 launches a forward and in bf16
                13 of row 7's;
6. train      — the full-width fine-tune step (label-smoothed CE +
                alpha * relaxation, AdamW), dropout on: fp32 through the
                kernels against fp32 through the plain attention from the
                same weights, batch and seeds (loss within 1e-5 relative,
                every gradient leaf within its bound); then bf16 through the
                kernels, the main path, for 8 steps on one batch: the loss
                falls, 24 forward and 24 backward launches a step (and 13
                + 13 of row 7), step time and a device profile of one step;
                then 4 bf16 steps with
                ``UnimoConfig.remat`` off and on (each layer recomputed in
                the backward): the first step's loss bit-equal, step ms and
                peak GB of each;
7. cli        — ``mkg_analogy_tpu_torch.cli.main --only_test`` at full width
                on a small MARS/MarKG-format dataset written here, in bf16
                through the kernel: finite metrics, 24 launches per eval
                batch; then in fp32 through the kernel and through the plain
                attention (``--fused_attention 0``): identical ranks; every
                run builds the kernels before its first batch;
8. cli_train  — the main path of the fine-tune slice: the CLI fine-tune
                (``--max_epochs 1 --batch_size 32``, bf16, through the
                kernels) with dev and test evaluation and the best-dev
                checkpoint, launches counted from 0, from an empty build
                directory: the CLI compiles every kernel before its first
                batch, and its first step's ms is printed; then
                ``--only_test --checkpoint`` on that checkpoint reproduces
                the fit's test ranks exactly;
    fit_prefetch — ``MarTTrainer.fit`` and ``evaluate`` through
                ``_prefetch`` (pinned memory, a side stream) against the
                loop before it, at full width (bf16, B=32, L=128, 12 steps,
                MARS's 1,020 dev examples at B=128): host and device ms a
                step, idle share, eval examples/s, peak GB of each; equal
                losses and dev ranks; no worker left after ``fit``;
    qk_bf16_grad — the plain attention's bf16 dq/dk backward
                (``qk_bf16_grad``) on the full-width fine-tune step: the
                loss bit-equal, each gradient leaf within the bf16 run's
                own distance from fp32; then the CLI fit with
                ``--qk_bf16_grad 1 --fused_attention 0``;
    fused_qkv — the fused Q/K/V projection on weights from
                ``convert.fuse_qkv``: fp32 forward and step against the
                unfused model, then 6 bf16 steps of each;
    mesh_1x1 — the fine-tune through the mesh code (core/mesh.make_mesh)
                on a world-size-1 NCCL group, full width, B=32, L=128, bf16,
                dropout on, 6 steps and 64 dev examples, in turns with the
                same steps on no mesh: losses and dev ranks bit-equal, the
                step times of each;
    gloo_meshes — dp2, tp2 and dp2tp2: 2, 2 and 4 gloo processes on the
                one card over the same model and global batch in fp32, 3
                steps each, held on every rank against a single process
                that sums as the mesh's tp does: the losses within 1e-5
                relative, every gradient leaf within the train phase's
                gradient bar, the dev ranks equal but for near ties, rows
                1-2's launches counted on each rank; step times printed,
                which are no scaling figure (ranks share one card);
9. flash_kernel — the three flash kernels (forward, dK/dV, dQ; on the
                tensor cores in bf16, on the CUDA cores in fp32; out and
                lse of the forward) against their plain versions at the triple
                pre-train shapes (B=64: text 96x96, vision 99x99,
                vision-text 99x195), the analogy ones (128x128 with the
                geometry, 99x227), two Q tiles (512x512, B=8), two K tiles
                with a ragged second (99x611, B=8), L=2048 (B=8, 8 x 4
                tiles), FLAVA's three towers (B=24: 393x393, 128x128 with the
                multiplier from row 1, 522x522) and ViLT's fp32 route (B=32,
                418x418), fp32 and bf16, dropout 0 and 0.1; the times of each
                kernel in bf16 and in fp32, the plain versions and SDPA in
                bf16 and SDPA's fp32 forward (where no analogy multiplier
                applies), and the bounds; then the tensor-core kernels at
                the flash edge cases (FLASH_EDGE_CASES: Lq and Lk of 1, 255,
                257, 511, 513 and 611, a row whose keys are all masked,
                row_start 1, the +290 offset, 64-row blocks and 64-key
                chunks against logical tiles of 96 x 160), bf16, dropout 0
                and 0.1, lse included; then the four fp32 CUDA-core kernels
                (single-block and flash) at the edge cases with an
                all-masked row, at the fp32 bars (``fp32_masked_rows``);
    kimi_vl   — rows 3-5 causal, values 128 wide under heads of 192, at
                latent attention's call in the Kimi-VL cell (B=32, 16
                heads, 228 x 228, the key mask and the analogy multiplier
                after 100 image tokens), dropout 0 and 0.1, against the
                plain versions at the flash bars; the kernels' times, the
                plain versions' and the causal bounds
                (port_bench/bounds_mla.py); then a full-width KimiVLKGC bf16
                fine-tune step (B=32, AdamW), the counts set to 0 before
                it: 26 + 26 + 26 flash launches on the tensor cores (14 at
                head width 192, 12 at 64 in the CLIP tower), 1 + 1 of row
                7, 13 expert-layer forwards and 78 grouped products, and
                the rows routed to the held experts; then 7 more steps: the
                loss falls, step ms, peak GB and a device profile;
10. pretrain  — the full-width triple pre-train step (B=64, L=96) through
                the flash kernels: fp32 against the plain attention (loss
                within 1e-5 relative, every gradient leaf within its bound),
                then 8 bf16 steps on one batch: the loss falls, 24 + 24 + 24
                launches a step (all on the tensor cores),
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
                393, 128 and 522 tokens), L=128: fp32 through the
                family's default kernels (ViLT the single-block ones over
                its 418 keys; FLAVA the flash ones)
                against the plain attention or the flash kernels' plain
                version (loss within 1e-5 relative, every gradient leaf
                within its bound), and through the flash kernels against the
                plain attention without attention dropout, then a bf16 forward and 6 bf16 steps through the
                family's default kernels (ViLT the single-block ones, 12 + 12
                launches a step; FLAVA the flash ones, 30 + 30 + 30; and 13
                + 13 and 31 + 31 of row 7): the
                loss falls, step time and a device profile; ViLT's step also
                through the flash kernels, for comparison; and what each
                family's fp32 step costs through its default kernels (ViLT
                the single-block ones, FLAVA the flash ones; fp32_step_cost:
                step ms, device ms, the attention kernels' share of it);
16. cli_image — the main path of the image slice: the tool writes a pixel
                store for a dataset written here, ``cli.main --model_class
                ViltKGC|FlavaKGC --image_features <store>`` fine-tunes one
                epoch in bf16 and tests, ``--only_test --checkpoint``
                reproduces the ranks; then ViLT in fp32 through its default
                single-block kernels (one step, dev and test); the counts set
                to 0 before each run and read after it;
17. region_kernel — rows 1-2 at the region families' shapes (REGION_SHAPES):
                the four head_dim-128 instantiations (fp32 CUDA-core, bf16
                tensor-core, forward and backward) at ViLBERT's visual
                stream (B=64, 72 x 72, 8 heads of 128, keys half and all
                masked in a quarter of the rows each) and at ragged Lk of
                1, 37 and 130, VisualBERT's 200 x 200 and ViLBERT's text
                stream at head_dim 64; fp32 and bf16, dropout 0 and 0.1, at
                the bars of rows 1-2 (the fp32 all-masked rows at head_dim
                128 among them, ``fp32_masked_rows``); times, plain and SDPA
                times, bounds, registers and spills;
    flash_d128_kernel — rows 3-5 at head_dim 128: the six instances (the
                three flash kernels, fp32 on the CUDA cores and bf16 on the
                tensor cores) against their plain versions at
                FLASH_D128_SHAPES (ViLBERT's visual stream, B=64, 72 x 72,
                with and without the analogy geometry; two Q tiles, 512 x
                512, B=8; a ragged second K tile, 99 x 611, B=8; L=2048,
                B=8), fp32 and bf16, dropout 0 and 0.1, at the flash bars;
                each instance's time, the plain and SDPA times, the bounds
                of each dtype, registers and spills;
18. visualbert, vilbert — a full-width fine-tune step of each region family
                at its recipe (B=64, L=128, 72 regions of 2048): fp32
                through the single-block kernels against the plain
                attention (loss within 1e-5 relative, every gradient leaf
                within its bound; ViLBERT also through the flash kernels,
                at the same bars), then a bf16 forward and 6 bf16 steps
                (12 + 12 launches a step for VisualBERT, 18 + 18 for
                ViLBERT, 6 + 6 of them at head_dim 128; 13 + 13 and 31 + 29
                of row 7): the loss falls,
                step time and a device profile; ViLBERT then 4 more steps
                through the flash kernels (18 + 17 + 17 launches, 6 + 5 + 5
                at head_dim 128, on the tensor cores): the loss falls, step
                time, peak memory and a device profile;
19. cli_region — the main path of the region slice: ``cli.main
                --model_class VisualBertKGC|VilBertKGC --image_features
                synthetic`` fine-tunes one epoch in bf16 at B=64 and tests,
                ``--only_test --checkpoint`` reproduces the ranks; then
                ViLBERT so with ``--fused_attention flash`` (the head_dim-128
                tensor-core flash kernels must be launched); the counts set
                to 0 before each run and read after it;
20. kge_ikrl  — the IKRL silo in fp32 on a synthetic MarKG at the real
                counts (11,292 entities, 192 relations, 33,307 triples; a
                (E+1, 4096) VGG store): IKRL TransE (d=400), IKRL ANALOGY
                (d=200) and TransAE (d=200) pre-train steps at the recipe's
                333 x 51 rows, each on the card against the port on the CPU
                (loss within 1e-5 relative, every gradient leaf within 1e-5
                of its largest value), then timed; link prediction on 128
                triples, both sides, B=64 (energies within 1e-5, ranks equal
                but for near ties); a fine-tune step at B=128; peak GB;
21. kge_rsme  — RSME ComplEx at rank 1000, B=1000, Adagrad over the
                reciprocal triples: a step against the CPU (same bars),
                timed steps and one epoch; eval_both_sides on the 1% test
                split against the CPU; the Analogy fine-tune forward and
                ranking at B=500; peak GB;
22. cli_kge   — ``cli.ikrl`` and ``cli.rsme`` end to end on the card
                (pre-train, ``--finetune``, each reproduced exactly by
                ``--eval_only --ckpt``; IKRL once more with
                ``--use_native_sampler``). No TPU kernel lies on the KGE
                path, so these phases count no launches. Every KGE metrics
                line carries ``nonfinite_gold``, the rows whose gold score
                is not finite (ranked last); the ANALOGY recipe, which
                diverges, must report Hits@1 of at most 0.5.
23. head_widths — rows 1-5 at head widths 8, 13, 16, 20, 24, 32, 56,
                116, 120, 136, 192, 200, 250 and 256 (HEAD_WIDTHS), each
                through the library of its padded width (16, 32, 64, 128,
                192, 256: the 48 libraries built in phase 2 with the nine;
                40, 80, 96 and 112, whose libraries no main path needs, run
                in the `cuda` tests), fp32 and bf16,
                without and with the analogy geometry and
                dropout, against the plain versions at the kernel phases'
                bars, each launch counted under its width; the times of each
                instance, its plain version, SDPA (widths that are multiples
                of 8) and its bounds; registers and spills; head_dim 257
                raises;
24. cli_widths — the slice's main paths at those widths: (a) the verify
                recipe's model (head_dim 16) through the CLI, a fine-tune
                and ``--only_test --checkpoint``, under ``--fused_attention
                1`` and ``flash`` in fp32 and bf16, the fp32 losses against
                ``--fused_attention 0``'s; (b) MiniLM-L12-H384's widths (head_dim
                32), a full-length step through ``single`` and ``flash``,
                fp32 against the plain attention, then bf16 steps;
25. long_keys — rows 1-2 at 99 x 1100 and 1024 x 1024 (B=2), fp32 (the
                tiled CUDA-core kernels) and bf16, dropout 0 and
                0.1, against the plain versions at the kernel bars; times,
                plain and SDPA times, bounds (ViLT's 418 x 418 in fp32 runs
                in phases 3 and 4);
26. cli_wide  — the slice's path at full width: the CLI fine-tune of
                MKGformerKGC at width 768 with ``--num_heads 3`` (heads of
                256), bf16 through ``--fused_attention 1`` and ``flash``,
                fp32 ``1`` against ``0`` (one step, loss within 1e-5
                relative), every kernel of the route launched at head_dim
                256, the calls it sent the kernels held against the plain
                versions.

Then the ``{"kernels": [...]}`` line, the card line, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``mkg_analogy_tpu_torch`` beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
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
# Row 7, gelu_poly's kernels: the FFN activations of the benchmark's bf16
# cells, MKGformer's 12 text layers (B=32, L=128) and FLAVA's text, image and
# multimodal towers (B=24); fp32 operations an element forward and backward
# (csrc/gelu_poly.cu: no fused multiply-add, the clamps' min and max
# counted), at one a lane a cycle, half the fp32 FMA peak.
GELU_SHAPES = [("mkgformer_text", (32, 128, 3072)), ("flava_text", (24, 128, 3072)),
               ("flava_image", (24, 393, 3072)), ("flava_multimodal", (24, 522, 3072))]
GELU_OPS_FWD, GELU_OPS_BWD = 57, 56
# gelu_poly calls of a MKGformer forward in bf16: the 12 text layers' FFNs and
# the MLM transform (the vision tower takes quick_gelu; fp32 takes F.gelu)
GELU_CALLS = 13
# Row 8, the AdamW kernel: the benchmark's fine-tune configurations whose
# parameter sets it updates (port_bench/configs/<name>.json), and the bytes
# a parameter moves (p, g, m and v read, p, m and v written, fp32)
ADAMW_CONFIGS = ("kimi_vl_a3b", "flava", "mkgformer")
ADAMW_BYTES = 28


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (seconds since
    the script started: the phases' share of the time budget)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - START, 1))
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, samples=5, per_sample=10):
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


# substrings of the attention kernels' names (single-block and flash, either
# route), whose device time device_profile sums
ATTENTION_KERNELS = ("attention", "fwd_kernel", "fwd_resident_kernel", "fwd_streaming_kernel",
                     "dkv_kernel", "dq_kernel", "dq_resident_kernel", "dq_streaming_kernel")


def device_profile(fn, top=12):
    """Device time of one call of ``fn`` by kernel name (torch.profiler):
    the total, the attention kernels' (ATTENTION_KERNELS) and the ``top``
    names with their ms and call counts."""
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
                attention_ms=sum(r[1] for r in rows if any(a in r[0] for a in ATTENTION_KERNELS)),
                top=[dict(name=n[:90], ms=ms, calls=c) for n, ms, c in rows[:top]])


def bound_times(b, lq, lk, dtype_bytes, heads=HEADS, head_dim=HEAD_DIM):
    """(ms for the bytes, ms for the operations) of one call: each input
    read once (q, k, v, the fp32 mask, the int32 boundary) and the output
    written once, over the HBM rate; the QK^T and PV products over the bf16
    tensor-core peak. The bound is the larger of the two."""
    hd = heads * head_dim
    nbytes = (b * lq * hd + 2 * b * lk * hd + b * lq * hd) * dtype_bytes + b * lk * 4 + b * 4
    flops = 4 * b * heads * lq * lk * head_dim
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def bound_by(t_bytes, t_ops):
    return "bytes" if t_bytes >= t_ops else "operations"


def bwd_bound_times(b, lq, lk, dtype_bytes, heads=HEADS, head_dim=HEAD_DIM):
    """(ms for the bytes, ms for the operations) of one backward: q, k, v
    and g read once, dq, dk and dv written once, plus the fp32 mask and the
    int32 boundary, over the HBM rate; 10·B·heads·Lq·Lk·d flops (QKᵀ
    recomputed, dv, dp, dq, dk) over the bf16 tensor-core peak."""
    hd = heads * head_dim
    nbytes = (3 * b * lq * hd + 4 * b * lk * hd) * dtype_bytes + b * lk * 4 + b * 4
    flops = 10 * b * heads * lq * lk * head_dim
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def seeded_randn(shape, seed, device, dtype, gen=None):
    """Standard normal values drawn on ``device`` from ``seed`` (or from the
    device generator ``gen``), in ``dtype``: drawn on the host, the inputs
    of the wide heads' calls took seconds a call."""
    import torch

    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def attention_inputs(lq, lk, geometry, dtype, device, seed, batch=BATCH, head_dim=HEAD_DIM):
    import torch

    g = torch.Generator().manual_seed(seed)
    gd = torch.Generator(device=device).manual_seed(seed)
    hd = HEADS * head_dim
    q, k, v = (seeded_randn((batch, n, hd), seed, device, dtype, gd) for n in (lq, lk, lk))
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


def edge_inputs(case, device, dtype=None):
    """(q, k, v, g, mask, geometry keywords) of an edge case, bf16 (or
    ``dtype``), from a seed: the last eighth of the keys padded, one batch
    row fully masked."""
    import torch

    name, b, lq, lk, geometry, masked_row = case
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    hd = HEADS * HEAD_DIM
    q, k, v, g = (torch.randn(b, n, hd, generator=gen).to(device, dtype or torch.bfloat16)
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


def main_path_bwd(attn, q, k, v, mask, g, heads, resolved):
    """A backward call as the main path makes it: on the fp32 route from the
    forward's out and lse (computed here, once), which _FusedAttention saves;
    bf16 from the inputs alone."""
    import torch

    residuals = ()
    if q.dtype == torch.float32:
        residuals = (None, *attn._launch_fwd_cuda_cores(q, k, v, mask, heads, *resolved))
    return lambda: attn._launch_bwd(q, k, v, mask, g, heads, *resolved, *residuals)


def sdpa_backend(fn):
    """The name of the device kernel that takes most of one call of ``fn``
    (which of scaled_dot_product_attention's backends ran)."""
    return device_profile(fn, top=1)["top"][0]["name"]


def sdpa_heads(q, k, v, mask, heads, head_dim, grad=False):
    """(qh, kh, vh, bias) of SDPA on the same heads: the padding mask as a
    bias in the inputs' dtype, None where no key is masked."""
    b = q.shape[0]

    def split(x):
        x = x.view(b, x.shape[1], heads, head_dim).transpose(1, 2)
        return x.detach().requires_grad_(True) if grad else x

    bias = None
    if not bool(mask.all()):
        bias = ((1.0 - mask) * -10000.0).to(q.dtype)[:, None, None, :]
    return split(q), split(k), split(v), bias


def fp32_forward_times(attn, lq, lk, geometry, device, batch, heads=HEADS,
                       head_dim=HEAD_DIM):
    """The fp32 route of a forward shape: the tiled CUDA-core kernel's ms,
    its plain version's, the bound (operations at the fp32 peak, bytes of
    fp32 inputs), and where no multiplier applies SDPA on the same fp32
    inputs, with the backend that ran."""
    import torch
    import torch.nn.functional as F

    q, k, v, mask, kw = attention_inputs(lq, lk, geometry, torch.float32, device, seed=7,
                                         batch=batch, head_dim=head_dim)
    kw = dict(kw, compute_dtype=torch.float32)
    few = dict(samples=5, per_sample=2)
    out = dict(
        kernel_ms_fp32=time_ms(lambda: attn.fused_attention(q, k, v, mask, heads, **kw), **few),
        plain_ms_fp32=time_ms(lambda: attn.fused_attention_reference(q, k, v, mask, heads,
                                                                     **kw), **few))
    t_bytes, t_ops = bound_times(batch, lq, lk, 4, heads, head_dim)
    t_ops *= BF16_FLOPS_PER_S / FP32_FLOPS_PER_S
    out.update(bound_ms_fp32=max(t_bytes, t_ops), bound_by_fp32=bound_by(t_bytes, t_ops),
               library_ms_fp32=None, library_backend_fp32=None)
    if geometry is None:
        qh, kh, vh, bias = sdpa_heads(q, k, v, mask, heads, head_dim)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

        out.update(library_ms_fp32=time_ms(sdpa, **few), library_backend_fp32=sdpa_backend(sdpa))
    return out


def fp32_backward_times(attn, lq, lk, geometry, rate, device, batch, heads=HEADS,
                        head_dim=HEAD_DIM):
    """The fp32 route of a backward shape (dropout ``rate``): the two tiled
    passes from the forward's out and lse, as the main path calls them; the
    plain backward; the bound; SDPA's backward on the same fp32 inputs
    (without dropout) where no multiplier applies, and its backend."""
    import torch
    import torch.nn.functional as F

    q, k, v, mask, kw = attention_inputs(lq, lk, geometry, torch.float32, device, seed=7,
                                         batch=batch, head_dim=head_dim)
    g = seeded_randn(q.shape, 8, device, torch.float32)
    kw = dict(kw, compute_dtype=torch.float32, dropout_rate=rate, deterministic=rate == 0.0,
              dropout_seed=99)
    few = dict(samples=5, per_sample=2)
    out = dict(kernel_ms_fp32=time_ms(main_path_bwd(
        attn, q, k, v, mask, g, heads, resolve_geometry(attn, q, kw, rate, 99)), **few),
        plain_ms_fp32=time_ms(lambda: attn.fused_attention_bwd_reference(
            q, k, v, mask, g, heads, **kw), **few))
    t_bytes, t_ops = bwd_bound_times(batch, lq, lk, 4, heads, head_dim)
    t_ops *= BF16_FLOPS_PER_S / FP32_FLOPS_PER_S
    out.update(bound_ms_fp32=max(t_bytes, t_ops), bound_by_fp32=bound_by(t_bytes, t_ops),
               library_ms_fp32=None, library_backend_fp32=None)
    if geometry is None:
        qh, kh, vh, bias = sdpa_heads(q, k, v, mask, heads, head_dim, grad=True)
        gh = g.view(batch, lq, heads, head_dim).transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qh, kh, vh), gh)

        fwd_ms = time_ms(sdpa, **few)
        out.update(library_ms_fp32=time_ms(sdpa_fwd_bwd, **few) - fwd_ms,
                   library_backend_fp32=sdpa_backend(sdpa_fwd_bwd))
    return out


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
        # timing in the main path's dtype: the tensor-core kernel, the plain
        # version
        q, k, v, mask, kw = attention_inputs(lq, lk, geometry, torch.bfloat16, device, seed=7)
        kw = dict(kw, compute_dtype=torch.bfloat16)
        row["kernel_ms"] = time_ms(lambda: attn.fused_attention(q, k, v, mask, HEADS, **kw))
        row["plain_ms"] = time_ms(
            lambda: attn.fused_attention_reference(q, k, v, mask, HEADS, **kw))
        if name.startswith("vilt") and not row["kernel_ms"] < row["plain_ms"]:
            raise AssertionError(f"{name}: the forward kernel ({row['kernel_ms']} ms) is no "
                                 f"faster than its plain version ({row['plain_ms']} ms)")
        # the fp32 route: the tiled CUDA-core kernel, its plain version, SDPA
        # on the same fp32 inputs where no multiplier applies
        row.update(fp32_forward_times(attn, lq, lk, geometry, device, BATCH))
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


def bwd_errors(attn, what, key, q, k, v, mask, g, kw, rate, seed, bar, heads=HEADS):
    """One backward launch against fused_attention_bwd_reference: the
    errors of dq, dk, dv (each within ``bar`` of its largest |value|) and of
    dw0/dw1 (within 1e-5 of the sum of |ds * s_raw| over their region), as
    ``{name_key: value}``; raises beyond a bar."""
    import torch

    out = {}
    bnd, w, geo, r, seed = resolve_geometry(attn, q, kw, rate, seed)
    before = attn.LAUNCHES_BWD
    got = attn._launch_bwd(q, k, v, mask, g, heads, bnd, w, geo, r, seed)
    if attn.LAUNCHES_BWD != before + 1:
        raise AssertionError(f"bwd {what}: the wrapper counted no launch")
    want = attn.fused_attention_bwd_reference(q, k, v, mask, g, heads, **kw)
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
            s_raw, planes, p = attn._scores(qf, kf, mask, heads, bnd, w, geo)
            gh = attn._split_heads(g, heads, torch.float32)
            dp = gh @ attn._split_heads(v, heads, torch.float32).transpose(-1, -2)
            if r > 0.0:
                keep = attn.dropout_keep(q.shape[0], heads, q.shape[1], k.shape[1], r, seed,
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
        for tag, dtype in dtypes:
            for rate in (0.0, 0.1):
                q, k, v, mask, kw = attention_inputs(lq, lk, geometry, dtype, device,
                                                     seed=lq + lk, batch=TRAIN_BATCH)
                g = seeded_randn(q.shape, lq, device, dtype)
                kw = dict(kw, compute_dtype=dtype, dropout_rate=rate,
                          deterministic=rate == 0.0, dropout_seed=4321)
                key = f"{tag}{'_dropout' if rate else ''}"
                row.update(bwd_errors(attn, f"{name} {key}", key, q, k, v, mask, g, kw, rate,
                                      4321, 2e-5 if dtype == torch.float32 else 2.0 ** -7))
        # timing in the main path's dtype, dropout as the text tower trains
        q, k, v, mask, kw = attention_inputs(lq, lk, geometry, torch.bfloat16, device,
                                             seed=7, batch=TRAIN_BATCH)
        g = seeded_randn(q.shape, 8, device, torch.bfloat16)
        rate = 0.1 if geometry is not None else 0.0
        kw = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=rate,
                  deterministic=rate == 0.0, dropout_seed=99)
        bnd, w, geo, r, seed = resolve_geometry(attn, q, kw, rate, 99)
        row["kernel_ms"] = time_ms(
            lambda: attn._launch_bwd(q, k, v, mask, g, HEADS, bnd, w, geo, r, seed))
        row["plain_ms"] = time_ms(
            lambda: attn.fused_attention_bwd_reference(q, k, v, mask, g, HEADS, **kw))
        row.update(fp32_backward_times(attn, lq, lk, geometry, rate, device, TRAIN_BATCH))
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


@contextlib.contextmanager
def plain_gelu():
    """Within: gelu_poly on the card computes its plain version (the eager
    chain, ~59 PyTorch kernels each way) instead of launching row 7's
    kernels, for the runs that hold a kernel route against the plain one."""
    from mkg_analogy_tpu_torch.kernels import gelu_poly as gp

    saved = gp._launch_fwd, gp._launch_bwd
    gp._launch_fwd, gp._launch_bwd = gp.gelu_poly_reference, gp.gelu_poly_grad_reference
    try:
        yield
    finally:
        gp._launch_fwd, gp._launch_bwd = saved


def differing_bits(got, want):
    """The elements of ``got`` whose bits differ from ``want``'s, NaN for
    NaN (a NaN's payload aside); all of them if the dtypes, shapes or NaNs
    differ."""
    import torch

    nan = torch.isnan(got)
    if got.dtype != want.dtype or got.shape != want.shape \
            or not torch.equal(nan, torch.isnan(want)):
        return got.numel()
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
    return int((got.view(bits)[~nan] != want.view(bits)[~nan]).sum())


def gelu_kernel_phase(device):
    """Row 7: gelu_poly's two kernels (csrc/gelu_poly.cu) against the plain
    chain at GELU_SHAPES, in bf16 (every main path's) and fp32: one launch
    each way a call, every element bit for bit. The times of each kernel,
    of the plain chain each way and of F.gelu and its backward in bf16 (the
    library's fused exact gelu, a yardstick: the port never calls it in
    bf16); the bounds, the larger of the bytes (x, the cotangent and the
    result, each once) over the HBM rate and GELU_OPS_* an element over
    half the fp32 peak. Then a full-width MKGformer bf16 fine-tune step
    (B=32, L=128, dropout on) from one state dict, batch and seeds, twice
    through the kernels and once through the plain chain: GELU_CALLS
    launches each way (none through the plain chain), the loss bit for bit,
    and bit for bit every gradient leaf that the two kernel runs give alike
    (a leaf summed by atomics in another order from run to run is counted
    and its largest difference printed)."""
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.kernels import gelu_poly as gp
    from mkg_analogy_tpu_torch.models.common import DropoutRNG
    from mkg_analogy_tpu_torch.models.unimo import UnimoConfig, UnimoForMaskedLM
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    ops_per_s = FP32_FLOPS_PER_S / 2  # one operation a lane a cycle, nothing fused
    rows = []
    for name, shape in GELU_SHAPES:
        row = dict(shape=name, dims=list(shape))
        gen = torch.Generator(device).manual_seed(sum(shape))
        for tag, dtype in (("", torch.bfloat16), ("_fp32", torch.float32)):
            x = (3 * torch.randn(shape, device=device, generator=gen)).to(dtype)
            g = torch.randn(shape, device=device, generator=gen).to(dtype)
            before = (gp.LAUNCHES_GELU_FWD, gp.LAUNCHES_GELU_BWD)
            y, dx = gp._launch_fwd(x), gp._launch_bwd(x, g)
            torch.cuda.synchronize()
            if (gp.LAUNCHES_GELU_FWD - before[0], gp.LAUNCHES_GELU_BWD - before[1]) != (1, 1):
                raise AssertionError(f"gelu_kernel {name}{tag}: launches "
                                     f"{gp.LAUNCHES_GELU_FWD - before[0]} / "
                                     f"{gp.LAUNCHES_GELU_BWD - before[1]}, expected 1 / 1")
            for way, got, want in (("fwd", y, gp.gelu_poly_reference(x)),
                                   ("bwd", dx, gp.gelu_poly_grad_reference(x, g))):
                differ = differing_bits(got, want)
                if differ:
                    raise AssertionError(f"gelu_kernel {name}{tag} {way}: {differ} of "
                                         f"{got.numel()} elements differ from the plain chain")
            del y, dx, want
            row[f"fwd_ms{tag}"] = time_ms(lambda: gp._launch_fwd(x))
            row[f"bwd_ms{tag}"] = time_ms(lambda: gp._launch_bwd(x, g))
            for way, tensors, ops in (("fwd", 2, GELU_OPS_FWD), ("bwd", 3, GELU_OPS_BWD)):
                t_bytes = x.numel() * x.element_size() * tensors / HBM_BYTES_PER_S * 1e3
                t_ops = x.numel() * ops / ops_per_s * 1e3
                row[f"{way}_bound_ms{tag}"] = max(t_bytes, t_ops)
                row[f"{way}_bound_by{tag}"] = bound_by(t_bytes, t_ops)
                row[f"{way}_over_bound{tag}"] = row[f"{way}_ms{tag}"] / max(t_bytes, t_ops)
            if dtype == torch.bfloat16:
                row.update(
                    plain_fwd_ms=time_ms(lambda: gp.gelu_poly_reference(x)),
                    plain_bwd_ms=time_ms(lambda: gp.gelu_poly_grad_reference(x, g)),
                    library_fwd_ms=time_ms(lambda: F.gelu(x)),
                    library_bwd_ms=time_ms(lambda: torch.ops.aten.gelu_backward(g, x)))
            del x, g
        rows.append(row)
        torch.cuda.empty_cache()

    batch = train_batch(device)
    with torch.device(device):
        model = UnimoForMaskedLM(UnimoConfig(dtype="bfloat16"))
    model.init_params(torch.Generator(device=device).manual_seed(0))
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(), device=device)
    runs = {}
    for run in ("kernels", "plain", "kernels_again"):
        model.zero_grad(set_to_none=True)
        reset_counts()
        with plain_gelu() if run == "plain" else contextlib.nullcontext():
            loss, _ = trainer._finetune_loss(batch, DropoutRNG.from_seed(5, device))
            loss.backward()
        torch.cuda.synchronize()
        n = 0 if run == "plain" else GELU_CALLS
        if (gp.LAUNCHES_GELU_FWD, gp.LAUNCHES_GELU_BWD) != (n, n):
            raise AssertionError(f"gelu_kernel step {run}: launches {gp.LAUNCHES_GELU_FWD} / "
                                 f"{gp.LAUNCHES_GELU_BWD}, expected {n} / {n}")
        runs[run] = (loss.detach().clone(), {k: p.grad.clone() for k, p in
                                             model.named_parameters() if p.grad is not None})
    (loss_k, grads), (loss_p, grads_p), (_, grads_again) = (
        runs["kernels"], runs["plain"], runs["kernels_again"])
    if differing_bits(loss_k, loss_p) or grads.keys() != grads_p.keys():
        raise AssertionError(f"gelu_kernel step: loss {loss_k.item()} through the kernels, "
                             f"{loss_p.item()} through the plain chain")
    unsteady = {k: (grads[k] - grads_again[k]).abs().max().item() for k in grads
                if differing_bits(grads[k], grads_again[k])}
    differ = {k: differing_bits(grads[k], grads_p[k]) for k in grads if k not in unsteady}
    if any(differ.values()):
        raise AssertionError("gelu_kernel step: gradient leaves differ from the plain chain's: "
                             f"{ {k: n for k, n in differ.items() if n} }")
    step = dict(B=TRAIN_BATCH, L=128, loss=loss_k.item(), loss_bit_equal=True,
                launches_per_step=dict(fwd=GELU_CALLS, bwd=GELU_CALLS),
                grad_leaves=len(grads), grad_leaves_bit_equal=len(differ),
                leaves_unsteady_run_to_run=unsteady,
                unsteady_leaves_largest_diff_vs_plain={
                    k: (grads[k] - grads_p[k]).abs().max().item() for k in unsteady})
    del runs, grads, grads_p, grads_again, model, trainer
    torch.cuda.empty_cache()
    emit(dict(phase="gelu_kernel", shapes=rows, main_path_step=step))
    return rows


def meta_model(config_name):
    """The benchmark's model of ``port_bench/configs/<config_name>.json`` on
    the meta device, built as ``port_bench/harness.py`` builds it."""
    import torch

    from mkg_analogy_tpu_torch.models.registry import create_model

    with open(os.path.join("port_bench", "configs", f"{config_name}.json")) as f:
        cfg = json.load(f)
    with torch.device("meta"):
        return create_model(
            cfg["model_class"], vocab_size=cfg["vocab_size"], dtype=cfg["dtype"],
            attention=cfg["attention"], hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
            intermediate_size=cfg["intermediate_size"],
            max_position_embeddings=cfg["max_position_embeddings"])


def adamw_phase(device, steps=3):
    """Row 8: the AdamW kernel (csrc/adamw.cu) at the trainable parameters of
    each of ADAMW_CONFIGS, in make_optimizer's two groups (decay 0.01 and
    none), with null gradients for the router's selection biases (Kimi-VL's
    expert layers: no gradient reaches them) and for the first leaf. From
    parameters and gradients drawn on the card (fresh gradients each step)
    and zero moments, ``steps`` steps of the kernel and of the plain version
    (adamw_reference, PyTorch's foreach update, in its copy of the
    parameters) at the schedule's learning rates past warm-up: every
    parameter and moment bit for bit after each, one launch a step. Then
    torch.optim.AdamW(foreach=True) takes the plain version's parameters and
    moments for one more step, and the kernel one more: bit for bit. Times
    by CUDA events (2 steps a sample, so the host's enqueueing of the
    foreach chain is not timed): the kernel's step, the plain version's and
    torch.optim.AdamW's, beside the bound, ADAMW_BYTES a parameter over the
    HBM rate."""
    import torch

    from mkg_analogy_tpu_torch.kernels import adamw as aw
    from mkg_analogy_tpu_torch.train.optim import linear_warmup_linear_decay, no_decay_mask

    schedule = linear_warmup_linear_decay(5e-5, 100, 0.1)
    rows = []
    for name in ADAMW_CONFIGS:
        meta = meta_model(name)
        decay = no_decay_mask(meta)
        named = [(n, p) for n, p in meta.named_parameters() if p.requires_grad]
        none = {0} | {i for i, (n, _) in enumerate(named) if n.endswith("router.bias")}
        gen = torch.Generator(device).manual_seed(len(named))
        mine = [torch.nn.Parameter(0.02 * torch.randn(p.shape, device=device, generator=gen))
                for _, p in named]
        plain = [p.detach().clone() for p in mine]
        grads = [None if i in none else torch.empty(p.shape, device=device) for i, p in
                 enumerate(mine)]
        del meta

        def groups(leaves, named=named, decay=decay):
            return [{"params": [p for (n, _), p in zip(named, leaves) if decay[n]],
                     "weight_decay": 0.01},
                    {"params": [p for (n, _), p in zip(named, leaves) if not decay[n]],
                     "weight_decay": 0.0}]

        opt = aw.AdamW(groups(mine), lr=1.0, eps=1e-8)
        plain_groups = groups(plain)
        order = [p for g in groups(list(range(len(mine)))) for p in g["params"]]
        m_plain = [torch.zeros_like(p) for p in plain]
        v_plain = [torch.zeros_like(p) for p in plain]

        def plain_step(step, lr, plain_groups=plain_groups, order=order, grads=grads,
                       m_plain=m_plain, v_plain=v_plain):
            k = 0
            for group in plain_groups:
                idx = order[k:k + len(group["params"])]
                aw.adamw_reference(group["params"], [grads[i] for i in idx],
                                   [m_plain[i] for i in idx], [v_plain[i] for i in idx],
                                   step=float(step), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                   weight_decay=group["weight_decay"])
                k += len(idx)

        def differ(opt=opt, mine=mine, plain=plain, m_plain=m_plain, v_plain=v_plain):
            return sum(differing_bits(a, b) for a, b in zip(
                [p.detach() for p in mine] + [opt.state[p]["exp_avg"] for p in mine]
                + [opt.state[p]["exp_avg_sq"] for p in mine], plain + m_plain + v_plain))

        n_params = sum(p.numel() for p in mine)
        launches = []
        with torch.no_grad():
            for step in range(1, steps + 1):
                lr = schedule(10 + step)
                for g in grads:
                    if g is not None:
                        g.normal_(generator=gen)
                for p, g in zip(mine, grads):
                    p.grad = g
                for group in opt.param_groups:
                    group["lr"] = lr
                before = aw.LAUNCHES_ADAMW
                opt.step()
                launches.append(aw.LAUNCHES_ADAMW - before)
                plain_step(step, lr)
                torch.cuda.synchronize()
                bad = differ()
                if bad or launches[-1] != 1:
                    raise AssertionError(f"adamw {name} step {step}: {bad} elements differ from "
                                         f"the plain version; {launches[-1]} launches")
            # torch's own foreach step from the plain version's state
            ref = torch.optim.AdamW(groups([torch.nn.Parameter(p) for p in plain]), lr=lr,
                                    eps=1e-8, foreach=True)
            twins = [p for g in ref.param_groups for p in g["params"]]
            for i, q in zip(order, twins):
                q.grad = grads[i] if grads[i] is not None else torch.zeros_like(q)
                ref.state[q] = {"step": torch.tensor(float(steps)), "exp_avg": m_plain[i],
                                "exp_avg_sq": v_plain[i]}
            ref.step()
            opt.step()
            torch.cuda.synchronize()
            bad = sum(differing_bits(mine[i].detach(), q.detach()) for i, q in zip(order, twins))
            if bad:
                raise AssertionError(f"adamw {name}: torch.optim.AdamW's foreach step and the "
                                     f"kernel's differ in {bad} elements")
        row = dict(config=name, parameters=n_params, tensors=len(mine),
                   tensors_without_gradient=len(none), steps_bit_equal=steps + 1,
                   launches_per_step=launches,
                   ms=time_ms(opt.step, per_sample=2),
                   plain_ms=time_ms(lambda: plain_step(steps + 2, lr), per_sample=2),
                   library_ms=time_ms(ref.step, per_sample=2),
                   bound_ms=ADAMW_BYTES * n_params / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        row["over_bound"] = row["ms"] / row["bound_ms"]
        row["roofline_pct"] = 100.0 / row["over_bound"]
        rows.append(row)
        del opt, ref, mine, plain, grads, m_plain, v_plain, twins
        torch.cuda.empty_cache()
    emit(dict(phase="adamw", card=card_line(), sets=rows))
    return rows


def model_phase(device):
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import gelu_poly as gp
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
            with torch.inference_mode(), \
                    contextlib.nullcontext() if fused else plain_gelu():
                before, gelu_before = attn.LAUNCHES, gp.LAUNCHES_GELU_FWD
                logits = model.logits(model(**batch)[:, 0], vocab_ids=vocab_ids)
                torch.cuda.synchronize()
                launches = attn.LAUNCHES - before
                gelu_launches = gp.LAUNCHES_GELU_FWD - gelu_before
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
            gelu_expect = GELU_CALLS if fused and dtype == "bfloat16" else 0
            if launches != expect or gelu_launches != gelu_expect:
                raise AssertionError(f"{dtype} fused={fused}: {launches} launches, "
                                     f"expected {expect}; gelu {gelu_launches}, expected "
                                     f"{gelu_expect}")
            results[fused] = (logits.float(), statistics.median(t))
        (lk, tk), (lp, tp) = results[True], results[False]
        diff = (lk - lp).abs().max().item()
        top1 = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        out[dtype] = dict(max_abs_logit_diff=diff, top1_agreement=top1,
                          forward_ms_kernel=tk, forward_ms_plain=tp,
                          launches_per_forward=24,
                          gelu_launches_per_forward=GELU_CALLS if dtype == "bfloat16" else 0)
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
    falling, 24 forward and 24 backward launches a step, and 13 each way of
    row 7 (gelu_poly)."""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import gelu_poly
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
        reset_counts()
        t0 = time.perf_counter()
        metrics = trainer._train_step(opt, batch, step)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append((attn.LAUNCHES, attn.LAUNCHES_BWD, gelu_poly.LAUNCHES_GELU_FWD,
                         gelu_poly.LAUNCHES_GELU_BWD))
        losses.append(metrics["loss"].item())
    if any(n != (24, 24, GELU_CALLS, GELU_CALLS) for n in launches):
        raise AssertionError(f"bf16 steps: launches {launches}, expected 24 + 24 a step "
                             f"and {GELU_CALLS} + {GELU_CALLS} of row 7")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 loss did not fall: {losses}")
    step_ms = statistics.median(times[2:])
    out["bf16"] = dict(losses=losses, step_ms=times, median_step_ms=step_ms,
                       examples_per_sec=TRAIN_BATCH / step_ms * 1e3,
                       launches_per_step=dict(fwd=24, bwd=24, gelu_fwd=GELU_CALLS,
                                              gelu_bwd=GELU_CALLS),
                       peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                       device_profile_step=device_profile(
                           lambda: trainer._train_step(opt, batch, 8), top=15))
    del model, trainer, opt
    torch.cuda.empty_cache()
    out["remat"] = remat_steps(device, state, batch)
    emit(dict(phase="train", B=TRAIN_BATCH, L=128, **out))
    return out


def remat_steps(device, state, batch, steps=4):
    """4 bf16 steps through the kernels with ``UnimoConfig.remat`` off and
    on, from the same weights and batch (the same dropout: the recomputed
    layers draw the forward's masks): the first step's loss must agree bit
    for bit (the same forward); the step ms (median after two) and peak GB
    of each, and the attention launches a step (remat runs each layer's
    forward again in the backward)."""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.models.unimo import UnimoConfig, UnimoForMaskedLM
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    runs = {}
    for remat in (False, True):
        with torch.device(device):
            model = UnimoForMaskedLM(UnimoConfig(dtype="bfloat16", remat=remat))
        model.load_state_dict(state)
        trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(seed=3), device=device)
        opt = make_optimizer(model, 1e-4, 100, warmup_ratio=0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times, launches = [], [], []
        for step in range(steps):
            attn.LAUNCHES = attn.LAUNCHES_BWD = 0
            t0 = time.perf_counter()
            metrics = trainer._train_step(opt, batch, step)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append((attn.LAUNCHES, attn.LAUNCHES_BWD))
            losses.append(metrics["loss"].item())
        runs["on" if remat else "off"] = dict(
            losses=losses, step_ms=times, median_step_ms=statistics.median(times[2:]),
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches_per_step=dict(fwd=launches[-1][0], bwd=launches[-1][1]))
        del model, trainer, opt
        torch.cuda.empty_cache()
    first = (runs["off"]["losses"][0], runs["on"]["losses"][0])
    if first[0] != first[1] or not all(math.isfinite(x) for r in runs.values()
                                       for x in r["losses"]):
        raise AssertionError(f"remat: first losses {first}, or a loss is not finite")
    return runs


WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lamda mu nu "
         "xi omicron pi rho sigma tau upsilon").split()


def write_dataset(root, n_ent=64, n_rel=8, n_triples=200, n_train=128, n_test=200,
                  seed=0, n_dev=16):
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
    for split, n in (("train", n_train), ("dev", n_dev), ("test", n_test)):
        with open(os.path.join(mars, f"{split}.json"), "w") as f:
            for i in range(n):
                f.write(json.dumps(dict(
                    example=[rng.choice(ents), rng.choice(ents)],
                    question=rng.choice(ents), answer=rng.choice(analogy_ents),
                    relation=rng.choice(analogy_rels), mode=i % 3)) + "\n")
    return markg, mars


class BuildOrder:
    """Records, in a CLI run, the calls of ``kernels.build.build`` and
    ``build_widths`` (the CLI's ``core/cache.enable_compilation_cache``) and
    the batches the data pipeline assembles (``BatchIterator.__iter__``
    yielding), so a phase can check that every kernel was built before the
    first batch. On entry
    with ``fresh_dir`` the build directory is a new empty one, so the CLI
    compiles every kernel itself; on exit the build directory and the
    loaded libraries are restored."""

    def __init__(self, fresh_dir=None):
        self.fresh_dir = fresh_dir
        self.events = []

    def __enter__(self):
        from mkg_analogy_tpu_torch.data import batching
        from mkg_analogy_tpu_torch.kernels import build

        self._saved = (build.build, batching.BatchIterator.__iter__, build.BUILD_DIR,
                       build._LOADED, build.build_widths)
        real_build, real_iter = self._saved[:2]
        real_widths = self._saved[4]
        events = self.events

        def recorded_widths(head_dims, names=build.ATTENTION_SOURCES):
            head_dims = list(head_dims)
            t0 = time.perf_counter()
            real_widths(head_dims, names)
            widths = {build.library_width(d) for d in head_dims} - {None}
            events.append(("build_widths", time.perf_counter() - t0, sorted(widths),
                           all(build.library_path(n, w).exists() for n in names
                               for w in widths)))

        def recorded_build(names=()):
            t0 = time.perf_counter()
            real_build(names)
            names = list(names) or sorted(p.stem for p in build.CSRC.glob("*.cu"))
            events.append(("build", time.perf_counter() - t0,
                           all(build.library_path(n).exists() for n in names)))

        def recorded_iter(it):
            for batch in real_iter(it):
                events.append(("batch",))
                yield batch

        build.build = recorded_build
        build.build_widths = recorded_widths
        batching.BatchIterator.__iter__ = recorded_iter
        if self.fresh_dir:
            build.BUILD_DIR = build.Path(self.fresh_dir)
            build._LOADED = {}
        return self

    def __exit__(self, *exc):
        from mkg_analogy_tpu_torch.data import batching
        from mkg_analogy_tpu_torch.kernels import build

        (build.build, batching.BatchIterator.__iter__, build.BUILD_DIR,
         build._LOADED, build.build_widths) = self._saved

    def check(self, what):
        """(build seconds) where the first event is a build that left every
        library in place and a batch follows; raises otherwise."""
        if not self.events or self.events[0][0] != "build" or not self.events[0][2] \
                or ("batch",) not in self.events:
            raise AssertionError(f"{what}: the kernels were not built before the first "
                                 f"batch: {self.events[:3]}")
        return self.events[0][1]

    def check_widths(self, what, widths):
        """(build seconds) where the libraries of the padded ``widths`` were
        all in place before the first batch; raises otherwise."""
        first_batch = self.events.index(("batch",)) if ("batch",) in self.events else 0
        built = [e for e in self.events[:first_batch] if e[0] == "build_widths"]
        if not built or built[0][2] != sorted(widths) or not built[0][3]:
            raise AssertionError(f"{what}: the libraries of padded widths {widths} were not "
                                 f"built before the first batch: {self.events[:4]}")
        return built[0][1]


def cli_phase():
    """The evaluation path (slice 1's main path): the CLI's --only_test
    evaluation in bf16 through the kernel (launches counted from 0). Then the reference check: the same
    evaluation in fp32 through the kernel and through the plain attention
    must rank at least 99% of the examples alike (fp32 differences are
    summation-order ulps, far below the logit gaps of almost every
    example). The plain runs take gelu_poly's plain chain too (bf16). The
    bf16 plain run is only
    reported: with random weights BertFusion's unscaled softmax over
    768-wide dot products is near-argmax, so last-bit differences in the
    text context can move its choice of vision token."""
    import numpy as np

    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import gelu_poly as gp

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
            reset_counts()
            t0 = time.perf_counter()
            with BuildOrder() as order, \
                    plain_gelu() if fused == "0" else contextlib.nullcontext():
                metrics = cli.main(argv)
            seconds = time.perf_counter() - t0
            order.check(f"cli {dtype} --fused_attention {fused}")
            launches = attn.LAUNCHES
            gelu_launches = (gp.LAUNCHES_GELU_FWD, gp.LAUNCHES_GELU_BWD)
            ranks = np.load(os.path.join(out_dir, "test_ranks.npz"))["ranks"]
            runs[dtype, fused] = (metrics, launches, ranks, seconds, gelu_launches)
    n_batches = math.ceil(n_test / 128)
    for (dtype, fused), (metrics, launches, ranks, _, gelu_launches) in runs.items():
        expect = 24 * n_batches if fused == "1" else 0
        gelu_expect = GELU_CALLS * n_batches if (dtype, fused) == ("bfloat16", "1") else 0
        if launches != expect or gelu_launches != (gelu_expect, 0):
            raise AssertionError(f"cli {dtype} --fused_attention {fused}: "
                                 f"{launches} launches, expected {expect}; gelu "
                                 f"{gelu_launches}, expected ({gelu_expect}, 0)")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cli {dtype}: non-finite metrics {metrics}")
        if not 0.0 < metrics["Eval_entity/mrr"] <= 1.0 or len(ranks) != n_test:
            raise AssertionError(f"cli {dtype}: mrr {metrics['Eval_entity/mrr']}, "
                                 f"{len(ranks)} ranks")
    fp32_same = float((runs["float32", "1"][2] == runs["float32", "0"][2]).mean())
    if fp32_same < 0.99:
        raise AssertionError(f"cli fp32: kernel and plain attention rank alike "
                             f"for only {fp32_same} of the examples")
    metrics, launches, ranks, seconds, gelu_launches = runs["bfloat16", "1"]
    plain_metrics, _, plain_ranks, plain_seconds, _ = runs["bfloat16", "0"]
    emit(dict(phase="cli", dtype="bfloat16", examples=n_test, eval_batches=n_batches,
              launches=launches, gelu_launches=gelu_launches[0],
              mrr=metrics["Eval_entity/mrr"],
              hits1=metrics["Eval_entity/hits1"], hits10=metrics["Eval_entity/hits10"],
              seconds=seconds, fp32_rank_agreement_kernel_vs_plain=fp32_same,
              fp32_mrr=runs["float32", "1"][0]["Eval_entity/mrr"],
              bf16_plain_mrr=plain_metrics["Eval_entity/mrr"],
              bf16_rank_agreement_kernel_vs_plain=float((ranks == plain_ranks).mean()),
              bf16_plain_seconds=plain_seconds, kernels_built_before_first_batch=True,
              nonfinite_gold=metrics["Eval_entity/nonfinite_gold"]))
    return launches, gelu_launches[0]


def cli_train_phase():
    """The main path of the training slice: the CLI fine-tune, bf16, through
    the kernels, with both counts set to 0 just before and read just after.
    128 training examples at B=32 are 4 steps (24 + 24 launches each); the
    dev split (16) is one eval batch and the test split (200) two, 24
    forward launches each; 13 of row 7's each way a step and 13 a forward;
    one of row 8's (AdamW) a step. The best-dev checkpoint is written and restored
    for the test; ``--only_test --checkpoint`` on it must give the same
    ranks. The fit runs with an empty build directory: the CLI must compile
    every kernel before the first batch is assembled, and its first step
    (its ms printed) then includes no nvcc."""
    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import adamw as aw
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import gelu_poly as gp
    from mkg_analogy_tpu_torch.train import checkpoint
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer

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
        step_ms = []
        real_step = MarTTrainer._train_step

        def timed_step(self, *args, **kwargs):
            # the fit's first step, synchronised on both sides: it must not
            # include nvcc, which the CLI ran before the first batch
            if step_ms:
                return real_step(self, *args, **kwargs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = real_step(self, *args, **kwargs)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            return metrics

        reset_counts()
        t0 = time.perf_counter()
        MarTTrainer._train_step = timed_step
        try:
            with BuildOrder(fresh_dir=os.path.join(root, "kernels")) as order:
                metrics = cli.main(argv(fit_dir, "--max_epochs", "1", "--batch_size", "32"))
        finally:
            MarTTrainer._train_step = real_step
        seconds = time.perf_counter() - t0
        build_seconds = order.check("cli fine-tune")
        launches = dict(fwd=attn.LAUNCHES, bwd=attn.LAUNCHES_BWD,
                        gelu_fwd=gp.LAUNCHES_GELU_FWD, gelu_bwd=gp.LAUNCHES_GELU_BWD,
                        adamw=aw.LAUNCHES_ADAMW)
        steps = n_train // 32
        forwards = steps + 1 + math.ceil(n_test / 128)
        expect = dict(fwd=24 * forwards, bwd=24 * steps, gelu_fwd=GELU_CALLS * forwards,
                      gelu_bwd=GELU_CALLS * steps, adamw=steps)
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
              retest_ranks_identical=True, nonfinite_gold=metrics["Eval_entity/nonfinite_gold"],
              kernels_built_before_first_batch=True, cli_build_seconds=build_seconds,
              step_1_ms=step_ms[0]))
    return launches


FIT_TRAIN, FIT_DEV = 384, 1020  # 12 steps at B=32; MARS's dev split


def prefetch_threads():
    import threading

    return [t for t in threading.enumerate() if t.name == "mkg-prefetch" and t.is_alive()]


class _EpochClock:
    """A MetricLogger for ``fit`` that keeps what it logs and the host clock
    of each call: fit logs its epoch's stats right after the end-of-epoch
    synchronisation, which ends the timed window."""

    def __init__(self):
        self.records = []

    def log(self, step, metrics, prefix=""):
        self.records.append((time.perf_counter(), prefix, dict(metrics)))

    def epoch_end(self):
        return next(t for t, prefix, m in self.records if prefix == "train/" and "epoch" in m)

    def close(self):
        pass


def legacy_fit(trainer, features, on_step):
    """The loop ``MarTTrainer.fit`` ran before ``_prefetch`` (one epoch,
    evaluation left out): each batch assembled by the epoch generator and
    copied with the blocking ``_put_batch`` on this thread, then stepped,
    with the optimizer ``fit`` builds. ``on_step(step)`` runs before each
    step; the loop ends with a synchronisation."""
    from mkg_analogy_tpu_torch.train.optim import make_optimizer

    cfg = trainer.config
    steps, epoch_batches = trainer._epoch_schedule(features)
    limit = cfg.limit_train_batches
    optimizer = make_optimizer(trainer.model, cfg.lr, min(steps, limit or steps) * cfg.max_epochs,
                               cfg.warmup_ratio, cfg.weight_decay)
    optimizer.zero_grad()
    losses = []
    for step, (kind, batch) in enumerate(epoch_batches()):
        if limit and step >= limit:
            break
        batch.pop("valid")
        dbatch = trainer._put_batch(batch)
        on_step(step)
        metrics = trainer._train_step(optimizer, dbatch, step, trainer.image_table,
                                      loss_kind=kind)
        losses.append(metrics["loss"])
    trainer._sync()
    return losses


def legacy_evaluate(trainer, features):
    """The evaluation loop before ``_prefetch``: each batch copied with
    ``_put_batch`` on this thread, one transfer of the ranks at the end;
    the valid ranks in order."""
    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.data.batching import BatchIterator

    it = BatchIterator(features, trainer.config.eval_batch_size, shuffle=False, pad_tail=True)
    with torch.inference_mode():
        outs = [trainer._eval_step(trainer._put_batch(b), trainer.image_table) for b in it]
        outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in outs]
    return np.concatenate([o["ranks"][o["valid"]] for o in outs])


def fit_prefetch_phase(device):
    """``_prefetch`` on the fine-tune path at full width: MKGformer, bf16,
    B=32, L=128, dropout on, the single-block kernels; ``write_dataset``
    with 4,126 entities (MARS's 2,063 analogy entities), FIT_TRAIN training
    examples (12 steps) and a dev split of FIT_DEV examples (MARS's)
    evaluated at B=128. Two loops on the same batch sequence from the same
    weights, each run twice, alternated (the host's clock varies
    between runs more than the loops differ): ``MarTTrainer.fit`` (one
    epoch, then its dev evaluation) and ``evaluate``, both through
    ``_prefetch``; and the loop before it (``legacy_fit``,
    ``legacy_evaluate``). For each: host ms a step over steps 3-12 (the
    epoch's wall clock from a synchronisation before step 3 to the one
    that ends the epoch, none between), device ms a step from a profiled
    window of 6 steps (torch.profiler, copies included), the idle share
    1 - device / host, eval examples/s (the second of two evaluations) and
    peak GB. Gates: the two loops' losses equal step by step (same weights,
    batches and dropout seeds), their dev ranks equal, every loss finite,
    and no prefetch worker alive after ``fit`` returns, also after a
    ``limit_train_batches`` break."""
    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.cli.main import synthetic_image_table
    from mkg_analogy_tpu_torch.data.module import KGCDataModule
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.models.registry import create_model
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    n_ent = 4126
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prefetch_", dir=".") as root:
        markg, mars = write_dataset(root, n_ent=n_ent, n_train=FIT_TRAIN, n_test=16,
                                    n_dev=FIT_DEV)
        data = KGCDataModule(data_dir=mars, pretrain_path=markg, max_seq_length=128,
                             cache_dir=os.path.join(root, "cache"))
        train, dev = data.features("train"), data.features("dev")
    with torch.device(device):
        model = create_model("MKGformerKGC", vocab_size=data.vocab.padded_vocab_size,
                             dtype="bfloat16", attention="single")
    clock = _EpochClock()
    trainer = MarTTrainer(model, data.vocab, TrainConfig(batch_size=32, eval_batch_size=128,
                                                         max_epochs=1, alpha=0.43),
                          device=device, logger=clock)
    trainer.set_image_table(synthetic_image_table("synthetic", n_ent, 224, device))
    trainer.init_params(7)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    steps = FIT_TRAIN // 32
    marks = {}

    def mark(step):
        if step == 2:
            torch.cuda.synchronize()
            marks["t2"] = time.perf_counter()

    def run_prefetch():
        model.load_state_dict(state)
        clock.records.clear()
        losses = []
        real = MarTTrainer._train_step

        def step_fn(optimizer, batch, step, image_table=None, loss_kind=None):
            mark(step)
            metrics = real(trainer, optimizer, batch, step, image_table, loss_kind=loss_kind)
            losses.append(metrics["loss"])
            return metrics

        trainer._train_step = step_fn
        try:
            torch.cuda.reset_peak_memory_stats()
            trainer.fit(train, dev)
        finally:
            del trainer._train_step
        host_ms = (clock.epoch_end() - marks["t2"]) / (steps - 2) * 1e3
        if prefetch_threads():
            raise AssertionError(f"fit_prefetch: workers alive after fit: {prefetch_threads()}")
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.evaluate(dev, dump_path=os.path.join(scratch, "ranks.npz"))
            times.append(time.perf_counter() - t0)
        ranks = np.load(os.path.join(scratch, "ranks.npz"))["ranks"]
        return losses, host_ms, FIT_DEV / times[-1], ranks, torch.cuda.max_memory_allocated()

    def run_legacy():
        model.load_state_dict(state)
        torch.cuda.reset_peak_memory_stats()
        losses = legacy_fit(trainer, train, mark)
        host_ms = (time.perf_counter() - marks["t2"]) / (steps - 2) * 1e3
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranks = legacy_evaluate(trainer, dev)
            times.append(time.perf_counter() - t0)
        return losses, host_ms, FIT_DEV / times[-1], ranks, torch.cuda.max_memory_allocated()

    def device_ms(loop):
        """Device ms a step over a window of 6 steps (no evaluation)."""
        trainer.config.limit_train_batches, trainer.config.check_val_every_n_epoch = 6, 100
        try:
            if loop == "prefetch":
                prof = device_profile(lambda: trainer.fit(train, dev), top=8)
            else:
                prof = device_profile(lambda: legacy_fit(trainer, train, lambda step: None),
                                      top=8)
        finally:
            trainer.config.limit_train_batches, trainer.config.check_val_every_n_epoch = None, 1
        if prefetch_threads():
            raise AssertionError("fit_prefetch: workers alive after a limit_train_batches "
                                 f"break: {prefetch_threads()}")
        return prof["device_ms"] / 6, prof["top"]

    runs = {"prefetch": [], "old": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prefetch_ranks_", dir=".") as scratch:
        for loop in ("prefetch", "old") * 2:
            attn.LAUNCHES = attn.LAUNCHES_BWD = 0
            runs[loop].append((run_prefetch if loop == "prefetch" else run_legacy)()
                              + ((attn.LAUNCHES, attn.LAUNCHES_BWD),))
    losses = {loop: [float(x) for x in r[0][0]] for loop, r in runs.items()}
    for loop, r in runs.items():
        for run in r:
            if [float(x) for x in run[0]] != losses[loop]:
                raise AssertionError(f"fit_prefetch {loop}: losses differ between repeats")
    if losses["prefetch"] != losses["old"] or len(losses["old"]) != steps \
            or not all(math.isfinite(x) for x in losses["old"]):
        raise AssertionError(f"fit_prefetch: losses {losses}")
    if not all(np.array_equal(r[3], runs["old"][0][3]) for rr in runs.values() for r in rr):
        raise AssertionError("fit_prefetch: the dev ranks differ between the loops")
    out = {}
    for loop, rr in runs.items():
        dev_ms, top = device_ms(loop)
        host = [r[1] for r in rr]
        out[loop] = dict(host_ms_per_step=host, device_ms_per_step=dev_ms,
                         idle_share=[1.0 - dev_ms / h for h in host],
                         eval_examples_per_s=[r[2] for r in rr],
                         peak_gb=max(r[4] for r in rr) / 1e9,
                         launches_fit_and_evals=rr[0][5], device_top=top)
    emit(dict(phase="fit_prefetch", B=32, L=128, dtype="bfloat16", train_examples=FIT_TRAIN,
              steps=steps, dev_examples=FIT_DEV, eval_batch=128,
              analogy_entities=len(data.vocab.analogy_entity_ids), losses=losses["old"],
              losses_equal=True, dev_ranks_equal=True, workers_alive_after_fit=0,
              card=card_line(), **out))
    del trainer, model, state
    torch.cuda.empty_cache()
    return out


def alternating_step_ms(runs, batch, rounds=3, steps=6):
    """Host ms a step of each (trainer, optimizer) of ``runs``, taken in
    turn ``rounds`` times (A B A B A B), so that the card's clocks and the
    allocator's state fall on each alike: a list of medians of steps 3-6
    of each window, and each run's losses in order."""
    import torch

    medians = {name: [] for name in runs}
    losses = {name: [] for name in runs}
    for _ in range(rounds):
        for name, (trainer, opt) in runs.items():
            times = []
            for _ in range(steps):
                t0 = time.perf_counter()
                metrics = trainer._train_step(opt, batch, len(losses[name]))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses[name].append(metrics["loss"].item())
            medians[name].append(statistics.median(times[2:]))
    return medians, losses


def qk_bf16_grad_phase(device):
    """``qk_bf16_grad`` (JAX's QK_BF16_GRAD) on the full-width MKGformer
    fine-tune step through the plain attention, from one state dict and
    batch, dropout on: bf16 with the field on and off, and fp32 as the
    yardstick. Gates: the bf16 loss bit-equal with and without (the
    forward is untouched); each gradient leaf's change with the field on
    within twice the bf16 run's own largest distance from the fp32
    gradient of that leaf (two rounding schedules, each that far from
    fp32, can be as far apart as the sum), plus one bf16 ulp (2^-8) of
    the model's largest fp32 gradient, the bf16 counterpart of the fp32
    steps' 1e-6 floor (the key biases' exact gradient is 0, so theirs is
    round-off in every run); and, as JAX's test holds it, the whole
    gradient with the field on no farther from fp32 than 1.15x the
    distance without. Then the
    median bf16 step ms (steps 3-6) with and without, and the CLI fit
    ``--qk_bf16_grad 1 --fused_attention 0`` (4 steps at B=32): finite
    metrics, no attention kernel launched, the products through
    ``_qk_scores_bf16grad``. The step times alternate off and on
    (``alternating_step_ms``)."""
    import torch

    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.models import common
    from mkg_analogy_tpu_torch.models.common import DropoutRNG
    from mkg_analogy_tpu_torch.models.unimo import UnimoConfig, UnimoForMaskedLM
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    batch = train_batch(device)
    with torch.device(device):
        model = UnimoForMaskedLM(UnimoConfig(dtype="float32", attention="plain"))
    model.init_params(torch.Generator(device=device).manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    runs, timed = {}, {}
    for dtype, flag in (("float32", False), ("bfloat16", False), ("bfloat16", True)):
        with torch.device(device):
            model = UnimoForMaskedLM(UnimoConfig(dtype=dtype, attention="plain",
                                                 qk_bf16_grad=flag))
        model.load_state_dict(state)
        trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(), device=device)
        loss, _ = trainer._finetune_loss(batch, DropoutRNG.from_seed(5, device))
        loss.backward()
        runs[dtype, flag] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
        if dtype == "bfloat16":
            timed[flag] = (trainer, make_optimizer(model, 1e-4, 100, warmup_ratio=0.0))
        del model, trainer
        torch.cuda.empty_cache()
    step_ms, _ = alternating_step_ms(timed, batch)
    del timed
    (l32, g32), (l_off, g_off), (l_on, g_on) = (runs["float32", False], runs["bfloat16", False],
                                                runs["bfloat16", True])
    if l_on != l_off or not math.isfinite(l_on):
        raise AssertionError(f"qk_bf16_grad: bf16 loss {l_on} with the field, {l_off} without")
    top = max(g.abs().max().item() for g in g32.values())
    worst, worst_leaf = 0.0, ""
    for name, ref in g32.items():
        change = (g_on[name] - g_off[name]).abs().max().item()
        bar = 2 * (g_off[name] - ref).abs().max().item() + 2 ** -8 * top
        if change / bar > worst:
            worst, worst_leaf = change / bar, name
    dist = {flag: math.sqrt(sum(((g[n] - g32[n]) ** 2).sum().item() for n in g32))
            for flag, g in ((False, g_off), (True, g_on))}
    norm = math.sqrt(sum((g ** 2).sum().item() for g in g32.values()))
    if not worst <= 1.0 or not dist[True] <= 1.15 * dist[False]:
        raise AssertionError(f"qk_bf16_grad: leaf {worst_leaf} at {worst} of its bar; "
                             f"distance from fp32 {dist}")
    del runs, g32, g_on, g_off

    calls = []
    real = common._qk_scores_bf16grad

    def spy(q, k):
        calls.append(torch.is_grad_enabled())
        return real(q, k)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_qk_", dir=".") as root:
        markg, mars = write_dataset(root)
        common._qk_scores_bf16grad = spy
        attn.LAUNCHES = attn.LAUNCHES_BWD = 0
        reset_counts()
        try:
            metrics = cli.main(["--data_dir", mars, "--pretrain_path", markg, "--device", "cuda",
                                "--dtype", "bfloat16", "--max_seq_length", "128",
                                "--image_features", "synthetic", "--max_epochs", "1",
                                "--batch_size", "32", "--qk_bf16_grad", "1",
                                "--fused_attention", "0",
                                "--output_dir", os.path.join(root, "out"),
                                "--log_dir", os.path.join(root, "logs"),
                                "--cache_dir", os.path.join(root, "cache")])
        finally:
            common._qk_scores_bf16grad = real
    kernels = all_counts()
    # 4 steps, then the dev batch and the two test batches; row 7's gelu is
    # the bf16 path's, whatever the attention
    gelu = dict(gelu_fwd=GELU_CALLS * (4 + 1 + 2), gelu_bwd=GELU_CALLS * 4)
    if not all(math.isfinite(v) for v in metrics.values()) \
            or kernels != dict({k: 0 for k in kernels}, **gelu) or sum(calls) != 4 * 24:
        raise AssertionError(f"qk_bf16_grad CLI: metrics {metrics}, launches {kernels} "
                             f"(only {gelu} expected), {sum(calls)} products under autograd "
                             "(4 steps x 24 expected)")
    emit(dict(phase="qk_bf16_grad", B=TRAIN_BATCH, L=128, attention="plain",
              loss_bf16=l_on, loss_fp32=l32, loss_bit_equal=True,
              worst_leaf_change_over_bar=worst, worst_leaf=worst_leaf,
              rel_distance_from_fp32_off=dist[False] / norm,
              rel_distance_from_fp32_on=dist[True] / norm,
              step_ms_off=step_ms[False], step_ms_on=step_ms[True],
              cli_mrr=metrics["Eval_entity/mrr"],
              cli_nonfinite_gold=metrics["Eval_entity/nonfinite_gold"],
              cli_products_under_autograd=sum(calls), cli_products_in_evaluation=len(calls)
              - sum(calls), card=card_line()))


def fused_qkv_phase(device):
    """``fused_qkv`` (JAX's USE_FUSED_QKV) on the full-width MKGformer, the
    fused model's weights from ``models/convert.py:fuse_qkv`` of the
    unfused state dict, through the single-block kernels. fp32 for the
    bars: the forward's masked-position states within 1e-3 of the
    unfused model's (the model phase's bar: 24 layers of fp32 GEMMs summed
    in other orders), one fine-tune step's loss within 1e-5 relative and
    each gradient leaf, the unfused ones fused the same way, at the bar of
    ``leaf_ratios``. bf16 for the run: 18 steps of each, the loss finite
    and falling, the step ms of each (``alternating_step_ms``, unfused and
    fused in turn)."""
    import torch

    from mkg_analogy_tpu_torch.models.common import DropoutRNG
    from mkg_analogy_tpu_torch.models.convert import fuse_qkv
    from mkg_analogy_tpu_torch.models.unimo import UnimoConfig, UnimoForMaskedLM
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    batch = train_batch(device)
    with torch.device(device):
        model = UnimoForMaskedLM(UnimoConfig(dtype="float32"))
    model.init_params(torch.Generator(device=device).manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    fused_state = fuse_qkv(state)
    del model
    out, fp32, timed = {}, {}, {}
    for fused in (False, True):
        with torch.device(device):
            model = UnimoForMaskedLM(UnimoConfig(dtype="float32", fused_qkv=fused))
        model.load_state_dict(fused_state if fused else state, strict=True)
        trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(), device=device)
        with torch.no_grad():
            states = model(**trainer._model_inputs(batch, fmt="finetune"))
        loss, _ = trainer._finetune_loss(batch, DropoutRNG.from_seed(5, device))
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        fp32[fused] = (states, loss.item(), grads if fused else fuse_qkv(grads))
        del model, trainer
        torch.cuda.empty_cache()
    err = (fp32[True][0] - fp32[False][0]).abs().max().item()
    loss_rel = abs(fp32[True][1] - fp32[False][1]) / abs(fp32[False][1])
    worst, worst_leaf = leaf_ratios(fp32[True][2], fp32[False][2])
    if not (err <= 1e-3 and loss_rel <= 1e-5 and worst <= 1.0):
        raise AssertionError(f"fused_qkv fp32: states {err} apart, loss {loss_rel}, "
                             f"gradient {worst_leaf} at {worst} of its bar")
    out["fp32"] = dict(max_abs_err_states=err, loss_rel_diff=loss_rel,
                       worst_err_over_bar=worst, worst_leaf=worst_leaf)
    del fp32
    for fused in (False, True):
        with torch.device(device):
            model = UnimoForMaskedLM(UnimoConfig(dtype="bfloat16", fused_qkv=fused))
        model.load_state_dict(fused_state if fused else state, strict=True)
        trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(seed=3), device=device)
        timed[fused] = (trainer, make_optimizer(model, 1e-4, 100, warmup_ratio=0.0))
    step_ms, losses = alternating_step_ms(timed, batch)
    for fused, run in losses.items():
        if not all(math.isfinite(x) for x in run) or not run[-1] < run[0]:
            raise AssertionError(f"fused_qkv bf16 fused={fused}: losses {run}")
        out["bf16_fused" if fused else "bf16_unfused"] = dict(
            losses=run, median_step_ms=step_ms[fused])
    del timed, model, trainer
    torch.cuda.empty_cache()
    emit(dict(phase="fused_qkv", B=TRAIN_BATCH, L=128, attention="single", card=card_line(),
              **out))


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


def flash_inputs(b, lq, lk, kind, geometry, dtype, device, seed, head_dim=HEAD_DIM):
    """q, k, v, a cotangent, the (B, Lk) mask and the geometry arguments:
    text keys padded to a random length, vision keys unpadded, vision over
    [text K/V ; vision] with the text part padded."""
    import torch

    g = torch.Generator().manual_seed(seed)
    gd = torch.Generator(device=device).manual_seed(seed)
    hd = HEADS * head_dim
    q, k, v, go = (seeded_randn((b, n, hd), seed, device, dtype, gd) for n in (lq, lk, lk, lq))
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


def flash_bound_times(kernel, b, lq, lk, dtype_bytes, heads=HEADS, head_dim=HEAD_DIM,
                      flops_per_s=BF16_FLOPS_PER_S):
    """(ms for the bytes, ms for the operations) of one call of a flash
    kernel: each input read once and each output written once over the HBM
    rate (q, k, v and the (B, heads, Lq) fp32 lse out for the forward; q, k,
    v, g, lse and delta in and dk, dv or dq out for the backward kernels;
    the fp32 mask and the int32 boundary), and the products it does, each
    2·B·heads·Lq·Lk·d flops (forward QKᵀ and PV: 2; dK/dV QKᵀ, dV, dP and
    dK: 4; dQ QKᵀ, dP and dQ: 3) over ``flops_per_s`` (the bf16 tensor-core
    peak by default)."""
    hd = heads * head_dim
    stat = b * heads * lq * 4
    small = b * lk * 4 + b * 4
    tensors, stats, products = {"fwd": ((2 * lq + 2 * lk), 1, 2),
                                "dkv": ((2 * lq + 4 * lk), 2, 4),
                                "dq": ((3 * lq + 2 * lk), 2, 3)}[kernel]
    nbytes = b * tensors * hd * dtype_bytes + stats * stat + small
    flops = products * 2 * b * heads * lq * lk * head_dim
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3


def flash_dw_scales(fa, q, k, v, mask, go, lse, delta, bnd, w, geo, rate, seed,
                    block_q=None, block_k=None, heads=HEADS, head_dim=HEAD_DIM, causal=False):
    """sum |dS · S_raw| over each analogy region, walking the logical tiles
    (by default JAX's (256, 512)) as the plain backward does: the scale of
    the dw0/dw1 sums."""
    import torch

    assert q.shape[2] == heads * head_dim
    tiles = fa._Tiles(q.float(), k.float(), mask, heads, bnd, w, geo, rate, seed,
                      block_q or fa.BLOCK_Q, block_k or fa.BLOCK_K, None, causal)
    qh, kh, vh, gh = (fa._split_heads(x, heads, torch.float32) for x in (q, k, v, go))
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


def flash_errors(fa, what, key, q, k, v, go, mask, kw, rate, seed, head_dim=HEAD_DIM,
                 heads=HEADS, causal=False):
    """One forward and one backward launch of the flash kernels against
    their plain versions (at JAX's logical tiles, dropout ``rate`` from
    ``seed``, the dtype of q, ``causal`` or not): out within 2e-5 fp32 /
    2e-2 bf16, lse within 1e-5; dq, dk, dv, from the kernel forward's out
    and lse, within 2e-5 / 2^-7 of each result's largest |value|; dw within
    1e-5 of its sum of |terms|. Each wrapper must count its launch, on the
    route of the dtype. ``{name_key: error}``; raises beyond a bar."""
    import torch

    dtype = q.dtype
    kw = dict(kw, compute_dtype=dtype, dropout_rate=rate, deterministic=rate == 0.0,
              dropout_seed=seed, **({"causal": True} if causal else {}))
    args = (heads, *resolve_geometry(fa, q, kw, rate, seed), fa.BLOCK_Q, fa.BLOCK_K,
            *((None, True) if causal else ()))
    before, before_mma = flash_counts(), flash_mma_counts()
    out, lse = fa._launch_fwd(q, k, v, mask, *args)
    delta = fa._delta(go, out, heads)
    got = fa._launch_bwd(q, k, v, mask, go, lse, delta, *args)
    mma = int(dtype == torch.bfloat16)  # the dtype alone picks the route
    if (flash_counts() != {kernel: n + 1 for kernel, n in before.items()}
            or flash_mma_counts() != {k_: n + mma for k_, n in before_mma.items()}):
        raise AssertionError(f"flash {what}: a wrapper counted no launch, or a kernel of the "
                             "other route ran")
    want_out, want_lse = fa._plain_fwd(q, k, v, mask, *args[:6], dtype, *args[6:])
    want = fa.flash_attention_bwd_reference(q, k, v, mask, go, heads, out=out, lse=lse, **kw)
    torch.cuda.synchronize()
    row = {}
    err = (out.float() - want_out.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    row[f"fwd_max_abs_err_{key}"] = err
    row[f"lse_max_abs_err_{key}"] = lse_err
    bar = 2e-5 if dtype == torch.float32 else 2e-2
    if not (err <= bar and lse_err <= 1e-5):
        raise AssertionError(f"flash fwd {what}: out {err} > {bar} or lse {lse_err} > 1e-5")
    bar = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    for t_name, a, c in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        err = (a.float() - c.float()).abs().max().item()
        top = c.float().abs().max().item()
        row[f"max_abs_err_{t_name}_{key}"] = err
        if not err <= bar * top:
            raise AssertionError(f"flash bwd {what} {t_name}: {err} > {bar} * {top}")
    if args[3] is not None:  # the geometry
        scales = flash_dw_scales(fa, q, k, v, mask, go, lse, delta, *args[1:6],
                                 heads=heads, head_dim=head_dim, causal=causal)
        for i in range(2):
            err = abs(got[3][i].item() - want[3][i].item())
            row[f"dw{i}_err_{key}"] = err
            if not err <= 1e-5 * scales[i]:
                raise AssertionError(f"flash bwd {what} dw{i}: {err} > 1e-5 * {scales[i]}")
    elif got[3].abs().max().item() != 0.0:
        raise AssertionError(f"flash bwd {what}: dw without a geometry")
    return row


def flash_kernel_phase(device):
    """The three flash kernels against their plain versions at every shape
    of FLASH_SHAPES, in fp32 (TF32 off) and bf16, dropout 0 and 0.1 (the
    same seed, so the masks must agree). Bars: forward 2e-5 fp32 / 2e-2
    bf16 absolute (the forward bars of the single-block kernel), lse 1e-5;
    backward, from the kernel forward's out and lse, 2e-5 fp32 / 2^-7 bf16
    of each result's largest |value| (a term rounded at a cast point can
    land one bf16 ulp apart), dw within 1e-5 of its sum of |terms|. Then
    the times in bf16 (dropout 0.1 on text keys as the text tower trains):
    each kernel, the plain forward and the plain backward (one walk
    computes dq, dk and dv, so both backward kernels' rows carry its time),
    SDPA's forward and backward (forward-and-backward minus forward) where
    no analogy multiplier applies, and the bounds; and each kernel in fp32
    on the same calls (``{kernel}_ms_fp32``, the CUDA-core kernels of the
    fp32 route) with its fp32 bounds and SDPA's fp32 forward
    (``library_fwd_ms_fp32``)."""
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
                row.update(flash_errors(fa, f"{name} {key}", key, q, k, v, go, mask, kw, rate,
                                        4321))
                del q, k, v, go
        # timing in the main path's dtype
        rate = 0.1 if kind in ("text", "text_image") else 0.0
        q, k, v, go, mask, kw = flash_inputs(b, lq, lk, kind, geometry, torch.bfloat16,
                                             device, seed=7)
        kw = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=rate,
                  deterministic=rate == 0.0, dropout_seed=99)
        args = (HEADS, *resolve_geometry(fa, q, kw, rate, 99), fa.BLOCK_Q, fa.BLOCK_K)
        out, lse = fa._launch_fwd(q, k, v, mask, *args)
        delta = fa._delta(go, out, HEADS)
        n = dict(samples=5, per_sample=3) if lq >= 2048 else {}
        row["fwd_ms"] = time_ms(lambda: fa._launch_fwd(q, k, v, mask, *args), **n)
        # the tensor-core forward's design: the keys' scores in registers
        # where they are one logical tile of up to 256, else two sweeps
        row["fwd_design"] = "resident" if row["tiles"][3] == 1 and lk <= 256 else "streaming"
        row["dkv_ms"] = time_ms(lambda: fa._launch_bwd_dkv(q, k, v, mask, go, lse, delta,
                                                           *args), **n)
        row["dq_ms"] = time_ms(lambda: fa._launch_bwd_dq(q, k, v, mask, go, lse, delta,
                                                         *args), **n)
        # the same calls on the fp32 route: the CUDA-core kernels
        slow = dict(samples=5, per_sample=3)
        q32, k32, v32, go32 = (x.float() for x in (q, k, v, go))
        out32, lse32 = fa._launch_fwd(q32, k32, v32, mask, *args)
        delta32 = fa._delta(go32, out32, HEADS)
        row["fwd_ms_fp32"] = time_ms(lambda: fa._launch_fwd(q32, k32, v32, mask, *args), **slow)
        row["dkv_ms_fp32"] = time_ms(lambda: fa._launch_bwd_dkv(
            q32, k32, v32, mask, go32, lse32, delta32, *args), **slow)
        row["dq_ms_fp32"] = time_ms(lambda: fa._launch_bwd_dq(
            q32, k32, v32, mask, go32, lse32, delta32, *args), **slow)
        del q32, k32, v32, go32, out32, lse32, delta32
        row["plain_fwd_ms"] = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, mask, HEADS, **kw), **n)
        row["plain_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, mask, go, HEADS, out=out, lse=lse, **kw), **n)
        row["library_fwd_ms"] = row["library_bwd_ms"] = row["library_fwd_ms_fp32"] = None
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
            # SDPA's fp32 forward beside the fp32 route's (TF32 off)
            q32h, k32h, v32h = (heads(x.float()) for x in (q, k, v))
            bias32 = None if bias is None else bias.float()
            row["library_fwd_ms_fp32"] = time_ms(lambda: F.scaled_dot_product_attention(
                q32h, k32h, v32h, attn_mask=bias32, dropout_p=0.0), **slow)
            del q32h, k32h, v32h
            row["library_note"] = ("SDPA without dropout" + (" with the padding mask as a "
                                   "bias" if bias is not None else ""))
        for kernel in ("fwd", "dkv", "dq"):
            t_bytes, t_ops = flash_bound_times(kernel, b, lq, lk, 2)
            row[f"{kernel}_bytes_ms"], row[f"{kernel}_operations_ms"] = t_bytes, t_ops
            row[f"{kernel}_bound_ms"] = max(t_bytes, t_ops)
            row[f"{kernel}_bound_by"] = bound_by(t_bytes, t_ops)
            t_bytes, t_ops = flash_bound_times(kernel, b, lq, lk, 4,
                                               flops_per_s=FP32_FLOPS_PER_S)
            row[f"{kernel}_bytes_ms_fp32"], row[f"{kernel}_operations_ms_fp32"] = t_bytes, t_ops
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


def lse_bars(lse, mask):
    """The bar of each lse entry: 1e-5 on a batch row with a key to attend;
    on a row whose keys are all masked two fp32 ulps of the value (its
    scores, max and lse sit at -1e4, where an ulp is 9.8e-4, and the
    products' summation order moves the max by one ulp now and then)."""
    import torch

    bars = torch.clamp(lse.abs() * 2.0 ** -22, min=1e-5)
    return torch.where(mask.any(dim=1)[:, None, None], torch.full_like(lse, 1e-5), bars)


def flash_edge_phase(device, dtype=None, cases=FLASH_EDGE_CASES):
    """The flash kernels against their plain versions at ``cases`` (12
    heads of 64; the last eighth of the keys padded), dropout 0 and 0.1 with
    the same seed, so the masks must agree. bf16 (the default; the
    tensor-core kernels): the forward within 2e-2 absolute, the backward,
    from the kernel forward's out and lse, within 2^-7 of each result's size
    (flash_bwd_sizes); fp32 (the CUDA-core kernels): 2e-5 absolute and 2e-5
    of the size. lse within lse_bars; dw within 1e-5 of its sum of |terms|.
    Returns the errors by name."""
    import torch

    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    dtype = dtype or torch.bfloat16
    fwd_bar, bwd_bar = (2e-2, 2.0 ** -7) if dtype == torch.bfloat16 else (2e-5, 2e-5)
    mma = int(dtype == torch.bfloat16)  # the dtype alone picks the route
    errs = {}
    for case in cases:
        name, lq, lk, (bq, bk) = case[0], case[2], case[3], case[6]
        q, k, v, go, mask, kw = edge_inputs(case[:6], device, dtype)
        for rate in (0.0, 0.1):
            key = f"{name}{'_dropout' if rate else ''}"
            call = dict(kw, compute_dtype=dtype, dropout_rate=rate,
                        deterministic=rate == 0.0, dropout_seed=23, block_q=bq, block_k=bk)
            args = (HEADS, *resolve_geometry(fa, q, kw, rate, 23), bq, bk)
            before, before_mma = flash_counts(), flash_mma_counts()
            out, lse = fa._launch_fwd(q, k, v, mask, *args)
            delta = fa._delta(go, out, HEADS)
            got = fa._launch_bwd(q, k, v, mask, go, lse, delta, *args)
            if (flash_counts() != {n: c + 1 for n, c in before.items()}
                    or flash_mma_counts() != {n: c + mma for n, c in before_mma.items()}):
                raise AssertionError(f"flash edge {key}: a wrapper counted no launch, or a "
                                     "kernel of the other route ran")
            want_out, want_lse = fa._plain_fwd(q, k, v, mask, *args[:6], dtype, bq, bk)
            want = fa.flash_attention_bwd_reference(q, k, v, mask, go, HEADS, out=out, lse=lse,
                                                    **call)
            torch.cuda.synchronize()
            err = (out.float() - want_out.float()).abs().max().item()
            errs[f"fwd_max_abs_err_{key}"] = err
            if not err <= fwd_bar:
                raise AssertionError(f"flash edge fwd {key}: {err} > {fwd_bar}")
            lse_err = (lse - want_lse).abs()
            errs[f"lse_max_abs_err_{key}"] = lse_err.max().item()
            errs[f"lse_max_err_over_bar_{key}"] = (lse_err / lse_bars(want_lse, mask)).max().item()
            if errs[f"lse_max_err_over_bar_{key}"] > 1.0:
                raise AssertionError(f"flash edge lse {key}: {lse_err.max().item()} beyond its "
                                     "bar")
            sizes = flash_bwd_sizes(want, q, k, v, go, lk)
            for t_name, a, c, size in zip(("dq", "dk", "dv"), got[:3], want[:3], sizes):
                err = (a.float() - c.float()).abs().max().item()
                errs[f"max_abs_err_{t_name}_{key}"] = err
                if not err <= bwd_bar * size:
                    raise AssertionError(f"flash edge bwd {key} {t_name}: {err} > {bwd_bar} * "
                                         f"{size}")
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
    emit(dict(phase="flash_edges", dtype=str(dtype).replace("torch.", ""), **errs))
    return errs


def fp32_masked_row_phase(device):
    """The four fp32 CUDA-core kernels at the edge cases with a batch row
    whose keys are all masked: there every score sits at -1e4, where an fp32
    ulp is 9.8e-4, so a score rounded in two steps, where the plain versions
    round it in one FMA (kernels/attention.py:_score), moves a probability
    by 1e-3 of itself. The single-block pair at EDGE_CASES (the tiled
    kernels, one sweep over the keys), the flash kernels at FLASH_EDGE_CASES of JAX's
    (256, 512) tiles (flash_edge_phase in fp32), dropout 0 and 0.1, at the
    fp32 bars: the forward within 2e-5 absolute, the backward within 2e-5
    of each result's largest |value|, dw within 1e-5 of its sum of |terms|.
    (The plain version's q·k products come from cuBLAS, which sums some
    tiles in another order than the kernels' chain of FMAs, and at -1e4 a
    product one ulp apart moves a score by a whole step of 9.8e-4. At JAX's
    tiles the all-masked rows' products agree; at 96 x 160 tiles they do
    not, and the check would measure the products' order, not the score's
    rounding.)"""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn

    errs = {}
    for case in EDGE_CASES:
        if case[5] is None:
            continue
        q, k, v, g, mask, kw = edge_inputs(case, device, torch.float32)
        for rate in (0.0, 0.1):
            key = f"single_{case[0]}{'_dropout' if rate else ''}"
            call = dict(kw, compute_dtype=torch.float32, dropout_rate=rate,
                        deterministic=rate == 0.0, dropout_seed=29)
            before = attn.LAUNCHES
            got = attn.fused_attention(q, k, v, mask, HEADS, **call)
            want = attn.fused_attention_reference(q, k, v, mask, HEADS, **call)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            errs[f"fwd_max_abs_err_{key}"] = err
            if attn.LAUNCHES != before + 1 or not err <= 2e-5:
                raise AssertionError(f"fp32 edge {key}: kernel vs plain {err} > 2e-5 "
                                     f"(launches {attn.LAUNCHES - before})")
            errs.update({n: e for n, e in bwd_errors(
                attn, f"fp32 edge {key}", key, q, k, v, mask, g, call, rate, 29, 2e-5).items()
                if "err" in n})
    emit(dict(phase="fp32_masked_rows", dtype="float32", single=errs))
    flash = flash_edge_phase(device, torch.float32, [
        c for c in FLASH_EDGE_CASES if c[5] is not None and c[6] == (256, 512)])
    return max([e for n, e in errs.items() if "max_abs_err" in n]
               + [e for n, e in flash.items() if n.startswith(("fwd_", "max_abs_err"))])


# Kimi-VL's latent attention as KimiVLForMaskedLM sends it to rows 3-5 on
# the main path of its benchmark cell (B=32): 16 heads, queries and keys of
# 128 + 64 columns a head, values of 128, causal over 100 image and 128
# text positions, the key mask and the analogy multiplier over the text
# after the image prefix; 14 layers a step, and the CLIP tower's 12 calls
# (two images of 50 tokens an example, 12 heads of 64, not causal).
KIMI_MLA = dict(B=32, heads=16, L=228, d=192, d_v=128, images=100, text=128)
KIMI_LAYERS, KIMI_VISION_CALLS = 14, 12
KIMI_VOCAB, KIMI_WORD_ROWS = 32000, 20480  # port_bench/configs/kimi_vl_a3b.json


def kimi_mla_inputs(device, seed, dtype):
    """q, k (B, L, heads·d), v and a cotangent (B, L, heads·d_v), the (B, L)
    key mask (the image keys, then the text padded to 48-128) and the
    analogy geometry's keywords, as KimiVLForMaskedLM builds them."""
    import torch

    c = KIMI_MLA
    b, n, prefix = c["B"], c["L"], c["images"]
    g = torch.Generator().manual_seed(seed)
    gd = torch.Generator(device=device).manual_seed(seed)
    q, k = (seeded_randn((b, n, c["heads"] * c["d"]), seed, device, dtype, gd) for _ in range(2))
    v, go = (seeded_randn((b, n, c["heads"] * c["d_v"]), seed, device, dtype, gd)
             for _ in range(2))
    lens = torch.randint(48, c["text"] + 1, (b,), generator=g)
    mask = torch.cat([torch.ones(b, prefix),
                      (torch.arange(c["text"])[None] < lens[:, None]).float()], dim=1)
    kw = dict(boundary=(lens // 2).to(device, torch.int32),
              w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device),
              row_start=prefix, text_len=n, offset=prefix)
    return q, k, v, go, mask.to(device), kw


def kimi_vl_phase(device):
    """Rows 3-5's causal instances with values narrower than the head (the
    ``-DMKG_ATTN_DP`` code of the 192-wide library), at latent attention's
    call in the Kimi-VL cell (KIMI_MLA), then a full-width KimiVLKGC bf16
    fine-tune step. (1) The forward, dK/dV and dQ wrappers against the plain
    versions (flash_attention_reference, flash_attention_bwd_reference,
    causal), dropout 0 (the model has none) and 0.1, at the flash bars
    (flash_errors): out 2e-2, lse 1e-5, dq / dk / dv 2^-7 of each result's
    largest |value|, dw0 / dw1 1e-5 of their sums of |terms|. (2) Each
    kernel's time at dropout 0, the plain forward's and backward's, and the
    causal bounds (port_bench/bounds_mla.py). (3) KimiVLKGC at its defaults
    (14 layers, 8 of 64 experts, 32,000 rows), B=32, L=128, two 224-px
    images, AdamW: the counts set to 0 before its first step and read after
    it: 26 forward, 26 dK/dV and 26 dQ launches on the tensor cores, 14 each
    at head width 192 and 12 at 64 (the CLIP tower), 1 + 1 of row 7 (the
    projector), none of rows 1-2; 13 expert-layer forwards and 78 grouped
    products (2 + 4 a layer); the rows routed to the held experts beside the
    32 x 228 x 0.75 a layer the traffic leads one to expect. Then 7 more
    steps on the same batch (the first step's learning rate is 0): every
    loss finite and the last below the first; step ms, peak GB (with what
    earlier phases still hold, ``held_before_gb``) and a device profile of
    one step."""
    import torch

    from mkg_analogy_tpu_torch.kernels import adamw as aw
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa
    from mkg_analogy_tpu_torch.models import kimi_vl
    from mkg_analogy_tpu_torch.models.registry import create_model
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig
    from port_bench import bounds_mla

    c = KIMI_MLA
    b, heads, n, d, dv = c["B"], c["heads"], c["L"], c["d"], c["d_v"]
    row = dict(shape="kimi_vl_mla", B=b, heads=heads, Lq=n, Lk=n, head_dim=d, head_dim_v=dv,
               causal=True, geometry=(c["images"], n, c["images"]),
               launches_per_step=KIMI_LAYERS)
    for rate in (0.0, 0.1):
        key = f"bf16{'_dropout' if rate else ''}"
        q, k, v, go, mask, kw = kimi_mla_inputs(device, 228, torch.bfloat16)
        row.update(flash_errors(fa, f"kimi_vl_mla {key}", key, q, k, v, go, mask, kw, rate,
                                4321, head_dim=d, heads=heads, causal=True))
    kw = dict(kw, compute_dtype=torch.bfloat16, dropout_rate=0.0, deterministic=True,
              dropout_seed=99, causal=True)
    args = (heads, *resolve_geometry(fa, q, kw, 0.0, 99), fa.BLOCK_Q, fa.BLOCK_K, None, True)
    out, lse = fa._launch_fwd(q, k, v, mask, *args)
    delta = fa._delta(go, out, heads)
    row["fwd_ms"] = time_ms(lambda: fa._launch_fwd(q, k, v, mask, *args))
    row["dkv_ms"] = time_ms(lambda: fa._launch_bwd_dkv(q, k, v, mask, go, lse, delta, *args))
    row["dq_ms"] = time_ms(lambda: fa._launch_bwd_dq(q, k, v, mask, go, lse, delta, *args))
    row["plain_fwd_ms"] = time_ms(
        lambda: fa.flash_attention_reference(q, k, v, mask, heads, **kw), samples=3,
        per_sample=3)
    row["plain_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, mask, go, heads, out=out, lse=lse, **kw), samples=3, per_sample=3)
    for kernel in ("fwd", "dkv", "dq"):
        t_bytes, t_ops = (1e3 * t for t in bounds_mla.flash_bound_s(
            kernel, b, heads, n, n, d, dv, True, "bfloat16"))
        row[f"{kernel}_bytes_ms"], row[f"{kernel}_operations_ms"] = t_bytes, t_ops
        row[f"{kernel}_bound_ms"] = max(t_bytes, t_ops)
        row[f"{kernel}_bound_by"] = bound_by(t_bytes, t_ops)
    del q, k, v, go, out, lse, delta
    torch.cuda.empty_cache()

    batch = train_batch(device, b=b, seed=8)
    batch["input_ids"] = batch["input_ids"] % KIMI_WORD_ROWS
    held_before = torch.cuda.memory_allocated() / 1e9  # what earlier phases still hold
    with torch.device(device):
        model = create_model("KimiVLKGC", vocab_size=KIMI_VOCAB, dtype="bfloat16")
    model.init_params(torch.Generator(device=device).manual_seed(0))
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(alpha=0.45, seed=3),
                          device=device)
    opt = make_optimizer(model, 1e-4, 100, warmup_ratio=0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fa.WIDTH_LAUNCHES_FLASH.clear()
    kimi_vl.TOKENS_ROUTED_HELD = kimi_vl.MOE_CALLS = kimi_vl.GROUPED_PRODUCTS = 0
    losses, times = [], []
    t0 = time.perf_counter()
    losses.append(trainer._train_step(opt, batch, 0)["loss"].item())
    times.append((time.perf_counter() - t0) * 1e3)
    counts = all_counts()
    widths = {f"{kernel}{route}_d{w}": fa.WIDTH_LAUNCHES_FLASH[suffix, w]
              for w in (d, 64) for kernel, route, suffix in (
                  ("fwd", "", ""), ("dkv", "", "_DKV"), ("dq", "", "_DQ"),
                  ("fwd", "_mma", "_FWD_MMA"), ("dkv", "_mma", "_DKV_MMA"),
                  ("dq", "_mma", "_DQ_MMA"))}
    moe = dict(moe_calls=kimi_vl.MOE_CALLS, grouped_products=kimi_vl.GROUPED_PRODUCTS)
    want = family_counts("flash", KIMI_LAYERS + KIMI_VISION_CALLS, gelu=1)
    want_widths = {name: KIMI_LAYERS if name.endswith(f"_d{d}") else KIMI_VISION_CALLS
                   for name in widths}
    want_moe = dict(moe_calls=KIMI_LAYERS - 1, grouped_products=6 * (KIMI_LAYERS - 1))
    if counts != want or widths != want_widths or moe != want_moe:
        raise AssertionError(f"kimi_vl step: launches {counts}, widths {widths}, {moe}; want "
                             f"{want}, {want_widths}, {want_moe}")
    routed = kimi_vl.TOKENS_ROUTED_HELD / kimi_vl.MOE_CALLS
    for step in range(1, 8):
        t0 = time.perf_counter()
        losses.append(trainer._train_step(opt, batch, step)["loss"].item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"kimi_vl steps: losses {losses}")
    if aw.LAUNCHES_ADAMW != len(losses):
        raise AssertionError(f"kimi_vl steps: {aw.LAUNCHES_ADAMW} AdamW launches in "
                             f"{len(losses)} steps")
    peak = torch.cuda.max_memory_allocated() / 1e9
    profile = device_profile(lambda: trainer._train_step(opt, batch, 8))
    step = dict(B=b, L=128, launches=counts, width_launches=widths, **moe,
                adamw_launches=len(losses), routed_rows_per_layer=routed,
                expected_rows_per_layer=b * (c["images"] + c["text"]) * 6 * 8 / 64,
                losses=losses, step_ms=times, median_step_ms=statistics.median(times[2:]),
                peak_gb=peak, held_before_gb=held_before, device_ms=profile["device_ms"],
                attention_ms=profile["attention_ms"], device_profile_top=profile["top"])
    del model, trainer, opt, batch
    torch.cuda.empty_cache()
    emit(dict(phase="kimi_vl", mla=row, step=step))
    return row, dict(counts, **widths), step["adamw_launches"]


# The single-block attention shapes of the region families (the recipes of
# scripts/run_finetune_vilbert.sh and run_finetune_visualbert.sh: B=64, L=128,
# 2 images x 36 regions of 2048): (name, B, Lq, Lk, heads, head_dim, analogy
# geometry or None as (row_start, text_len, offset), key layout, launches
# per forward). ViLBERT's visual stream attends over the 72 regions at
# head_dim 128 (1024 wide, 8 heads), its text stream over 128 tokens with
# the multiplier from row 1; VisualBERT over 128 text + 72 region tokens,
# the multiplier over the text block from row 1. Then the head_dim-128
# kernels at ragged lengths (Lk 1, 37 and 130). Key layouts: "regions" 72
# region keys, a quarter of the batch rows missing their second image (36
# masked) and a quarter both (all 72 masked, as the trainer's region gather
# builds them); "text" 128 text keys padded to 40-128; "text_regions" both;
# "ragged" the last keys of batch row 0 padded, every key of row 1 masked.
REGION_SHAPES = [
    ("vilbert_visual", 64, 72, 72, 8, 128, None, "regions", 6),
    ("vilbert_text", 64, 128, 128, 12, 64, (1, None, 0), "text", 12),
    ("visualbert", 64, 200, 200, 12, 64, (1, 128, 0), "text_regions", 12),
    ("d128_ragged_72x1", 4, 72, 1, 8, 128, None, "ragged", 0),
    ("d128_ragged_37", 4, 37, 37, 8, 128, (1, None, 0), "ragged", 0),
    ("d128_ragged_130", 4, 130, 130, 8, 128, None, "ragged", 0),
]


def region_mask(b, n_regions=72):
    """(B, 72) region mask of the trainer's gather: batch rows 1, 5, ...
    miss their second image, rows 2, 6, ... both."""
    import torch

    mask = torch.ones(b, n_regions)
    rows = torch.arange(b)
    mask[(rows % 4 == 1)[:, None] & (torch.arange(n_regions) >= n_regions // 2)[None]] = 0.0
    mask[rows % 4 == 2] = 0.0
    return mask


def region_attention_inputs(shape, dtype, device, seed):
    """(q, k, v, g, mask, geometry keywords) of a REGION_SHAPES entry."""
    import torch

    _, b, lq, lk, heads, head_dim, geometry, layout, _ = shape
    gen = torch.Generator().manual_seed(seed)
    hd = heads * head_dim
    q, g = (torch.randn(b, lq, hd, generator=gen).to(device, dtype) for _ in range(2))
    k, v = (torch.randn(b, lk, hd, generator=gen).to(device, dtype) for _ in range(2))
    text_len = torch.randint(40, TEXT_LEN + 1, (b,), generator=gen)
    text_mask = (torch.arange(TEXT_LEN)[None] < text_len[:, None]).float()
    if layout == "regions":
        mask = region_mask(b)
    elif layout == "text":
        mask = text_mask
    elif layout == "text_regions":
        mask = torch.cat([text_mask, region_mask(b)], dim=1)
    else:
        mask = torch.ones(b, lk)
        mask[0, lk - lk // 4:] = 0.0
        mask[1] = 0.0
    kw = {}
    if geometry is not None:
        row_start, geo_len, offset = geometry
        kw = dict(boundary=(text_len // 2).clamp(max=lq - 1).to(device, torch.int32),
                  w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device),
                  row_start=row_start, text_len=geo_len, offset=offset)
    return q, k, v, g, mask.to(device), kw


def region_kernel_phase(device):
    """Rows 1-2 at the region families' shapes (REGION_SHAPES), above all
    the head_dim-128 instantiations of all four kernels (fp32 CUDA-core,
    bf16 tensor-core, forward and backward) at ViLBERT's visual stream, B=64,
    72 x 72, 8 heads of 128, with a quarter of the rows' keys half masked and
    a quarter's all masked; fp32 and bf16, dropout 0 and 0.1 (the same
    seed, so the masks must agree), at the bars of rows 1-2: the forward
    within 2e-5 fp32 / 2e-2 bf16 absolute, the backward within 2e-5 fp32 /
    2^-7 bf16 of each result's largest |value|, dw within 1e-5 of its sum of
    |terms|. Every head_dim-128 launch must be counted as one. Then per
    shape, bf16: the kernels' times, the plain versions', SDPA's where no
    multiplier applies (forward, and its backward as forward-plus-backward
    minus forward), the bounds; and what ptxas said of the head_dim-128
    instantiations."""
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import build

    rows, masked_fp32 = [], {}
    for shape in REGION_SHAPES:
        name, b, lq, lk, heads, head_dim, geometry, layout, per_fwd = shape
        row = dict(shape=name, B=b, Lq=lq, Lk=lk, heads=heads, head_dim=head_dim,
                   geometry=geometry, keys=layout, launches_per_forward=per_fwd)
        for tag, dtype, fwd_bar, bwd_bar in (("fp32", torch.float32, 2e-5, 2e-5),
                                             ("bf16", torch.bfloat16, 2e-2, 2.0 ** -7)):
            for rate in (0.0, 0.1):
                key = f"{tag}{'_dropout' if rate else ''}"
                q, k, v, g, mask, kw = region_attention_inputs(shape, dtype, device, lq + lk)
                call = dict(kw, compute_dtype=dtype, dropout_rate=rate,
                            deterministic=rate == 0.0, dropout_seed=77)
                before = (attn.LAUNCHES, attn.LAUNCHES_D128, attn.LAUNCHES_BWD_D128)
                got = attn.fused_attention(q, k, v, mask, heads, **call)
                want = attn.fused_attention_reference(q, k, v, mask, heads, **call)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                row[f"fwd_max_abs_err_{key}"] = err
                if not err <= fwd_bar:
                    raise AssertionError(f"{name} {key}: forward kernel vs plain {err} > "
                                         f"{fwd_bar}")
                errs = bwd_errors(attn, f"{name} {key}", key, q, k, v, mask, g, call, rate, 77,
                                  bwd_bar, heads=heads)
                row.update(errs)
                d128 = int(head_dim == 128)
                after = (attn.LAUNCHES, attn.LAUNCHES_D128, attn.LAUNCHES_BWD_D128)
                if after != (before[0] + 1, before[1] + d128, before[2] + d128):
                    raise AssertionError(f"{name} {key}: launches {before} -> {after}")
                if tag == "fp32" and head_dim == 128:
                    # the fp32 all-masked-row check at head_dim 128
                    masked_fp32[f"{name}_{key}_fwd"] = err
                    masked_fp32.update({f"{name}_{n}": e for n, e in errs.items()
                                        if n.startswith("max_abs_err")})
        q, k, v, g, mask, kw = region_attention_inputs(shape, torch.bfloat16, device, 7)
        fwd_kw = dict(kw, compute_dtype=torch.bfloat16)
        row["kernel_ms"] = time_ms(lambda: attn.fused_attention(q, k, v, mask, heads, **fwd_kw))
        row["plain_ms"] = time_ms(
            lambda: attn.fused_attention_reference(q, k, v, mask, heads, **fwd_kw))
        rate = 0.1 if per_fwd else 0.0  # the training shapes train with attention dropout
        bwd_kw = dict(fwd_kw, dropout_rate=rate, deterministic=rate == 0.0, dropout_seed=99)
        resolved = resolve_geometry(attn, q, bwd_kw, rate, 99)
        row["bwd_kernel_ms"] = time_ms(
            lambda: attn._launch_bwd(q, k, v, mask, g, heads, *resolved))
        row["bwd_plain_ms"] = time_ms(
            lambda: attn.fused_attention_bwd_reference(q, k, v, mask, g, heads, **bwd_kw))
        row["library_ms"] = row["bwd_library_ms"] = None
        if geometry is None:
            def split(x):
                return x.view(b, x.shape[1], heads, head_dim).transpose(1, 2)

            qh, kh, vh = (split(x).detach().requires_grad_(True) for x in (q, k, v))
            gh = split(g)
            bias = ((1.0 - mask) * -10000.0).to(torch.bfloat16)[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(), (qh, kh, vh), gh)

            want = attn.fused_attention_reference(q, k, v, mask, heads, **fwd_kw)
            lib = sdpa().transpose(1, 2).reshape(want.shape)
            row["library_max_abs_err_bf16"] = (lib.float() - want.float()).abs().max().item()
            row["library_ms"] = time_ms(sdpa)
            row["bwd_library_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
            row["bwd_library_ms"] = row["bwd_library_fwd_bwd_ms"] - row["library_ms"]
        row["bytes_ms"], row["operations_ms"] = bound_times(b, lq, lk, 2, heads, head_dim)
        row["bound_ms"] = max(row["bytes_ms"], row["operations_ms"])
        row["bound_by"] = bound_by(row["bytes_ms"], row["operations_ms"])
        row["bwd_bytes_ms"], row["bwd_operations_ms"] = bwd_bound_times(b, lq, lk, 2, heads,
                                                                       head_dim)
        row["bwd_bound_ms"] = max(row["bwd_bytes_ms"], row["bwd_operations_ms"])
        row["bwd_bound_by"] = bound_by(row["bwd_bytes_ms"], row["bwd_operations_ms"])
        rows.append(row)
        emit(dict(phase="region_kernel", **row))
    resources = {name: [r for r in build.resource_usage(name) if "Li128E" in r["entry"]]
                 for name in ("fused_attention_fwd_mma", "fused_attention_bwd_mma",
                              "fused_attention_fwd", "fused_attention_bwd")}
    emit(dict(phase="fp32_masked_rows", dtype="float32", head_dim=128, single=masked_fp32,
              resources_d128=resources))
    return rows, max(masked_fp32.values())


# The flash kernels at head_dim 128 (8 heads of 128: ViLBERT's visual stream
# through --fused_attention flash): (name, B, Lq, Lk, key layout, geometry
# or None as (row_start, text_len, offset), launches per ViLBERT step:
# forward, backward). ViLBERT's 72 x 72 (a quarter of the rows missing one
# image, a quarter both: rows whose keys are all masked), the same with the
# analogy geometry (the two-rounding score of ScoreRule<128>), two Q tiles,
# a ragged second K tile and L=2048 (8 x 4 logical tiles, streamed,
# operations-bound).
FLASH_D128_HEADS = 8
FLASH_D128_SHAPES = [
    ("vilbert_visual", 64, 72, 72, "regions", None, (6, 5)),
    ("visual_geometry", 64, 72, 72, "regions", (1, None, 0), (0, 0)),
    ("two_q_tiles", 8, 512, 512, "text", None, (0, 0)),
    ("ragged_k", 8, 99, 611, "text", None, (0, 0)),
    ("attention_2048", 8, 2048, 2048, "vision", None, (0, 0)),
]
FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores


def flash_d128_inputs(shape, dtype, device, seed):
    """q, k, v, a cotangent, the (B, Lk) mask and the geometry keywords of a
    FLASH_D128_SHAPES entry: "regions" the trainer's region mask (72 keys),
    "text" keys padded to a random 40-100% of Lk, "vision" none padded."""
    import torch

    _, b, lq, lk, layout, geometry, _ = shape
    gen = torch.Generator().manual_seed(seed)
    hd = FLASH_D128_HEADS * 128
    q, k, v, go = (torch.randn(b, n, hd, generator=gen).to(device, dtype)
                   for n in (lq, lk, lk, lq))
    lens = torch.randint(int(0.4 * lk), lk + 1, (b,), generator=gen)
    if layout == "regions":
        mask = region_mask(b, lk)
    elif layout == "text":
        mask = (torch.arange(lk)[None] < lens[:, None]).float()
    else:
        mask = torch.ones(b, lk)
    kw = {}
    if geometry is not None:
        row_start, geo_len, offset = geometry
        kw = dict(boundary=(lens // 2).clamp(max=lq - 1).to(device, torch.int32),
                  w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device),
                  row_start=row_start, text_len=geo_len, offset=offset)
    return q, k, v, go, mask.to(device), kw


def flash_d128_counts():
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    return {f"{k}_d128": getattr(fa, f"LAUNCHES_FLASH{n}_D128")
            for k, n in (("fwd", ""), ("dkv", "_DKV"), ("dq", "_DQ"), ("fwd_mma", "_FWD_MMA"),
                         ("dkv_mma", "_DKV_MMA"), ("dq_mma", "_DQ_MMA"))}


def flash_d128_kernel_phase(device):
    """The six head_dim-128 instances of the flash kernels (forward, dK/dV
    and dQ; fp32 on the CUDA cores, bf16 on the tensor cores) against their
    plain versions at FLASH_D128_SHAPES, 8 heads of 128, dropout 0 and 0.1
    (the same seed, so the masks must agree), at the bars of the head_dim-64
    flash kernels (flash_kernel_phase): forward 2e-5 fp32 / 2e-2 bf16
    absolute, lse 1e-5 (two fp32 ulps at -1e4 on rows whose keys are all
    masked), dq, dk and dv 2e-5 fp32 / 2^-7 bf16 of each result's largest
    |value|, dw 1e-5 of its sum of |terms|. Every launch must be counted in
    its ``_D128`` count, the tensor-core ones in bf16 alone. Then per shape
    the times of the six instances, the plain forward and backward (bf16),
    SDPA's forward and backward (forward-and-backward minus forward) with
    the padding mask as a bias where no multiplier applies, the bounds of
    each dtype (bf16 operations over the tensor cores' peak, fp32 over the
    CUDA cores'), and what ptxas said of the head_dim-128 instances."""
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.kernels import build
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    heads = FLASH_D128_HEADS
    rows, masked = [], {}
    for shape in FLASH_D128_SHAPES:
        name, b, lq, lk, layout, geometry, per_step = shape
        row = dict(shape=name, B=b, Lq=lq, Lk=lk, heads=heads, head_dim=128,
                   geometry=geometry, keys=layout, launches_per_vilbert_step=list(per_step),
                   tiles=list(fa._blocks(lq, lk, fa.BLOCK_Q, fa.BLOCK_K)))
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for rate in (0.0, 0.1):
                key = f"{tag}{'_dropout' if rate else ''}"
                q, k, v, go, mask, kw = flash_d128_inputs(shape, dtype, device, lq + lk)
                kw = dict(kw, compute_dtype=dtype, dropout_rate=rate,
                          deterministic=rate == 0.0, dropout_seed=4321)
                args = (heads, *resolve_geometry(fa, q, kw, rate, 4321),
                        fa.BLOCK_Q, fa.BLOCK_K)
                before = flash_d128_counts()
                out, lse = fa._launch_fwd(q, k, v, mask, *args)
                delta = fa._delta(go, out, heads)
                got = fa._launch_bwd(q, k, v, mask, go, lse, delta, *args)
                mma = int(dtype == torch.bfloat16)
                want_counts = {c: n + (mma if "mma" in c else 1) for c, n in before.items()}
                if flash_d128_counts() != want_counts:
                    raise AssertionError(f"flash d128 {name} {key}: launches {before} -> "
                                         f"{flash_d128_counts()}")
                want_out, want_lse = fa._plain_fwd(q, k, v, mask, *args[:6], dtype, *args[6:])
                want = fa.flash_attention_bwd_reference(q, k, v, mask, go, heads, out=out,
                                                        lse=lse, **kw)
                torch.cuda.synchronize()
                err = (out.float() - want_out.float()).abs().max().item()
                keys = mask.any(dim=1)
                lse_err = (lse[keys] - want_lse[keys]).abs().max().item()
                lse_err_masked = ((lse[~keys] - want_lse[~keys]).abs().max().item()
                                  if (~keys).any() else 0.0)
                row[f"fwd_max_abs_err_{key}"] = err
                row[f"lse_max_abs_err_{key}"] = lse_err
                row[f"lse_max_abs_err_masked_rows_{key}"] = lse_err_masked
                bar = 2e-5 if dtype == torch.float32 else 2e-2
                if not (err <= bar and lse_err <= 1e-5 and lse_err_masked <= 2.0 ** -9):
                    raise AssertionError(f"flash d128 fwd {name} {key}: out {err} > {bar} or "
                                         f"lse {lse_err} > 1e-5 or {lse_err_masked} > 2^-9")
                bar = 2e-5 if dtype == torch.float32 else 2.0 ** -7
                for t_name, a, c in zip(("dq", "dk", "dv"), got[:3], want[:3]):
                    err = (a.float() - c.float()).abs().max().item()
                    top = c.float().abs().max().item()
                    row[f"max_abs_err_{t_name}_{key}"] = err
                    if not (math.isfinite(err) and err <= bar * top):
                        raise AssertionError(f"flash d128 bwd {name} {key} {t_name}: {err} > "
                                             f"{bar} * {top}")
                if geometry is not None:
                    scales = flash_dw_scales(fa, q, k, v, mask, go, lse, delta, *args[1:6],
                                             heads=heads, head_dim=128)
                    for i in range(2):
                        err = abs(got[3][i].item() - want[3][i].item())
                        row[f"dw{i}_err_{key}"] = err
                        if not err <= 1e-5 * scales[i]:
                            raise AssertionError(f"flash d128 bwd {name} {key} dw{i}: {err} "
                                                 f"> 1e-5 * {scales[i]}")
                elif got[3].abs().max().item() != 0.0:
                    raise AssertionError(f"flash d128 bwd {name}: dw without a geometry")
                if tag == "fp32" and not keys.all():
                    masked.update({f"{name}_{n}": e for n, e in row.items() if n.endswith(key)
                                   and n.startswith(("fwd_max_abs_err", "max_abs_err"))})
                del q, k, v, go, out, lse, delta, got, want, want_out
        n = dict(samples=5, per_sample=3) if lq >= 2048 else {}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            rate = 0.1 if layout == "regions" else 0.0  # the visual stream trains with dropout
            q, k, v, go, mask, kw = flash_d128_inputs(shape, dtype, device, seed=7)
            kw = dict(kw, compute_dtype=dtype, dropout_rate=rate,
                      deterministic=rate == 0.0, dropout_seed=99)
            args = (heads, *resolve_geometry(fa, q, kw, rate, 99), fa.BLOCK_Q, fa.BLOCK_K)
            out, lse = fa._launch_fwd(q, k, v, mask, *args)
            delta = fa._delta(go, out, heads)
            sfx = "" if tag == "bf16" else "_fp32"
            row[f"fwd_ms{sfx}"] = time_ms(lambda: fa._launch_fwd(q, k, v, mask, *args), **n)
            row[f"dkv_ms{sfx}"] = time_ms(lambda: fa._launch_bwd_dkv(
                q, k, v, mask, go, lse, delta, *args), **n)
            row[f"dq_ms{sfx}"] = time_ms(lambda: fa._launch_bwd_dq(
                q, k, v, mask, go, lse, delta, *args), **n)
            for kernel in ("fwd", "dkv", "dq"):
                t_bytes, t_ops = flash_bound_times(
                    kernel, b, lq, lk, 2 if tag == "bf16" else 4, heads=heads, head_dim=128,
                    flops_per_s=BF16_FLOPS_PER_S if tag == "bf16" else FP32_FLOPS_PER_S)
                row[f"{kernel}_bytes_ms{sfx}"], row[f"{kernel}_operations_ms{sfx}"] = (
                    t_bytes, t_ops)
                row[f"{kernel}_bound_ms{sfx}"] = max(t_bytes, t_ops)
                row[f"{kernel}_bound_by{sfx}"] = bound_by(t_bytes, t_ops)
            if tag == "fp32":
                continue
            row["fwd_design"] = ("resident" if row["tiles"][3] == 1 and lk <= 128
                                 else "streaming")
            row["plain_fwd_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, mask, heads, **kw), **n)
            row["plain_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_reference(
                q, k, v, mask, go, heads, out=out, lse=lse, **kw), **n)
            row["library_fwd_ms"] = row["library_bwd_ms"] = None
            if geometry is not None:
                row["library_note"] = "no single PyTorch call applies the analogy multiplier"
            else:
                def split(x):
                    return x.view(b, x.shape[1], heads, 128).transpose(1, 2)

                qh, kh, vh = (split(x).detach().requires_grad_(True) for x in (q, k, v))
                gh = split(go)
                bias = None
                if layout != "vision":
                    bias = ((1.0 - mask) * -10000.0).to(torch.bfloat16)[:, None, None, :]

                def sdpa():
                    return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                          dropout_p=0.0)

                def sdpa_fwd_bwd():
                    torch.autograd.grad(sdpa(), (qh, kh, vh), gh)

                row["library_fwd_ms"] = time_ms(sdpa, **n)
                row["library_bwd_ms"] = time_ms(sdpa_fwd_bwd, **n) - row["library_fwd_ms"]
                row["library_note"] = ("SDPA without dropout" + (" with the padding mask as "
                                       "a bias" if bias is not None else ""))
            del q, k, v, go, out, lse, delta
        rows.append(row)
        emit(dict(phase="flash_d128_kernel", **row))
        torch.cuda.empty_cache()
    resources = {name: [r for r in build.resource_usage(name) if "Li128E" in r["entry"]]
                 for name in ("flash_attention_fwd_mma", "flash_attention_bwd_mma",
                              "flash_attention_fwd", "flash_attention_bwd")}
    emit(dict(phase="flash_d128_resources", resources_d128=resources,
              fp32_masked_rows=masked))
    return rows, max(masked.values())


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
    """Launches of the tensor-core (bf16) flash kernels alone; the counts of
    flash_counts take either route."""
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    return dict(fwd=fa.LAUNCHES_FLASH_FWD_MMA, dkv=fa.LAUNCHES_FLASH_DKV_MMA,
                dq=fa.LAUNCHES_FLASH_DQ_MMA)


def reset_counts():
    from mkg_analogy_tpu_torch.kernels import adamw as aw
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa
    from mkg_analogy_tpu_torch.kernels import gelu_poly as gp
    from mkg_analogy_tpu_torch.kernels import image_prep as ip

    gp.LAUNCHES_GELU_FWD = gp.LAUNCHES_GELU_BWD = 0
    aw.LAUNCHES_ADAMW = 0
    attn.LAUNCHES = attn.LAUNCHES_BWD = 0
    attn.LAUNCHES_D128 = attn.LAUNCHES_BWD_D128 = 0
    fa.LAUNCHES_FLASH = fa.LAUNCHES_FLASH_DKV = fa.LAUNCHES_FLASH_DQ = 0
    fa.LAUNCHES_FLASH_FWD_MMA = fa.LAUNCHES_FLASH_DKV_MMA = fa.LAUNCHES_FLASH_DQ_MMA = 0
    fa.LAUNCHES_FLASH_D128 = fa.LAUNCHES_FLASH_DKV_D128 = fa.LAUNCHES_FLASH_DQ_D128 = 0
    fa.LAUNCHES_FLASH_FWD_MMA_D128 = fa.LAUNCHES_FLASH_DKV_MMA_D128 = 0
    fa.LAUNCHES_FLASH_DQ_MMA_D128 = 0
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
    and falling, 24 forward, 24 dK/dV and 24 dQ launches a step and 13 of
    row 7's each way, the median step over steps 3-8, a device profile of
    one step."""
    import torch

    from mkg_analogy_tpu_torch.kernels import flash_attention as fa
    from mkg_analogy_tpu_torch.kernels import gelu_poly as gp
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
                                                for k, n in flash_mma_counts().items()},
                             gelu_fwd=gp.LAUNCHES_GELU_FWD, gelu_bwd=gp.LAUNCHES_GELU_BWD))
        losses.append(metrics["loss"].item())
    if any(n != dict(fwd=24, dkv=24, dq=24, fwd_mma=24, dkv_mma=24, dq_mma=24,
                     gelu_fwd=GELU_CALLS, gelu_bwd=GELU_CALLS) for n in launches):
        raise AssertionError(f"bf16 pre-train steps: launches {launches}, expected 24 each, "
                             f"all on the tensor cores, and {GELU_CALLS} each way of row 7")
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
                or flash_mma_counts() != dict(fwd=24, dkv=24, dq=24)):
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
    auto = dict(flash_counts(), fwd_mma=flash_mma_counts()["fwd"], single=attn.LAUNCHES)
    if (auto != dict(fwd=12, dkv=0, dq=0, fwd_mma=12, single=0)
            or not torch.isfinite(trans).all()):
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
    set to 0 before each run and read after it, row 7's gelu launches among
    them (13 each way a step, 13 a forward). Then a fine-tune on MARS
    from the triple run's checkpoint (--checkpoint), through the flash
    kernels: 4 steps, dev and test."""
    import numpy as np

    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import gelu_poly as gp
    from mkg_analogy_tpu_torch.train import checkpoint

    def gelu_counts():
        return dict(gelu_fwd=gp.LAUNCHES_GELU_FWD, gelu_bwd=gp.LAUNCHES_GELU_BWD)

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
            before = dict(flash_counts(), **gelu_counts())
            t0 = time.perf_counter()
            metrics = cli.main(argv(out_dir, "--pretrain", "1", "--pretrain_format", fmt,
                                    "--max_seq_length", str(length), "--batch_size", "64",
                                    "--max_epochs", "1", "--limit_train_batches", "3"))
            seconds = time.perf_counter() - t0
            launches = {k: n - before[k]
                        for k, n in dict(flash_counts(), **gelu_counts()).items()}
            n_eval = len(np.load(os.path.join(out_dir, "test_ranks_pretrain.npz"))["ranks"])
            # 3 steps; the dev and the test evaluation on n_eval examples
            forwards = 3 + 2 * math.ceil(n_eval / 128)
            expect = dict(fwd=24 * forwards, dkv=24 * 3, dq=24 * 3,
                          gelu_fwd=GELU_CALLS * forwards, gelu_bwd=GELU_CALLS * 3)
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
        # the main path's launches, all three formats; all on the tensor
        # cores
        total = dict(flash_counts(), **{f"{k}_mma": n for k, n in flash_mma_counts().items()},
                     **gelu_counts())
        if any(total[f"{k}_mma"] != total[k] for k in ("fwd", "dkv", "dq")):
            raise AssertionError(f"cli pretrain: a bf16 launch left the tensor cores: {total}")

        ft_dir = os.path.join(root, "finetune")
        reset_counts()
        metrics = cli.main(argv(ft_dir, "--checkpoint", os.path.join(root, "triple", "ckpt"),
                                "--max_seq_length", "128", "--batch_size", "32",
                                "--max_epochs", "1"))
        launches = dict(flash_counts(), **gelu_counts())
        expect = dict(fwd=24 * (4 + 1 + 2), dkv=24 * 4, dq=24 * 4,
                      gelu_fwd=GELU_CALLS * (4 + 1 + 2), gelu_bwd=GELU_CALLS * 4)
        if (launches != expect or attn.LAUNCHES or attn.LAUNCHES_BWD
                or flash_mma_counts() != dict(fwd=24 * 7, dkv=24 * 4, dq=24 * 4)):
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
            samples=5, per_sample=2)
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
    from mkg_analogy_tpu_torch.kernels import gelu_poly as gp

    return dict(single_fwd=attn.LAUNCHES, single_bwd=attn.LAUNCHES_BWD,
                single_fwd_d128=attn.LAUNCHES_D128, single_bwd_d128=attn.LAUNCHES_BWD_D128,
                **{f"flash_{k}": n for k, n in flash_counts().items()},
                **{f"flash_{k}_mma": n for k, n in flash_mma_counts().items()},
                **{f"flash_{k}": n for k, n in flash_d128_counts().items()},
                gelu_fwd=gp.LAUNCHES_GELU_FWD, gelu_bwd=gp.LAUNCHES_GELU_BWD)


# The two families that read the tool's pixel stores, at the recipes of
# scripts/run_finetune_vilt.sh and scripts/run_finetune_flava.sh (L=128),
# and the two that read region features, at run_finetune_visualbert.sh's
# and run_finetune_vilbert.sh's (B=64, L=128, 2 images x 36 regions of
# 2048). ``calls``: attention calls of one forward (ViLT 12 layers over 128
# + 290 tokens; FLAVA 12 image layers over 393, 12 text layers over 128 and
# 6 multimodal layers over 522; VisualBERT 12 layers over 128 + 72; ViLBERT
# 12 text layers over 128 and 6 visual ones over 72, its cross-attention in
# plain PyTorch), ``d128`` those at head_dim 128 (ViLBERT's visual stream),
# ``unread`` those whose output the loss never reads, so that no backward
# runs for them (ViLBERT's last visual layer, after its last connection
# layer; JAX's jit drops its forward too, the eager port runs it).
# ``auto_flash``: the calls whose query length reaches FLASH_AUTO_MIN_LEN,
# which the plain route sends to the flash kernels. ``gelu``: the gelu_poly
# calls of a bf16 forward (each FFN of the text, image and multimodal layers
# and of ViLBERT's connection layers, and the MLM transform), ``gelu_unread``
# those with no backward (ViLBERT's last visual layer and the image side of
# its last connection layer). ``backend``: the card's
# default (models/registry.py). ``fp32``: the kernels of the fp32 step,
# the family's default as JAX runs it. ``also_flash``: the steps also run
# through the flash kernels, the other route the family could take: the
# fp32 step against the plain attention (ViLBERT, whose calls of 128 and 72
# tokens are each one logical tile with the single block's dropout masks,
# with attention dropout; ViLT, whose 418 query rows the flash kernels
# draw in tiles of 256, without), the bf16 steps timed (and for ViLBERT a
# CLI fit with --fused_attention flash).
FAMILIES = {
    "vilt": dict(model_class="ViltKGC", batch=32, image=384, alpha=0.3, lr=4e-5,
                 stats="vilt", backend="single", calls=12, auto_flash=0, fp32="single",
                 also_flash=True, gelu=13),
    "flava": dict(model_class="FlavaKGC", batch=24, image=224, alpha=0.45, lr=5e-5,
                  stats="clip", backend="flash", calls=30, auto_flash=6, fp32="flash",
                  gelu=31),
}
REGION_FAMILIES = {
    "visualbert": dict(model_class="VisualBertKGC", batch=64, image=None, alpha=0.43,
                       lr=5e-5, backend="single", calls=12, auto_flash=0, fp32="single",
                       gelu=13),
    "vilbert": dict(model_class="VilBertKGC", batch=64, image=None, alpha=0.43, lr=5e-5,
                    backend="single", calls=18, d128=6, unread=1, auto_flash=0,
                    fp32="single", also_flash=True, flash_same_masks=True, gelu=31,
                    gelu_unread=2),
}


def fp32_step_cost(device, name="vilt", steps=5):
    """What a full-width fp32 fine-tune step of a family costs through its
    default fp32 attention (ViLT: the single-block kernels over its 418
    tokens), from random weights (seed 0), one batch, dropout on, AdamW:
    the host ms of each synchronised step, their median after the first,
    the device ms of one profiled step, the attention kernels' device ms and
    their share of it. tools/time_attention.py --fp32_step runs it on any
    checkout, to compare two."""
    import torch

    from mkg_analogy_tpu_torch.models.registry import create_model
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    fam = {**FAMILIES, **REGION_FAMILIES}[name]
    b = fam["batch"]
    batch = train_batch(device, b=b, seed=6)
    g = torch.Generator().manual_seed(7)
    batch["pixel_values"] = torch.randn(b, 2, 3, fam["image"], fam["image"],
                                        generator=g).to(device)
    with torch.device(device):
        model = create_model(fam["model_class"], vocab_size=42112, dtype="float32",
                             attention=fam["fp32"])
    model.init_params(torch.Generator(device=device).manual_seed(0))
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(alpha=fam["alpha"], seed=3),
                          device=device)
    opt = make_optimizer(model, 1e-4, 100, warmup_ratio=0.0)
    times, losses = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        metrics = trainer._train_step(opt, batch, step)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name} fp32 steps: losses {losses}")
    profile = device_profile(lambda: trainer._train_step(opt, batch, steps), top=8)
    del model, trainer, opt
    torch.cuda.empty_cache()
    return dict(route=fam["fp32"], B=b, step_ms=times, median_step_ms=statistics.median(times[1:]),
                device_ms=profile["device_ms"], attention_ms=profile["attention_ms"],
                attention_share=profile["attention_ms"] / profile["device_ms"],
                losses=losses, device_profile_top=profile["top"])


def family_kw(fam):
    """family_counts' keywords for a family of FAMILIES or REGION_FAMILIES."""
    return {k: fam.get(k, 0) for k in ("d128", "unread", "gelu", "gelu_unread")}


def family_counts(backend, calls, backward=True, bf16=True, d128=0, unread=0, gelu=0,
                  gelu_unread=0):
    """all_counts of a step (or a forward) through ``backend``; in bf16 the
    flash kernels run on the tensor cores and each of a forward's ``gelu``
    calls launches row 7's kernel (fp32 takes F.gelu); ``d128`` of the calls
    are at head_dim 128, ``unread`` of those and ``gelu_unread`` of the gelu
    calls have no backward."""
    n_b = calls - unread if backward else 0
    d128_b = d128 - unread if backward else 0
    zero = dict(single_fwd=0, single_bwd=0, single_fwd_d128=0, single_bwd_d128=0,
                **{f"flash_{k}{m}{w}": 0 for k in ("fwd", "dkv", "dq") for m in ("", "_mma")
                   for w in ("", "_d128")},
                gelu_fwd=gelu if bf16 else 0,
                gelu_bwd=gelu - gelu_unread if bf16 and backward else 0)
    if backend == "single":
        return dict(zero, single_fwd=calls, single_bwd=n_b, single_fwd_d128=d128,
                    single_bwd_d128=d128_b)
    mma = int(bf16)
    return dict(zero, flash_fwd=calls, flash_dkv=n_b, flash_dq=n_b,
                flash_fwd_mma=calls * mma, flash_dkv_mma=n_b * mma, flash_dq_mma=n_b * mma,
                flash_fwd_d128=d128, flash_dkv_d128=d128_b, flash_dq_d128=d128_b,
                flash_fwd_mma_d128=d128 * mma, flash_dkv_mma_d128=d128_b * mma,
                flash_dq_mma_d128=d128_b * mma)


def family_phase(device, name):
    """A full-width fine-tune step of a family other than MKGformer at its
    recipe's batch, L=128, dropout on. For VisualBERT and ViLBERT (region
    features, a quarter of the rows missing one image and a quarter both):
    (1) fp32, from one state dict, batch and seeds, through the
    single-block kernels (ViLBERT's visual stream at head_dim 128) and
    through the plain attention under autograd, which draws the same
    attention dropout masks from the same seeds. Gates: the loss within
    1e-5 relative; each gradient leaf within 1e-3 of that leaf's largest
    |gradient| plus 1e-6 of the model's largest; no gradient only where the
    loss reads nothing (ViLBERT's visual stream after its last connection
    layer). ViLT likewise, through the single-block kernels over its 418
    tokens (the fp32 ones sweep them in key tiles), as JAX runs it. For FLAVA:
    (1) fp32, from one state dict, batch and seeds, through the flash
    kernels (its default) and through autograd of the kernels' plain
    version. Gates: the loss within 1e-5 relative; each gradient leaf
    within 1e-3 of that leaf's largest |gradient| plus 1e-6 of the model's
    largest. Then, for FLAVA and ViLT, with the attention dropout off and
    the hidden dropout on, through the flash kernels and through the plain
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
    418 tokens could take. ViLBERT's launches at head_dim 128 are counted
    apart (6 of its 18 a step, each way)."""
    import torch

    from mkg_analogy_tpu_torch.kernels import flash_attention as fa
    from mkg_analogy_tpu_torch.models import common
    from mkg_analogy_tpu_torch.models.common import DropoutRNG
    from mkg_analogy_tpu_torch.models.registry import create_model
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig, finetune_positions

    fam = {**FAMILIES, **REGION_FAMILIES}[name]
    b, calls = fam["batch"], fam["calls"]
    counts_kw = family_kw(fam)
    batch = train_batch(device, b=b, seed=6)
    g = torch.Generator().manual_seed(7)
    if fam["image"] is None:  # region features
        batch["pixel_values"] = torch.randn(b, 72, 2048, generator=g).to(device)
        batch["visual_attention_mask"] = region_mask(b).to(device)
    else:
        batch["pixel_values"] = torch.randn(b, 2, 3, fam["image"], fam["image"],
                                            generator=g).to(device)
    out = {}
    with torch.device(device):
        model = create_model(fam["model_class"], vocab_size=42112, dtype="float32",
                             attention=fam["fp32"])
    model.init_params(torch.Generator(device=device).manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(alpha=fam["alpha"]),
                          device=device)
    runs = {}
    common.ATTENTION_BACKENDS["flash_plain"] = fa.flash_attention_reference
    try:
        # (run, backend, attention dropout, route and launches of each kind)
        if fam["fp32"] == "single":
            plan = (("kernels", "single", 0.1, ("single", calls)),
                    ("plain", "plain", 0.1, ("single", 0)))
            pairs = (("kernels", "plain"),)
            if fam.get("flash_same_masks"):
                # every call of L=128 and 72 is one logical tile, whose
                # dropout seed is the single block's: the same masks
                plan += (("flash", "flash", 0.1, ("flash", calls)),)
                pairs += (("flash", "plain"),)
            elif fam.get("also_flash"):
                plan += (("flash_nodrop", "flash", 0.0, ("flash", calls)),
                         ("plain_nodrop", "plain", 0.0, ("flash", fam["auto_flash"])))
                pairs += (("flash_nodrop", "plain_nodrop"),)
        else:
            plan = (("kernels", "flash", 0.1, ("flash", calls)),
                    ("flash_plain", "flash_plain", 0.1, ("flash", 0)),
                    ("flash_nodrop", "flash", 0.0, ("flash", calls)),
                    ("plain_nodrop", "plain", 0.0, ("flash", fam["auto_flash"])))
            pairs = (("kernels", "flash_plain"), ("flash_nodrop", "plain_nodrop"))
        for run, backend, rate, (route, n) in plan:
            model.load_state_dict(state)
            for m in model.modules():
                if isinstance(m, common.AttentionCore):
                    m.backend, m.dropout_rate = backend, rate
            model.zero_grad(set_to_none=True)
            reset_counts()
            loss, _ = trainer._finetune_loss(batch, DropoutRNG.from_seed(5, device))
            loss.backward()
            torch.cuda.synchronize()
            expect = family_counts(route, n, bf16=False, **(counts_kw if n else {}))
            if all_counts() != expect:
                raise AssertionError(f"{name} fp32 step {run}: launches {all_counts()}, "
                                     f"expected {expect}")
            runs[run] = (loss.item(), {k: None if p.grad is None else p.grad.clone()
                                       for k, p in model.named_parameters()})
    finally:
        del common.ATTENTION_BACKENDS["flash_plain"]
    for got, ref in pairs:
        a, c = runs[got][0], runs[ref][0]
        if not (math.isfinite(a) and abs(a - c) <= 1e-5 * abs(c)):
            raise AssertionError(f"{name} fp32 loss: {got} {a} vs {ref} {c}")
    worst, worst_name = leaf_ratios(runs["kernels"][1], runs[pairs[0][1]][1])
    if not worst <= 1.0:
        raise AssertionError(f"{name} fp32 grad {worst_name}: kernels vs {pairs[0][1]} "
                             f"at {worst} of the bar")
    no_grad = sorted(k for k, g in runs["kernels"][1].items() if g is None)
    # ViLBERT's visual stream after its last connection layer feeds nothing
    # the loss reads
    last = len(getattr(model.cfg, "v_biattention_id", ())) - 1
    unread = (f"v_layer_{last}.", f"c_layer_{last}.img_")
    if any(not (name == "vilbert" and k.startswith(unread)) for k in no_grad):
        raise AssertionError(f"{name} fp32 step: no gradient reached {no_grad}")
    out["fp32"] = dict(
        route=fam["fp32"], loss_kernels=runs["kernels"][0],
        loss_reference=runs[pairs[0][1]][0], reference=pairs[0][1],
        loss_rel_diff=abs(runs["kernels"][0] - runs[pairs[0][1]][0]) / abs(
            runs[pairs[0][1]][0]),
        grad_leaves=len(runs["kernels"][1]), leaves_without_gradient=len(no_grad),
        worst_err_over_bar=worst, worst_leaf=worst_name,
        launches=family_counts(fam["fp32"], calls, bf16=False, **counts_kw))
    if "flash" in runs:
        worst_flash, worst_flash_name = leaf_ratios(runs["flash"][1], runs["plain"][1])
        if not worst_flash <= 1.0:
            raise AssertionError(f"{name} fp32 grad {worst_flash_name}: flash vs plain at "
                                 f"{worst_flash} of the bar")
        out["fp32"]["through_flash"] = dict(
            loss_kernels=runs["flash"][0], loss_reference=runs["plain"][0],
            loss_rel_diff=abs(runs["flash"][0] - runs["plain"][0]) / abs(runs["plain"][0]),
            worst_err_over_bar=worst_flash, worst_leaf=worst_flash_name,
            launches=family_counts("flash", calls, bf16=False, **counts_kw))
    if "flash_nodrop" in runs:
        lk, lp = runs["flash_nodrop"][0], runs["plain_nodrop"][0]
        out["fp32"].update(
            loss_kernels_no_attention_dropout=lk, loss_plain_attention_no_attention_dropout=lp,
            loss_rel_diff_plain_attention=abs(lk - lp) / abs(lp),
            worst_err_over_bar_vs_plain_attention=leaf_ratios(runs["flash_nodrop"][1],
                                                              runs["plain_nodrop"][1]))
    del runs, model, trainer
    torch.cuda.empty_cache()
    if name in FAMILIES:
        # what the fp32 step costs through the family's default kernels
        # (ViLT the single-block ones, FLAVA the flash ones)
        out["fp32"]["step_cost"] = fp32_step_cost(device, name)

    with torch.device(device):
        model = create_model(fam["model_class"], vocab_size=42112, dtype="bfloat16",
                             attention=fam["backend"])
    model.load_state_dict(state)
    del state
    reset_counts()
    extra = {k: batch[k] for k in ("visual_attention_mask",) if k in batch}
    with torch.inference_mode():
        trans = model(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"],
                      token_type_ids=batch["token_type_ids"],
                      pixel_values=batch["pixel_values"], positions=finetune_positions(batch),
                      boundary=batch["sep_idx"][:, 2], **extra)
        logits = model.logits(trans[:, 0], vocab_ids=torch.arange(20000, 22063, device=device))
        torch.cuda.synchronize()
    if all_counts() != family_counts(fam["backend"], calls, backward=False, **counts_kw) \
            or logits.shape != (b, 2063) or not torch.isfinite(logits).all():
        raise AssertionError(f"{name} bf16 forward: launches {all_counts()}, logits "
                             f"{tuple(logits.shape)}")
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(alpha=fam["alpha"], seed=3),
                          device=device)
    opt = make_optimizer(model, 1e-4, 100, warmup_ratio=0.0)
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    expect = family_counts(fam["backend"], calls, **counts_kw)
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
    profile = device_profile(lambda: trainer._train_step(opt, batch, 6), top=12)
    out["bf16"] = dict(backend=fam["backend"], losses=losses, step_ms=times,
                       median_step_ms=step_ms, examples_per_sec=b / step_ms * 1e3,
                       launches_per_step=expect,
                       peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                       idle_share=1.0 - profile["device_ms"] / step_ms,
                       device_profile_step=profile)
    if fam.get("also_flash"):
        # the same model and optimizer state through the flash kernels: which
        # route is the faster default at this family's lengths
        set_backend(model, "flash")
        torch.cuda.reset_peak_memory_stats()
        flash_times, flash_losses = [], []
        for step in range(7, 11):
            reset_counts()
            t0 = time.perf_counter()
            metrics = trainer._train_step(opt, batch, step)
            torch.cuda.synchronize()
            flash_times.append((time.perf_counter() - t0) * 1e3)
            if all_counts() != family_counts("flash", calls, **counts_kw):
                raise AssertionError(f"{name} bf16 flash step: launches {all_counts()}")
            flash_losses.append(metrics["loss"].item())
        if not all(math.isfinite(x) for x in flash_losses) \
                or not flash_losses[-1] < flash_losses[0]:
            raise AssertionError(f"{name} bf16 loss through flash did not fall: {flash_losses}")
        flash_ms = statistics.median(flash_times[1:])
        profile = device_profile(lambda: trainer._train_step(opt, batch, 11), top=6)
        out["bf16_through_flash"] = dict(
            step_ms=flash_times, median_step_ms=flash_ms, losses=flash_losses,
            launches_per_step=family_counts("flash", calls, **counts_kw),
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            idle_share=1.0 - profile["device_ms"] / flash_ms, device_profile_step=profile)
        set_backend(model, fam["backend"])
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
    reproduces the ranks. Then ViLT in fp32 through its default single-block
    kernels (``vilt_fp32``: one step, dev and test; 12 + 12 launches a step,
    12 a forward, none of the flash kernels). The counts are set to 0
    before each run (tool and fine-tune) and read after it."""
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
            fwd_only = family_counts(fam["backend"], fam["calls"], backward=False,
                                     **family_kw(fam))
            both = family_counts(fam["backend"], fam["calls"], **family_kw(fam))
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
        # ViLT's fp32 route through the CLI, as JAX runs it: its default
        # single-block kernels (the CUDA-core ones stream its 418 keys), one
        # step from the same store, then dev and test
        fam = FAMILIES["vilt"]
        reset_counts()
        t0 = time.perf_counter()
        metrics = cli.main([
            "--data_dir", mars, "--pretrain_path", markg, "--device", "cuda",
            "--model_class", fam["model_class"],
            "--image_features", os.path.join(root, "vilt_pixels.npy"), "--dtype", "float32",
            "--max_seq_length", "128", "--output_dir", os.path.join(root, "vilt_fp32_fit"),
            "--log_dir", os.path.join(root, "logs_vilt_fp32"),
            "--cache_dir", os.path.join(root, "cache"), "--max_epochs", "1",
            "--limit_train_batches", "1", "--batch_size", str(fam["batch"]),
            "--lr", str(fam["lr"]), "--alpha", str(fam["alpha"])])
        fwd_only = family_counts("single", fam["calls"], backward=False, bf16=False)
        both = family_counts("single", fam["calls"], bf16=False)
        expect = {k: both[k] + fwd_only[k] * (1 + math.ceil(n_test / 128)) for k in both}
        if all_counts() != expect or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cli vilt fp32: launches {all_counts()}, expected {expect}, "
                                 f"metrics {metrics}")
        vilt_fp32 = dict(steps=1, launches=all_counts(), seconds=time.perf_counter() - t0,
                         test_mrr=metrics["Eval_entity/mrr"])
        torch.cuda.empty_cache()
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["vilt"]["launches"]}
    emit(dict(phase="cli_image", dtype="bfloat16", train_examples=n_train,
              entities_with_images=n_with, launches=total, **runs, vilt_fp32=vilt_fp32))
    return total


def cli_region_phase():
    """The main path of the region slice, end to end, for VisualBERT and
    ViLBERT: ``cli.main --model_class VisualBertKGC|VilBertKGC
    --image_features synthetic`` (each entity's 36 regions one 2048-d code,
    built on the card from a seeded generator) fine-tunes one epoch in bf16
    at the recipes' batch (128 examples: 2 steps at B=64), evaluates dev
    (1 batch) and test (2 batches at B=128) and tests the best-dev
    checkpoint; ``--only_test --checkpoint`` reproduces the ranks. Then
    ViLBERT once more with ``--fused_attention flash`` (``vilbert_flash``):
    its text layers launch the head_dim-64 flash kernels, its visual layers
    the head_dim-128 ones, on the tensor cores. The counts are set to 0 just
    before each fit and read just after it; ViLBERT's head_dim-128 launches
    must be among them."""
    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.cli import main as cli

    n_train, n_test = 128, 200
    runs = {}
    plan = [(name, fam, []) for name, fam in REGION_FAMILIES.items()]
    plan.append(("vilbert_flash", dict(REGION_FAMILIES["vilbert"], backend="flash"),
                 ["--fused_attention", "flash"]))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_region_cli_", dir=".") as root:
        markg, mars = write_dataset(root, n_train=n_train, n_test=n_test)
        for name, fam, route in plan:
            def argv(out_dir, *extra):
                return ["--data_dir", mars, "--pretrain_path", markg, "--device", "cuda",
                        "--model_class", fam["model_class"], "--image_features", "synthetic",
                        "--dtype", "bfloat16", "--max_seq_length", "128",
                        "--eval_batch_size", "128", *route,
                        "--output_dir", out_dir, "--log_dir", os.path.join(root, f"logs_{name}"),
                        "--cache_dir", os.path.join(root, "cache"), *extra]

            fit_dir = os.path.join(root, f"{name}_fit")
            reset_counts()
            t0 = time.perf_counter()
            metrics = cli.main(argv(fit_dir, "--max_epochs", "1",
                                    "--batch_size", str(fam["batch"]), "--lr", str(fam["lr"]),
                                    "--alpha", str(fam["alpha"])))
            seconds = time.perf_counter() - t0
            launches = all_counts()
            steps = n_train // fam["batch"]
            counts_kw = family_kw(fam)
            fwd_only = family_counts(fam["backend"], fam["calls"], backward=False, **counts_kw)
            both = family_counts(fam["backend"], fam["calls"], **counts_kw)
            expect = {k: both[k] * steps + fwd_only[k] * (1 + math.ceil(n_test / 128))
                      for k in both}
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
                backend=fam["backend"], batch_size=fam["batch"], steps=steps, launches=launches,
                seconds=seconds, test_mrr=metrics["Eval_entity/mrr"],
                test_hits10=metrics["Eval_entity/hits10"],
                examples_per_sec_after_step_1=epoch["train/examples_per_sec"],
                last_loss=epoch["train/last_loss"], retest_ranks_identical=True)
            torch.cuda.empty_cache()
    emit(dict(phase="cli_region", dtype="bfloat16", train_examples=n_train,
              image_features="synthetic", **runs))
    return {name: r["launches"] for name, r in runs.items()}


KGE_COUNTS = dict(entities=11292, relations=192, triples=33307, mars=(10641, 1020, 1362))
KGE_VOCAB = 3000  # synthetic glossary words for PV-DM


def kge_data(counts=KGE_COUNTS, seed=0):
    """A synthetic MarKG at the real counts (SURVEY.md section 0: 11,292
    entities, 192 relations, 33,307 distinct triples), MARS 6-tuples at the
    splits' sizes, a (E+1, 4096) VGG store (ReLU-like, U[0, 1)), a (E, 1000)
    ViT store and 8-30-word glossaries; all from numpy at ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    E, R, T = counts["entities"], counts["relations"], counts["triples"]
    code = rng.integers(0, E * R * E, size=int(T * 1.1) + 64, dtype=np.int64)
    _, first = np.unique(code, return_index=True)
    code = code[np.sort(first)][:T]
    triples = np.stack([code // (R * E), code // E % R, code % E], axis=1)  # (h, r, t)
    mars = {}
    for split, n in zip(("train", "dev", "test"), counts["mars"]):
        cols = [rng.integers(0, E, n) for _ in range(4)] + [rng.integers(0, R, n),
                                                             np.arange(n) % 3]
        mars[split] = np.stack(cols, axis=1).astype(np.int64)
    texts = [" ".join(f"w{chr(97 + w % 26)}{chr(97 + w // 26 % 26)}{chr(97 + w // 676)}"
                      for w in rng.integers(0, KGE_VOCAB, rng.integers(8, 31)))
             for _ in range(E)]
    return dict(E=E, R=R, triples=triples, mars=mars, texts=texts,
                vgg=rng.random((E + 1, 4096), dtype=np.float32),
                vit=rng.standard_normal((E, 1000), dtype=np.float32))


def kge_grad_ratio(got_model, want_model, rel=1e-5):
    """The largest of err / (rel * the leaf's largest |gradient|) over the
    parameters, and its leaf (every leaf must have a gradient on both
    sides)."""
    want = dict(want_model.named_parameters())
    worst, worst_name = 0.0, ""
    for name, p in got_model.named_parameters():
        g, w = p.grad, want[name].grad
        if g is None or w is None:
            raise AssertionError(f"gradient of {name} missing")
        ratio = (g.cpu() - w).abs().max().item() / (rel * w.abs().max().item() + 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def kge_host_ms(step, n=8, warm=2):
    """Median host ms of ``step()`` over ``n`` calls after ``warm``, each
    call ended by a synchronise."""
    import torch

    times = []
    for i in range(warm + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rank_agreement(gpu_scores, cpu_scores, golds, gpu_ranks, cpu_ranks, rel=1e-5):
    """The card's scores within ``rel`` of the CPU's largest |score| per
    batch; the ranks equal except in rows where some other candidate lies
    within that tolerance of the gold (a near tie, whose order the
    summation order may flip). Returns (largest err / bar, near-tie rows,
    rows whose ranks differ)."""
    import numpy as np

    worst, near = 0.0, []
    for g, c, gold in zip(gpu_scores, cpu_scores, golds):
        tol = rel * np.abs(c).max()
        worst = max(worst, float(np.abs(g - c).max() / tol))
        gap = np.abs(c - c[np.arange(len(gold)), gold][:, None]) <= tol
        gap[np.arange(len(gold)), gold] = False
        near.append(gap.any(axis=1))
    near = np.concatenate(near)
    differ = np.asarray(gpu_ranks) != np.asarray(cpu_ranks)
    if worst > 1.0 or (differ & ~near).any():
        raise AssertionError(f"ranks or scores disagree: scores at {worst} of the bar, "
                             f"{int((differ & ~near).sum())} ranks apart without a near tie")
    return worst, int(near.sum()), int(differ.sum())


def kge_ikrl_phase(device, data, lp_triples=128, pvdm_epochs=2):
    """The IKRL silo at full width (MarKG's counts, the recipe's batch of
    33,307 // 100 = 333 triples x (1 + 25 + 25) rows). For IKRL TransE
    (d=400, margin 5, SGD lr 1), IKRL ANALOGY (d=200, softplus + regul 1)
    and TransAE (d=200; its PV-DM text table trained here for
    ``pvdm_epochs`` epochs, not the recipe's 40): one pre-train step on the
    card against the port on the CPU from the same weights, sampler batch
    and task modes (loss within 1e-5 relative, every gradient leaf within
    1e-5 of its largest value), then 8 timed steps (median host ms after
    two); the ANALOGY recipe, which diverges there, then ranks the first
    128 triples' queries (Hits@1 at most 0.5, its non-finite rows counted).
    Then IKRL TransE's filtered link prediction on the first
    ``lp_triples`` triples, both sides, B=64: energies within 1e-5 of the
    CPU's, ranks equal but for near ties; its time; and one fine-tune step
    at B=128 (Adam) on the card against the CPU. Peak GB of each."""
    import copy

    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.kge import eval as keval
    from mkg_analogy_tpu_torch.kge.ikrl import IKRLConfig, create_ikrl
    from mkg_analogy_tpu_torch.kge.pvdm import PVDMConfig, train_pvdm
    from mkg_analogy_tpu_torch.kge.sampling import NegativeSampler, TripleStore
    from mkg_analogy_tpu_torch.kge.trainer import KGETrainConfig, KGETrainer, draw_task_mode
    from mkg_analogy_tpu_torch.kge.transae import TransAEConfig, TransAETransE

    t_start = time.perf_counter()
    E, R = data["E"], data["R"]
    store = TripleStore.from_arrays(data["triples"], E, R)
    bs = len(store) // 100
    sampler = iter(NegativeSampler(store, batch_size=bs, neg_ent=25, neg_rel=25, seed=0))
    batches = [next(sampler) for _ in range(13)]  # 1 compared, 10 timed, 2 profiled
    t0 = time.perf_counter()
    text = np.zeros((E + 1, 100), np.float32)
    text[:E] = train_pvdm(data["texts"], PVDMConfig(epochs=pvdm_epochs), device=device)
    pvdm_seconds = time.perf_counter() - t0
    gen = torch.Generator().manual_seed
    cases = {
        "ikrl_transe": (lambda: create_ikrl(IKRLConfig(E, R, dim=400), data["vgg"], gen(0)),
                        KGETrainConfig(loss="margin", margin=5.0)),
        "ikrl_analogy": (lambda: create_ikrl(IKRLConfig(E, R, dim=200, scorer="analogy"),
                                             data["vgg"], gen(1)),
                         KGETrainConfig(loss="softplus", regul_rate=1.0)),
        "transae": (lambda: TransAETransE(TransAEConfig(E, R, dim=200), text, data["vgg"],
                                          gen(2)), KGETrainConfig(loss="margin", margin=5.0)),
    }
    out, models = {}, {}
    modes = draw_task_mode(torch.Generator().manual_seed(3), bs * 51)
    for name, (build, cfg) in cases.items():
        cpu = build()
        gpu = copy.deepcopy(cpu).to(device)
        losses, pre = [], []
        for m in (cpu, gpu):
            tr = KGETrainer(m, cfg, bs, 50)
            state = tr.init_state()
            dev = next(m.parameters()).device
            hooks = []
            if name == "transae":  # the pre-activations of each ReLU, each side
                acts = {}
                pre.append(acts)
                for lname, layer in m.encoder.named_children():
                    hooks.append(layer.register_forward_hook(
                        lambda mod, i, o, lname=lname: acts.__setitem__(lname, o.detach().cpu())))
            losses.append(tr.pretrain_step(state, tr.device_batch(batches[0], dev),
                                           modes.to(dev)).item())
            for hook in hooks:
                hook.remove()
        loss_rel = abs(losses[1] - losses[0]) / abs(losses[0])
        ratio, leaf = kge_grad_ratio(gpu, cpu)
        extra, bar_ok = {}, ratio <= 1.0
        if name == "transae":
            # Every encoder and decoder layer ends in a ReLU: a pre-activation
            # within rounding of 0 takes the kink on one side only and moves
            # that row's whole contribution to the weight gradient, ~1e-4 of
            # the leaf at 16,983 rows. So TransAE's leaves are held to the
            # bar of the deep fp32 steps (1e-3 of the leaf's largest |gradient|
            # plus 1e-6 of the model's largest), and the kinks are counted.
            flips = {k: int(((pre[0][k] > 0) != (pre[1][k] > 0)).sum()) for k in pre[0]}
            deep, deep_leaf = leaf_ratios(
                {n: p.grad.cpu() for n, p in gpu.named_parameters()},
                {n: p.grad for n, p in cpu.named_parameters()})
            extra = dict(relu_kink_flips=flips, grad_ratio_deep_bar=deep,
                         grad_worst_leaf_deep_bar=deep_leaf)
            bar_ok = deep <= 1.0
            del pre
        if not loss_rel <= 1e-5 or not bar_ok or not math.isfinite(losses[0]):
            raise AssertionError(f"kge_ikrl {name}: loss {losses} ({loss_rel} apart), "
                                 f"gradient {leaf} at {ratio} of its bar {extra}")
        tr = KGETrainer(gpu, cfg, bs, 50)
        state = tr.init_state()
        task_gen = torch.Generator(device=device).manual_seed(0)
        it = iter(batches[1:])
        step_losses = []

        def step():
            b = tr.device_batch(next(it), device)
            step_losses.append(tr.pretrain_step(state, b, draw_task_mode(task_gen, bs * 51)))

        torch.cuda.reset_peak_memory_stats()
        ms = kge_host_ms(step)
        prof = device_profile(step, top=6)
        out[name] = dict(device_ms=prof["device_ms"], top_kernels=prof["top"],loss_cpu=losses[0], loss_rel_err=loss_rel, grad_ratio=ratio,
                         grad_worst_leaf=leaf, **extra, ms_per_step=ms,
                         triples_per_s=bs / ms * 1e3, rows_per_s=bs * 51 / ms * 1e3,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         timed_loss_first=float(step_losses[0]),
                         timed_loss_last=float(step_losses[-1]),
                         timed_losses_finite=bool(torch.isfinite(torch.stack(step_losses)).all()))
        models[name] = (cpu, gpu)
        del tr, state
        torch.cuda.empty_cache()
    out["transae"]["pvdm_epochs"] = pvdm_epochs
    out["transae"]["pvdm_seconds"] = pvdm_seconds

    # the ANALOGY recipe (SGD at lr 1) after its timed steps: where it
    # diverged, its energies are NaN, and each such query ranks last
    filters = keval.build_filters(store)
    head = TripleStore(store.heads[:128], store.tails[:128], store.rels[:128], E, R)
    models["ikrl_analogy"][1].eval()
    diverged = keval.link_prediction(models["ikrl_analogy"][1].candidate_energies, head,
                                     filters, E, device=device)
    if not diverged["hit1"] <= 0.5:
        raise AssertionError(f"kge_ikrl: the ANALOGY recipe after its timed steps reports "
                             f"Hits@1 {diverged['hit1']}")
    out["ikrl_analogy"]["link_prediction_after_timed_steps"] = dict(
        queries=2 * len(head), hit1=diverged["hit1"], mrr=diverged["mrr"],
        nonfinite_gold=diverged["nonfinite_gold"])

    # link prediction with IKRL TransE, the card's weights on both sides
    t_lp = time.perf_counter()
    cpu, gpu = models["ikrl_transe"]
    cpu.load_state_dict(gpu.state_dict())
    for name in ("ikrl_analogy", "transae"):
        del models[name]
    gpu.eval()
    cpu.eval()
    test = TripleStore(store.heads[:lp_triples], store.tails[:lp_triples],
                       store.rels[:lp_triples], E, R)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    keval.link_prediction(gpu.candidate_energies, test, filters, E, device=device)
    torch.cuda.synchronize()
    lp_seconds = time.perf_counter() - t0
    lp_peak = torch.cuda.max_memory_allocated() / 1e9
    seen = {"gpu": [], "cpu": []}

    def recorded(m, who):
        def fn(h, r, tm, corrupt):
            e = m.candidate_energies(h, r, tm, corrupt)
            seen[who].append(e.float().cpu().numpy())
            return e
        return fn

    m_gpu, r_gpu = keval.link_prediction(recorded(gpu, "gpu"), test, filters, E,
                                         device=device, return_ranks=True)
    m_cpu, r_cpu = keval.link_prediction(recorded(cpu, "cpu"), test, filters, E,
                                         return_ranks=True)
    golds = [g for s in range(0, lp_triples, 64)
             for g in (test.tails[s:s + 64], test.heads[s:s + 64])]
    lp = {}
    for kind in ("raw", "filter"):
        lp[kind] = rank_agreement(seen["gpu"], seen["cpu"], golds, r_gpu[kind], r_cpu[kind])
    out["link_prediction"] = dict(
        triples=lp_triples, queries=2 * lp_triples, batch=64, seconds=lp_seconds,
        queries_per_s=2 * lp_triples / lp_seconds, peak_gb=lp_peak,
        energy_err_over_bar=lp["filter"][0], near_tie_ranks=lp["filter"][1],
        ranks_apart={k: v[2] for k, v in lp.items()},
        mrr=m_gpu["mrr"], mrr_cpu=m_cpu["mrr"], hit10=m_gpu["hit10"],
        nonfinite_gold=m_gpu["nonfinite_gold"])

    # one fine-tune step at B=128 (Adam), card against CPU; then 5 timed
    t_ft = time.perf_counter()
    rows = data["mars"]["train"][:128]
    losses = []
    for m in (cpu, gpu):
        m.train()
        tr = KGETrainer(m, KGETrainConfig(finetune_batch_size=128), bs, 50)
        state = tr.init_state(finetune=True)
        ft_batch = tr.tuple_batch(rows, next(m.parameters()).device)
        losses.append(tr.finetune_step(state, ft_batch).item())
    loss_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    # The fine-tune's gradients reach the tables through 4 x 578M |h + r - t|
    # terms (128 x 11,292 x 400), whose sign at a kink (a difference within
    # rounding of 0) the two sides take apart, and through the CE's
    # gradient, which sums to 0 over the 11,292 candidates: held to the
    # deep fp32 steps' bar, as TransAE's; the 1e-5 ratio is reported.
    ratio, leaf = kge_grad_ratio(gpu, cpu)
    deep, deep_leaf = leaf_ratios({n: p.grad.cpu() for n, p in gpu.named_parameters()},
                                  {n: p.grad for n, p in cpu.named_parameters()})
    if not loss_rel <= 1e-5 or deep > 1.0:
        raise AssertionError(f"kge_ikrl fine-tune: loss {losses} ({loss_rel} apart), "
                             f"gradient {deep_leaf} at {deep} of its bar")
    torch.cuda.reset_peak_memory_stats()
    ft_ms = kge_host_ms(lambda: tr.finetune_step(state, ft_batch), n=5, warm=1)
    out["finetune_step"] = dict(batch=128, loss_rel_err=loss_rel, grad_ratio=ratio,
                                grad_worst_leaf=leaf, grad_ratio_deep_bar=deep,
                                grad_worst_leaf_deep_bar=deep_leaf,
                                ms_per_step=ft_ms, examples_per_s=128 / ft_ms * 1e3,
                                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del tr, state, ft_batch
    del models, cpu, gpu
    torch.cuda.empty_cache()
    # the wall clock of the phase's parts (the CPU's side of each comparison
    # included)
    seconds = dict(pretrain_steps=t_lp - t_start, link_prediction=t_ft - t_lp,
                   finetune=time.perf_counter() - t_ft)
    emit(dict(phase="kge_ikrl", entities=E, relations=R, triples=len(store),
              batch=bs, rows_per_step=bs * 51, seconds=seconds, **out))


def kge_rsme_phase(device, data, finetune_batch=500):
    """The RSME silo at full width: ComplEx at rank 1000 over MarKG's
    reciprocal triples (98% of 33,307, doubled), B=1000, Adagrad lr 1e-2,
    the (E, 1000) ViT table fused at alpha 0.7 with a seeded binary forget
    gate: one step on the card against the port on the CPU from the same
    weights (loss within 1e-5 relative, every gradient leaf within 1e-5 of
    its largest value), 8 timed steps and one timed epoch; then
    eval_both_sides on the 1% test split (333 triples) on the card and the
    CPU with the card's weights: scores within 1e-5, ranks equal but for
    near ties; then the Analogy fine-tune forward and its ranking at
    B=``finetune_batch``, card against CPU. Peak GB of each."""
    import copy

    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.kge.rsme import (RSMEConfig, RSMEModel, RSMETrainConfig,
                                                RSMETrainer, assign_modes, build_to_skip,
                                                filtered_eval, reciprocal_augment)
    from mkg_analogy_tpu_torch.ops.ranking import nonfinite_gold, ranks_from_scores

    E, R = data["E"], data["R"]
    rng = np.random.default_rng(1)
    data4 = np.column_stack([data["triples"], assign_modes(len(data["triples"]), rng)])
    perm = rng.permutation(len(data4))
    n_valid = len(data4) // 100
    test4 = data4[perm[n_valid:2 * n_valid]]
    train_aug = reciprocal_augment(data4[perm[2 * n_valid:]], R)
    to_skip = build_to_skip(reciprocal_augment(data4, R)[:, :3])["rhs"]
    pd = rng.integers(0, 2, size=(2 * R,)).astype(np.float32)
    cfg = RSMEConfig(E, R, rank=1000, img_dim=1000, model="complex")
    cpu = RSMEModel(cfg, img_vec=data["vit"], rel_pd=pd,
                    generator=torch.Generator().manual_seed(4))
    gpu = copy.deepcopy(cpu).to(device)
    tcfg = RSMETrainConfig(lr=1e-2, batch_size=1000)
    batch = train_aug[rng.permutation(len(train_aug))[:1000]]
    losses = []
    for m in (cpu, gpu):
        tr = RSMETrainer(m, tcfg)
        dev = next(m.parameters()).device
        losses.append(tr.step(tr.init_state(), torch.from_numpy(batch).to(dev)).item())
    loss_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    ratio, leaf = kge_grad_ratio(gpu, cpu)
    if not loss_rel <= 1e-5 or ratio > 1.0:
        raise AssertionError(f"kge_rsme: loss {losses} ({loss_rel} apart), gradient "
                             f"{leaf} at {ratio} of its bar")
    tr = RSMETrainer(gpu, tcfg)
    state = tr.init_state()
    order = rng.permutation(len(train_aug))
    k = iter(range(100))

    def step():
        rows = train_aug[order[next(k) * 1000:][:1000]]
        tr.step(state, torch.from_numpy(rows).to(device))

    torch.cuda.reset_peak_memory_stats()
    ms = kge_host_ms(step)
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    prof = device_profile(step, top=6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, epoch_loss = tr.epoch(state, train_aug, np.random.default_rng(2))
    epoch_seconds = time.perf_counter() - t0
    out = dict(step=dict(rank=1000, batch=1000, loss_cpu=losses[0], loss_rel_err=loss_rel,
                         grad_ratio=ratio, grad_worst_leaf=leaf, ms_per_step=ms,
                         examples_per_s=1000 / ms * 1e3, peak_gb=step_peak,
                         device_ms=prof["device_ms"], top_kernels=prof["top"],
                         epoch_steps=len(train_aug) // 1000, epoch_seconds=epoch_seconds,
                         epoch_loss=epoch_loss))

    # filtered evaluation on both sides with the card's weights
    cpu.load_state_dict(gpu.state_dict())
    sides = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for side in ("rhs", "lhs"):
        q = test4.copy()
        if side == "lhs":
            q[:, [0, 2]] = q[:, [2, 0]]
            q[:, 1] += R
        sides[side] = (q, *filtered_eval(gpu, q, to_skip, return_nonfinite=True))
    eval_seconds = time.perf_counter() - t0
    eval_peak = torch.cuda.max_memory_allocated() / 1e9
    agree = {}
    with torch.no_grad():
        for side, (q, r_gpu, _) in sides.items():
            s = [m.ranking_scores(torch.from_numpy(q).to(next(m.parameters()).device))
                 .cpu().numpy() for m in (gpu, cpu)]
            agree[side] = rank_agreement([s[0]], [s[1]], [q[:, 2]], r_gpu,
                                         filtered_eval(cpu, q, to_skip))
    ranks = np.concatenate([sides["rhs"][1], sides["lhs"][1]])
    out["eval_both_sides"] = dict(
        triples=len(test4), queries=2 * len(test4), seconds=eval_seconds,
        queries_per_s=2 * len(test4) / eval_seconds, peak_gb=eval_peak,
        score_err_over_bar=max(a[0] for a in agree.values()),
        near_tie_ranks=sum(a[1] for a in agree.values()),
        ranks_apart=sum(a[2] for a in agree.values()), mrr=float(np.mean(1.0 / ranks)),
        nonfinite_gold=int(sum(side[2].sum() for side in sides.values())))
    del tr, state, cpu, gpu
    torch.cuda.empty_cache()

    # the Analogy fine-tune forward and its ranking
    cfg = RSMEConfig(E, R, rank=1000, img_dim=1000, model="analogy", init_size=0.1)
    cpu = RSMEModel(cfg, img_vec=data["vit"], rel_pd=pd,
                    generator=torch.Generator().manual_seed(5))
    gpu = copy.deepcopy(cpu).to(device).eval()
    rows = data["mars"]["test"][:finetune_batch]
    with torch.no_grad():
        x = torch.from_numpy(rows).to(device)
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = kge_host_ms(lambda: ranks_from_scores(gpu.finetune_forward(x)[0], x[:, 3]))
        ft_peak = torch.cuda.max_memory_allocated() / 1e9
        preds = gpu.finetune_forward(x)[0]
        want = cpu.finetune_forward(torch.from_numpy(rows))[0]
        r_gpu = ranks_from_scores(preds, x[:, 3]).cpu().numpy()
        r_cpu = ranks_from_scores(want, torch.from_numpy(rows[:, 3])).numpy()
        err, near, apart = rank_agreement([preds.cpu().numpy()], [want.numpy()],
                                          [rows[:, 3]], r_gpu, r_cpu)
    out["finetune_forward"] = dict(model="analogy", batch=finetune_batch, ms=fwd_ms,
                                   examples_per_s=finetune_batch / fwd_ms * 1e3,
                                   peak_gb=ft_peak, score_err_over_bar=err,
                                   near_tie_ranks=near, ranks_apart=apart,
                                   nonfinite_gold=int(nonfinite_gold(preds, x[:, 3]).sum()))
    del cpu, gpu
    torch.cuda.empty_cache()
    emit(dict(phase="kge_rsme", entities=E, relations=R, train_examples=len(train_aug),
              test_triples=len(test4), **out))


def cli_kge_phase():
    """The KGE CLIs end to end on the card, on the small dataset of
    ``write_dataset``: ``cli.ikrl`` pre-trains (TransE, d=400), fine-tunes
    from its checkpoint (rank dump with tie counts) and ``--eval_only
    --ckpt`` reproduces each fit's metrics and ranks exactly; once more with
    ``--use_native_sampler --in_path <OpenKE dir>`` (builds the port's
    sampler with g++); ``cli.rsme`` pre-trains ComplEx and fine-tunes
    Analogy (rank 1000), each reproduced by ``--eval_only --ckpt``."""
    import numpy as np

    from mkg_analogy_tpu_torch.cli import ikrl, rsme
    from mkg_analogy_tpu_torch.data.openke_tools import write_id_files
    from mkg_analogy_tpu_torch.data.readers import MarKG

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kge_cli_", dir=".") as root:
        markg, mars = write_dataset(root)
        base = ["--data_dir", mars, "--pretrain_path", markg, "--device", "cuda",
                "--log_dir", os.path.join(root, "logs")]

        def run(name, cli, args, retest=(), dump=False):
            out_dir = os.path.join(root, name)
            extra = ["--dump_ranks", os.path.join(root, f"{name}.npz")] if dump else []
            t0 = time.perf_counter()
            metrics = cli.main(base + args + ["--output_dir", out_dir] + extra)
            seconds = time.perf_counter() - t0
            if not all(math.isfinite(v) for v in metrics.values()) \
                    or not 0.0 < metrics["mrr"] <= 1.0:
                raise AssertionError(f"cli_kge {name}: metrics {metrics}")
            again = cli.main(base + args + list(retest) + [
                "--eval_only", "--ckpt", os.path.join(out_dir, "ckpt"),
                "--output_dir", out_dir + "_again"]
                + (["--dump_ranks", os.path.join(root, f"{name}_again.npz")] if dump else []))
            if again != metrics:
                raise AssertionError(f"cli_kge {name}: --eval_only gave {again}, the fit "
                                     f"{metrics}")
            row = dict(seconds=seconds, mrr=metrics["mrr"], eval_only_identical=True,
                       nonfinite_gold=metrics["nonfinite_gold"])
            if dump:
                a, b = (np.load(os.path.join(root, f"{n}.npz")) for n in (name, f"{name}_again"))
                if not (np.array_equal(a["ranks"], b["ranks"])
                        and np.array_equal(a["tie"], b["tie"]) and (a["tie"] >= 1).all()):
                    raise AssertionError(f"cli_kge {name}: the dumps differ")
                row["ties_above_1"] = int((a["tie"] > 1).sum())
            out[name] = row
            return out_dir

        pre = run("ikrl", ikrl, ["--dim", "400", "--nbatches", "4", "--train_times", "3"])
        run("ikrl_ft", ikrl, ["--dim", "400", "--finetune", "--finetune_epochs", "2",
                              "--finetune_bsz", "32", "--ckpt", os.path.join(pre, "ckpt")],
            dump=True)
        in_path = os.path.join(root, "openke")
        write_id_files(in_path, MarKG(markg))
        run("ikrl_native", ikrl, ["--dim", "400", "--nbatches", "4", "--train_times", "3",
                                  "--use_native_sampler", "--in_path", in_path])
        run("rsme", rsme, ["--model", "ComplEx", "--max_epochs", "4", "--valid", "4",
                           "--batch_size", "100"])
        run("rsme_ft", rsme, ["--model", "Analogy", "--finetune", "--max_epochs", "2",
                              "--batch_size", "32"], dump=True)
    emit(dict(phase="cli_kge", **out))


# (name, source of the main paths' kernel, source of the fp32 route's or
# None, line of the Pallas kernel body it replaces)
FLASH_KERNELS = {
    "fwd": ("flash_attention_fwd", "flash_attention_fwd_mma.cu", "flash_attention_fwd.cu", 98),
    "dkv": ("flash_attention_bwd_dkv", "flash_attention_bwd_mma.cu", "flash_attention_bwd.cu",
            183),
    "dq": ("flash_attention_bwd_dq", "flash_attention_bwd_mma.cu", "flash_attention_bwd.cu",
           271),
}


MESH_STEPS = 3     # fine-tune steps of each gloo mesh phase (the first at lr 0)
MESH_1X1_STEPS = 6  # of mesh_1x1 and its no-mesh runs (the median of steps 3-6)
MESH_EVAL = 32     # dev examples each mesh phase ranks, at B=32
# AdamW's eps in the gloo phases: a leaf whose gradient is round-off (the key
# biases: a softmax ignores a per-row constant) then moves by its gradient
# over 1e-3, not by +-lr whichever the sign of its noise, which the mesh's
# other summation order flips (with the recipe's 1e-8, tp2's third loss
# moved 1e-4 relative from the single process's)
GLOO_EPS = 1e-3
# (phase, dp, tp): the gloo meshes of ranks sharing cuda:0
GLOO_MESHES = [("dp2", 2, 1), ("tp2", 1, 2), ("dp2tp2", 2, 2)]


def mesh_features(n=MESH_EVAL, seed=4):
    """Dev features in the layout of data/prompt.py (numpy, as
    ``MarTTrainer.evaluate`` takes them), from ``train_batch``'s
    generator."""
    import torch

    b = train_batch(torch.device("cpu"), b=n, seed=seed)
    return {k: v.numpy() for k, v in b.items()}


def mesh_trainer(device, dtype, mesh=None, eps=1e-8):
    """The full-width MKGformer at the recipe (B=32 train, 32 eval), random
    weights from seed 0, dropout on, on ``mesh`` (None: one device), and
    its AdamW (``eps``: the recipe's 1e-8, or larger where a run is held to
    another)."""
    import torch

    from mkg_analogy_tpu_torch.models.unimo import UnimoConfig, UnimoForMaskedLM
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    with torch.device(device):
        model = UnimoForMaskedLM(UnimoConfig(dtype=dtype))
    model.init_params(torch.Generator(device=device).manual_seed(0))
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(seed=3, eval_batch_size=32),
                          device=device, mesh=mesh)
    trainer._parallelize()
    return trainer, make_optimizer(model, 1e-4, 100, warmup_ratio=0.0, eps=eps, mesh=mesh)


def whole_grads(model):
    """Every parameter's gradient, whole: a tp rank's part written into
    zeros and summed over tp (every rank calls it)."""
    from mkg_analogy_tpu_torch.parallel.collectives import shard_of, whole

    return {name: None if p.grad is None else whole(p.grad, shard_of(p)).detach().clone()
            for name, p in model.named_parameters()}


def mesh_steps(trainer, opt, batch_np, dev_np, ranks_path, steps=MESH_STEPS):
    """The dev evaluation of the starting weights, then ``steps`` train
    steps on the global batch (each rank its rows), the attention counts
    set to 0 just before and read just after: (losses, the first step's
    whole gradients after the dp sum, host ms a step, (forward, backward)
    launches, dev metrics); the dev ranks go to ``ranks_path``. (After
    AdamW's updates, leaves whose gradient is round-off move by +-lr
    whichever its sign, so ranks after the steps would show that noise.)"""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn

    grads = {}
    real_step = opt.step

    def step_keeping_grads():
        opt.sync_gradients()
        if not grads:
            grads.update(whole_grads(trainer.model))
        return real_step()

    opt.step = step_keeping_grads
    losses, times = [], []
    reset_counts()
    dev = trainer.evaluate(dev_np, dump_path=ranks_path)
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer._train_step(opt, trainer._put_batch(batch_np), step)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = (attn.LAUNCHES, attn.LAUNCHES_BWD)
    opt.step = real_step
    return losses, grads, times, launches, dev


def mesh_rank_agreement(got, want, logits, rel=1e-5):
    """The ranks equal but where some other candidate's single-process
    logit lies within ``rel`` of the row's largest |logit| of the gold's (a
    near tie, which another summation order may flip): (near-tie rows,
    rows whose ranks differ)."""
    import numpy as np

    gold = logits[np.arange(len(logits)), want["label"]][:, None]
    near = np.abs(logits - gold) <= rel * np.abs(logits).max(axis=1, keepdims=True)
    near[np.arange(len(logits)), want["label"]] = False
    near = near.any(axis=1)
    differ = got != want["ranks"]
    if (differ & ~near).any():
        raise AssertionError(f"dev ranks: {int((differ & ~near).sum())} rows apart "
                             "without a near tie")
    return int(near.sum()), int(differ.sum())


def _gloo_mesh_rank(rank, name, dp, tp, work):
    """One rank of a gloo mesh on cuda:0: the reference's weights, batch and
    dropout seeds, MESH_STEPS fp32 steps and the dev ranks; held against
    the single-process reference on the card (every rank checks; a rank
    that raises fails the phase). Each rank writes its launches and times."""
    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.core.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    ref = torch.load(os.path.join(work, f"reference_{name}.pt"), map_location=device,
                     weights_only=False)
    mesh = make_mesh(dp=dp, tp=tp, devices=[device] * (dp * tp))
    trainer, opt = mesh_trainer(device, "float32", mesh, eps=GLOO_EPS)
    ranks_path = os.path.join(work, f"{name}_ranks.npz")
    losses, grads, times, launches, dev = mesh_steps(trainer, opt, ref["batch"], ref["dev"],
                                                    ranks_path)
    failed = []
    worst, worst_leaf = leaf_ratios(grads, ref["grads"])
    if worst > 1.0:
        failed.append(f"gradient {worst_leaf} at {worst} of its bar")
    if not all(abs(g - w) <= 1e-5 * abs(w) for g, w in zip(losses, ref["losses"])):
        failed.append(f"losses {losses}, single {ref['losses']}")
    got = np.load(ranks_path)["ranks"]
    try:
        near, differ = mesh_rank_agreement(got, ref["ranks"], ref["logits"])
    except AssertionError as e:
        failed.append(str(e))
        near = differ = None
    per_pass = (MESH_STEPS + MESH_EVAL // 32) * 24, MESH_STEPS * 24
    if launches != per_pass:
        failed.append(f"launches {launches}, expected {per_pass}")
    with open(os.path.join(work, f"{name}_rank{rank}.json"), "w") as f:
        json.dump(dict(losses=losses, worst_grad_over_bar=worst, worst_leaf=worst_leaf,
                       dev_rank_rows_differ=differ, dev_near_tie_rows=near,
                       dev_mrr=dev["Eval_entity/mrr"], step_ms=times,
                       launches=dict(fwd=launches[0], bwd=launches[1]),
                       gloo_cuda=gloo_cuda_collectives(device) if name == "dp2" else None,
                       failed=failed), f)
    if failed:
        raise AssertionError(f"{name} rank {rank}: " + "; ".join(failed))


def gloo_cuda_collectives(device):
    """Which collectives gloo takes on CUDA tensors of ranks sharing a card:
    each tried once on the world group, "ok" or the error's first line."""
    import torch
    import torch.distributed as dist

    import datetime

    world = dist.get_world_size()
    # a group of its own with a short timeout: a refused call fails, not hangs
    g = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=60))
    x = torch.ones(4, device=device)
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=g),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0, group=g),
        "barrier": lambda: dist.barrier(group=g),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x,
                                              group=g),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=device), x, group=g),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=device), torch.ones(4 * world, device=device), group=g),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # the finding: what gloo refuses on the card
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def mesh_1x1_phase(device):
    """The MKGformer fine-tune through the mesh code on a world-size-1 NCCL
    group (``core/mesh.make_mesh`` of 1 x 1: a DeviceMesh), at full width,
    B=32, L=128, bf16, dropout on, 6 steps, in turns with the same steps
    with no mesh from the same weights (no mesh, mesh, no mesh, mesh): the
    losses and the dev ranks bit-equal, and the step times of each run (the
    median of steps 3-6; the mesh of one rank calls no collective)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mkg_analogy_tpu_torch.core.mesh import make_mesh

    t0 = time.perf_counter()
    batch_np = {k: v.cpu().numpy() for k, v in train_batch(torch.device("cpu")).items()}
    dev_np = mesh_features()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_", dir=".") as work:
        torch.cuda.set_device(device.index or 0)  # before the DeviceMesh, as a launcher would
        dist.init_process_group("nccl", init_method=f"file://{os.path.abspath(work)}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(dp=1, tp=1, devices=[device])
            if type(mesh).__name__ != "DeviceMesh" or mesh.mesh_dim_names != ("dp", "tp"):
                raise AssertionError(f"mesh_1x1: make_mesh gave {mesh!r}")
            for tag, m in (("no_mesh", None), ("mesh_1x1", mesh), ("no_mesh_again", None),
                           ("mesh_1x1_again", mesh)):
                trainer, opt = mesh_trainer(device, "bfloat16", m)
                path = os.path.join(work, f"{tag}.npz")
                losses, _, times, launches, _ = mesh_steps(trainer, opt, batch_np, dev_np, path,
                                                           steps=MESH_1X1_STEPS)
                runs[tag] = (losses, np.load(path)["ranks"], times, launches)
                del trainer, opt
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    base = runs["no_mesh"]
    for tag, (losses, ranks, _, launches) in runs.items():
        if losses != base[0] or not np.array_equal(ranks, base[1]) or launches != base[3]:
            raise AssertionError(f"mesh_1x1: {tag} differs from no mesh: {losses} vs {base[0]}")
    if not all(math.isfinite(x) for x in base[0]):
        raise AssertionError(f"mesh_1x1: losses {base[0]}")
    emit(dict(phase="mesh_1x1", B=TRAIN_BATCH, L=128, dtype="bfloat16", dropout=0.1,
              steps=MESH_1X1_STEPS, dev_examples=MESH_EVAL, backend="nccl", world_size=1,
              losses=base[0], losses_bit_equal=True, dev_ranks_bit_equal=True,
              launches=dict(fwd=base[3][0], bwd=base[3][1]),
              median_step_ms={tag: statistics.median(r[2][2:]) for tag, r in runs.items()},
              step_ms={tag: r[2] for tag, r in runs.items()},
              seconds=time.perf_counter() - t0, card=card_line()))


def sum_like_mesh(model, dp, tp):
    """Make the single process compute its products as a rank of a (dp, tp)
    mesh and the mesh's all-reduces do (in place). Every Dense takes the
    batch in ``dp`` blocks of rows, one product each (a rank's GEMM: cuBLAS
    may pick another kernel, and another summation order, for another row
    count; ``gemm_row_dependence`` measures it), concatenated, so a weight's
    gradient is the sum of the blocks' as the dp all-reduce sums the ranks'.
    Each Dense the rules split computes ``tp`` partial products and adds
    them (row-parallel: over its inputs' pieces, then the bias) or
    concatenates them (column-parallel: its outputs' pieces, so the input's
    gradient is summed over them). A reference for that mesh: a
    random-weight fp32 model amplifies the summation order alone far past
    the train phase's gradient bar (gloo_mesh_phases measures how far)."""
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.models.common import Dense
    from mkg_analogy_tpu_torch.parallel.shardings import _bounds, shard_params_spec

    spec = shard_params_spec(model) if tp > 1 else {}
    for name, m in model.named_modules():
        split = spec.get(f"{name}.weight")
        if not isinstance(m, Dense) or not (split or dp > 1):
            continue
        dim = None if not split else 0 if split[0] == "tp" else 1
        pieces = [] if dim is None else [_bounds(m.weight.shape[dim], tp, r) for r in range(tp)]

        def product(x, m=m, dim=dim, pieces=pieces):
            dt = m.compute_dtype
            x, w = x.to(dt), m.weight.to(dt)
            b = None if m.bias is None else m.bias.to(dt)
            if dim is None:
                return F.linear(x, w, b)
            if dim == 0:
                return torch.cat([F.linear(x, w[a:z], None if b is None else b[a:z])
                                  for a, z in pieces], dim=-1)
            y = sum(F.linear(x[..., a:z], w[:, a:z]) for a, z in pieces)
            return y if b is None else y + b

        def forward(x, product=product):
            return torch.cat([product(rows) for rows in x.chunk(dp, dim=0)], dim=0)

        m.forward = forward


def gemm_row_dependence(device):
    """Whether a row of an fp32 product (TF32 off) depends on the row count
    of its call, at the Dense shapes of the meshes' ranks: x (B·L, in) @
    w (out, in)ᵀ over the B=32 batch's 4096 rows, against its first 2048
    rows alone (a dp2 rank's); {"out x in": max |difference| of those
    rows} (0: the same bits)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(TRAIN_BATCH * 128, 3072, generator=g, device=device)
    w = torch.randn(3072, 3072, generator=g, device=device)
    half, out = x.shape[0] // 2, {}
    for n, k in ((768, 768), (384, 768), (768, 384), (3072, 768), (1536, 768), (768, 3072),
                 (768, 1536)):
        xs, ws = x[:, :k].contiguous(), w[:n, :k].contiguous()
        whole = F.linear(xs, ws)[:half]
        part = F.linear(xs[:half].contiguous(), ws)
        out[f"{n}x{k}"] = (whole - part).abs().max().item()
    return out


def gloo_reference(device, name, dp, tp, batch_np, dev_np, work):
    """The single process's MESH_STEPS fp32 steps, computing its products as
    a rank of the (dp, tp) mesh ``name`` does (``sum_like_mesh``; "single":
    as it stands), saved for the ranks of ``name`` (not "single"): losses,
    the first step's gradients, the dev ranks and logits of the starting
    weights. Returns (losses, gradients, ms a step, launches)."""
    import numpy as np
    import torch

    trainer, opt = mesh_trainer(device, "float32", eps=GLOO_EPS)
    if dp * tp > 1:
        sum_like_mesh(trainer.model, dp, tp)
    ranks_path = os.path.join(work, f"single_{name}_ranks.npz")
    with torch.inference_mode():  # the dev logits of the starting weights, for the near ties
        logits = []
        for i in range(0, MESH_EVAL, 32):
            b = trainer._put_batch({k: v[i:i + 32] for k, v in dev_np.items()})
            trans = trainer.model(**trainer._model_inputs(b))
            logits.append(trainer._answer_logits(trans[:, 0]).float().cpu().numpy())
    losses, grads, times, launches, _ = mesh_steps(trainer, opt, batch_np, dev_np, ranks_path)
    grads = {k: None if v is None else v.cpu() for k, v in grads.items()}
    if name != "single":
        torch.save(dict(batch=batch_np, dev=dev_np, losses=losses, grads=grads,
                        ranks=dict(ranks=np.load(ranks_path)["ranks"], label=dev_np["label"]),
                        logits=np.concatenate(logits)),
                   os.path.join(work, f"reference_{name}.pt"))
    del trainer, opt
    torch.cuda.empty_cache()
    return losses, grads, times, launches


def gloo_mesh_phases(device):
    """dp2, tp2 and dp2tp2: 2, 2 and 4 gloo ranks on cuda:0 (one process a
    rank, parallel/launch.spawn; the three meshes at once) over the
    full-width MKGformer and global batch of mesh_1x1, in fp32 (the
    CUDA-core kernels of rows 1-2, TF32 off), dropout on, MESH_STEPS steps
    each, held on every rank against the single process's steps on the same
    weights, batch and seeds, computing its products as that mesh's ranks do
    (``sum_like_mesh``: dp row blocks, tp pieces): each step's loss within
    1e-5 relative, every gradient leaf of the first step within 1e-3 of its
    largest |gradient| plus 1e-6 of the model's (the train phase's bar), the
    dev ranks of the starting weights equal but for near ties (another
    candidate within 1e-5 of the row's largest |logit|). The order alone
    moves this random-weight model's gradients up to a few times that bar:
    ``single`` reports, for each mesh, how far the plain single process
    lands from its order-matched copy (the order noise the bar cannot tell
    from a fault), and ``gemm_row_dependence`` whether cuBLAS's result for a
    row depends on the call's row count. Rows 1-2's launches are checked on
    each rank: 24 forward a train step and an eval batch, 24 backward a
    step. Step times: gloo, ranks sharing one card, not a scaling figure.
    AdamW's eps is GLOO_EPS in these runs. Returns the launches of every
    rank."""
    import threading

    import torch

    from mkg_analogy_tpu_torch.parallel.launch import spawn

    out, launches, single = {}, {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_", dir=".") as work:
        batch_np = {k: v.cpu().numpy() for k, v in train_batch(torch.device("cpu")).items()}
        dev_np = mesh_features()
        t0 = time.perf_counter()
        refs = {name: gloo_reference(device, name, dp, tp, batch_np, dev_np, work)
                for name, dp, tp in [("single", 1, 1)] + GLOO_MESHES}
        for name, (losses, grads, times, n) in refs.items():
            single[name] = dict(losses=losses, step_ms=times, launches=dict(fwd=n[0], bwd=n[1]))
            if name != "single":
                worst, leaf = leaf_ratios(refs["single"][1], grads)
                single[name]["plain_vs_this_worst_grad_over_bar"] = worst
                single[name]["plain_vs_this_leaf"] = leaf
        single.update(seconds=time.perf_counter() - t0)
        del refs
        rows = gemm_row_dependence(device)
        errors = []

        def run(name, dp, tp):
            try:
                t = time.perf_counter()
                spawn(_gloo_mesh_rank, [str(device)] * (dp * tp), work,
                      args=(name, dp, tp, work))
                out[name] = dict(dp=dp, tp=tp, seconds=time.perf_counter() - t)
            except BaseException as e:  # raised below
                errors.append((name, e))

        threads = [threading.Thread(target=run, args=m) for m in GLOO_MESHES]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise AssertionError(f"gloo meshes: {errors}") from errors[0][1]
        for name, dp, tp in GLOO_MESHES:
            ranks = []
            for r in range(dp * tp):
                with open(os.path.join(work, f"{name}_rank{r}.json")) as f:
                    ranks.append(json.load(f))
            launches[name] = [r["launches"] for r in ranks]
            out[name].update(
                ranks=ranks, losses=ranks[0]["losses"],
                median_step_ms=statistics.median(ranks[0]["step_ms"][1:]),
                timing_note="gloo, ranks sharing one card: not a scaling figure")
    emit(dict(phase="gloo_meshes", B=TRAIN_BATCH, L=128, dtype="float32", dropout=0.1,
              steps=MESH_STEPS, dev_examples=MESH_EVAL, backend="gloo", device=str(device),
              adamw_eps=GLOO_EPS, single=single, gemm_row_dependence=rows,
              seconds=time.perf_counter() - t_phase,
              bars=dict(loss_rel=1e-5, grad="1e-3 of the leaf's largest |grad| + 1e-6 of "
                        "the model's", dev_ranks="equal but near ties (1e-5)",
                        reference="the single process computing its products as the "
                        "mesh's ranks do (dp row blocks, tp pieces)"),
              card=card_line(), **out))
    return launches


# a rank of a 2 x 2 mesh at MKGformer's B=32 and 12 heads: the second dp
# half of the rows and the second tp half of the heads
MESH_RANK_ROWS, MESH_RANK_HEADS = slice(16, 32), slice(6, 12)
# (shape, Lq, Lk, geometry, flash tiles): the text tower with its analogy
# geometry (flash in 2 x 2 logical tiles of 64) and the vision tower
MESH_RANK_SHAPES = [("text", 128, 128, (0, None, 0), (64, 64)),
                    ("vision", 99, 99, None, (256, 512))]


def mesh_kernel_phase(device):
    """Rows 1-5's eight kernel sources as a rank of a 2 x 2 mesh calls them
    at MKGformer's shapes (B=32, 12 heads of 64): that rank's 16 rows and 6
    heads, dropout 0.1, ``cell_stride`` 12 and ``cell_offset`` 16 * 12 + 6;
    forward and backward through each wrapper's autograd (fused_attention,
    flash_attention), bf16 (the tensor-core kernels) and fp32 (the
    CUDA-core ones). Held against the plain version on the slice at the
    kernel phases' bars (forward 2e-5 fp32 / 2e-2 bf16 absolute; dq, dk
    and dv 2e-5 fp32 / 2^-7 bf16 of their largest |value|) and against the
    same kernels on the whole call, bit for bit on the rank's slice (its
    masks are the whole call's). Returns {kernel source: largest
    |difference| from the plain version}."""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    rows, heads = MESH_RANK_ROWS, MESH_RANK_HEADS
    offset = rows.start * HEADS + heads.start
    n_heads = heads.stop - heads.start

    def part(x):
        return x[rows, :, heads.start * HEAD_DIM:heads.stop * HEAD_DIM].contiguous()

    def run(fn, q, k, v, mask, g, h, kw):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, mask, h, **kw)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    errors, checks = {}, []
    for shape, lq, lk, geometry, tiles in MESH_RANK_SHAPES:
        for route in ("single", "flash"):
            fn = attn.fused_attention if route == "single" else fa.flash_attention
            ref_fwd = (attn.fused_attention_reference if route == "single"
                       else fa.flash_attention_reference)
            ref_bwd = (attn.fused_attention_bwd_reference if route == "single"
                       else fa.flash_attention_bwd_reference)
            for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
                q, k, v, mask, kw = attention_inputs(lq, lk, geometry, dtype, device,
                                                     seed=lq + 3, batch=TRAIN_BATCH)
                g = seeded_randn(q.shape, lk, device, dtype)
                kw = dict(kw, compute_dtype=dtype, dropout_rate=0.1, deterministic=False,
                          dropout_seed=2024)
                if route == "flash":
                    kw.update(block_q=tiles[0], block_k=tiles[1])
                pkw = dict(kw, cell_stride=HEADS, cell_offset=offset)
                if geometry is not None:
                    pkw["boundary"] = kw["boundary"][rows]
                pq, pk, pv, pg, pmask = part(q), part(k), part(v), part(g), mask[rows]
                whole = run(fn, q, k, v, mask, g, HEADS, kw)
                reset_counts()
                got = run(fn, pq, pk, pv, pmask, pg, n_heads, pkw)
                torch.cuda.synchronize()
                counts = all_counts()
                mma = int(tag == "bf16")
                launched = ((counts["single_fwd"], counts["single_bwd"]) if route == "single"
                            else (counts["flash_fwd"], counts["flash_dkv"], counts["flash_dq"],
                                  counts["flash_fwd_mma"], counts["flash_dkv_mma"],
                                  counts["flash_dq_mma"]))
                if launched != ((1, 1) if route == "single" else (1, 1, 1, mma, mma, mma)):
                    raise AssertionError(f"mesh_kernel {shape} {route} {tag}: launches {counts}")
                for name, a, b in zip(("out", "dq", "dk", "dv"), got, whole):
                    if not torch.equal(a, part(b)):
                        raise AssertionError(f"mesh_kernel {shape} {route} {tag} {name}: the "
                                             "rank's slice differs from the whole call's")
                want = [ref_fwd(pq, pk, pv, pmask, n_heads, **pkw)]
                want += list(ref_bwd(pq, pk, pv, pmask, pg, n_heads, **pkw)[:3])
                for i, (name, a, b) in enumerate(zip(("out", "dq", "dk", "dv"), got, want)):
                    err = (a.float() - b.float()).abs().max().item()
                    top = 1.0 if i == 0 else b.float().abs().max().item()
                    bar = (2e-5 if dtype == torch.float32 else 2e-2) if i == 0 else (
                        2e-5 if dtype == torch.float32 else 2.0 ** -7) * top
                    kernel = (f"{'fused' if route == 'single' else 'flash'}_attention_"
                              f"{'fwd' if i == 0 else 'bwd'}{'_mma' if tag == 'bf16' else ''}")
                    errors[kernel] = max(errors.get(kernel, 0.0), err)
                    checks.append(dict(shape=shape, route=route, dtype=tag, result=name,
                                       max_abs_err=err, bar=bar))
                    if not err <= bar:
                        raise AssertionError(f"mesh_kernel {shape} {route} {tag} {name}: "
                                             f"kernel vs plain {err} > {bar}")
    emit(dict(phase="mesh_kernel", B=TRAIN_BATCH, heads=HEADS, rank_rows=[rows.start, rows.stop],
              rank_heads=[heads.start, heads.stop], cell_stride=HEADS, cell_offset=offset,
              dropout=0.1, slice_bit_equal_to_whole_call=True, max_abs_err=errors,
              checks=checks, seconds=time.perf_counter() - t0))
    return errors


# Head widths other than 64 and 128 (csrc/attention_width.cuh: each runs
# the instance of its padded width, from a library of its own): widths that
# are not multiples of 8 (13, 20, 116: rows loaded element by element), the
# repo's small recipe (16: --hidden_size 32 --num_heads 2), MiniLM-L12-H384
# (32) and a width of each padded one up to 128: 56 (the padded library of
# 64) and 116, 120 (that of 128, the one padded instance whose blocks split
# a head into 64-column halves, the second of d - 64 columns). Rows 1-2 at
# MKGformer's vision over text K/V (B=32, 99 x 227), rows 3-5 at the triple
# pre-train's text calls (B=64, 96 x 96), 12 heads.
# Above 128: 136 ragged and 192 exact in the library of 192; 200 aligned,
# 250 not 16-byte aligned (element-wise staging) and 256 exact in that of 256.
# (40, 80, 96 and 112, each the one width of its padded library here, left
# to the `cuda` tests of tests/test_torch_port_head_widths.py: their 32
# libraries took 30-40 s of the build.)
HEAD_WIDTHS = (8, 13, 16, 20, 24, 32, 56, 116, 120, 136, 192, 200, 250, 256)
HEAD_WIDTH_SINGLE = ("vision_text", 32, 99, 227)
HEAD_WIDTH_FLASH = ("triple_text", 64, 96, 96)


def width_counts(d):
    """Launches at head_dim ``d`` by kernel: rows 1-2 (either route) and
    rows 3-5 (either route, and on the tensor cores)."""
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    out = {k: attn.WIDTH_LAUNCHES[k, d] for k in ("fwd", "bwd")}
    out.update({f"flash{k.lower()}": fa.WIDTH_LAUNCHES_FLASH[k, d]
                for k in ("", "_DKV", "_DQ", "_FWD_MMA", "_DKV_MMA", "_DQ_MMA")})
    return out


def sdpa_times(q, k, v, go, mask, heads, head_dim, n):
    """(forward ms, backward ms) of scaled_dot_product_attention on the same
    heads (the padding mask as a bias; no dropout): a yardstick only."""
    import torch
    import torch.nn.functional as F

    b = q.shape[0]

    def split(x):
        return x.view(b, x.shape[1], heads, head_dim).transpose(1, 2)

    qh, kh, vh = (split(x).detach().requires_grad_(True) for x in (q, k, v))
    gh = split(go)
    bias = ((1.0 - mask) * -10000.0).to(q.dtype)[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qh, kh, vh), gh)

    fwd = time_ms(sdpa, **n)
    return fwd, time_ms(sdpa_fwd_bwd, **n) - fwd


def head_widths_phase(device):
    """Rows 1-5 at every width of HEAD_WIDTHS, each through the library of
    its padded width (built in the build phase), in fp32 (CUDA cores) and
    bf16 (tensor cores): without a geometry and dropout, and with the
    analogy geometry and dropout 0.1, each against its plain version at the
    bars of the kernel phases (forward 2e-5 / 2e-2, lse 1e-5; backward 2e-5
    / 2^-7 of each result's largest, dw 1e-5 of its terms), each launch
    counted under its width (the fp32 kernels of rows 1-2 sweep K and V in
    tiles at every width). Then per width and dtype the kernels' times, the plain
    versions' (bf16), SDPA's where the width is a multiple of 8 (no
    multiplier in the timed calls) and the bounds of the real width; the
    registers and spills ptxas reported. A call at head_dim 257 raises a
    ValueError naming the limit, on either route."""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import build
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    widths = sorted({build.library_width(d) for d in HEAD_WIDTHS})
    resources = {}
    for w in widths:
        for name in build.ATTENTION_SOURCES:
            for r in build.resource_usage(name, w):
                resources[f"d{w}/{name}/{r['entry'][-48:]}"] = [
                    r["registers"], r["spill_store_bytes"], r["spill_load_bytes"]]
    emit(dict(phase="head_widths", padded_widths=widths,
              libraries=len(widths) * len(build.ATTENTION_SOURCES),
              registers_spill_store_load=resources))
    for fn in (attn.fused_attention, fa.flash_attention):
        q = torch.zeros(1, 4, 2 * 257, device=device, dtype=torch.bfloat16)
        try:
            fn(q, q, q, torch.ones(1, 4, device=device), 2, compute_dtype=torch.bfloat16)
        except ValueError as e:
            if "256" not in str(e):
                raise AssertionError(f"{fn.__name__} at head_dim 257: {e}") from e
        else:
            raise AssertionError(f"{fn.__name__} took head_dim 257")
    attn.WIDTH_LAUNCHES.clear()
    fa.WIDTH_LAUNCHES_FLASH.clear()
    n = dict(samples=5, per_sample=3)
    rows = []
    for d in HEAD_WIDTHS:
        row = dict(head_dim=d, padded_width=build.padded_width(d), heads=HEADS)
        _, b, lq, lk = HEAD_WIDTH_SINGLE
        _, fb, flq, flk = HEAD_WIDTH_FLASH
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for geometry, rate in ((None, 0.0), ((0, None, 0), 0.1)):
                key = f"{tag}{'_geometry_dropout' if rate else ''}"
                before = width_counts(d)

                def inputs(keys):
                    q, k, v, mask, kw = attention_inputs(lq, keys, geometry, dtype, device,
                                                         seed=d + keys, batch=b, head_dim=d)
                    return q, k, v, mask, dict(kw, compute_dtype=dtype, dropout_rate=rate,
                                               deterministic=rate == 0.0, dropout_seed=77)

                keys = lk
                q, k, v, mask, call = inputs(keys)
                got = attn.fused_attention(q, k, v, mask, HEADS, **call)
                want = attn.fused_attention_reference(q, k, v, mask, HEADS, **call)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                row[f"fwd_max_abs_err_{key}"] = err
                bar = 2e-5 if dtype == torch.float32 else 2e-2
                if not err <= bar:
                    raise AssertionError(f"head_dim {d} fwd {key}: kernel vs plain {err} > {bar}")
                g = seeded_randn(q.shape, d, device, dtype)
                row.update(bwd_errors(attn, f"head_dim {d} {key} ({lq} x {keys})", key, q, k,
                                      v, mask, g, call, rate, 77,
                                      2e-5 if dtype == torch.float32 else 2.0 ** -7))
                q, k, v, go, mask, kw = flash_inputs(fb, flq, flk, "text", geometry, dtype,
                                                     device, seed=d + flk, head_dim=d)
                row.update({f"flash_{n_}": e for n_, e in flash_errors(
                    fa, f"head_dim {d} {key}", key, q, k, v, go, mask, kw, rate, 78,
                    head_dim=d).items()})
                after = width_counts(d)
                mma = int(dtype == torch.bfloat16)
                want_n = dict(fwd=1, bwd=1, flash=1, flash_dkv=1, flash_dq=1,
                              flash_fwd_mma=mma, flash_dkv_mma=mma, flash_dq_mma=mma)
                if {k_: after[k_] - before[k_] for k_ in after} != want_n:
                    raise AssertionError(f"head_dim {d} {key}: launches by width "
                                         f"{before} -> {after}")
                del q, k, v, go, g, got, want
        # times, without a geometry or dropout (SDPA's yardstick applies)
        for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            nbytes = 2 if dtype == torch.bfloat16 else 4
            flops = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
            q, k, v, mask, kw = attention_inputs(lq, lk, None, dtype, device, seed=7, batch=b,
                                                 head_dim=d)
            g = seeded_randn(q.shape, 8, device, dtype)
            resolved = resolve_geometry(attn, q, kw, 0.0, 0)
            row[f"fwd_ms_{tag}"] = time_ms(
                lambda: attn._launch_fwd(q, k, v, mask, HEADS, *resolved), **n)
            row[f"bwd_ms_{tag}"] = time_ms(
                main_path_bwd(attn, q, k, v, mask, g, HEADS, resolved), **n)
            for kernel, times in (("fwd", bound_times), ("bwd", bwd_bound_times)):
                t_bytes, t_ops = times(b, lq, lk, nbytes, HEADS, d)
                t_ops *= BF16_FLOPS_PER_S / flops
                row[f"{kernel}_bound_ms_{tag}"] = max(t_bytes, t_ops)
                row[f"{kernel}_bound_by_{tag}"] = bound_by(t_bytes, t_ops)
            if dtype == torch.bfloat16:
                call = dict(compute_dtype=dtype)
                row["fwd_plain_ms"] = time_ms(
                    lambda: attn.fused_attention_reference(q, k, v, mask, HEADS, **call), **n)
                row["bwd_plain_ms"] = time_ms(
                    lambda: attn.fused_attention_bwd_reference(q, k, v, mask, g, HEADS, **call),
                    **n)
                row["fwd_library_ms"] = row["bwd_library_ms"] = None
                if d % 8 == 0:
                    row["fwd_library_ms"], row["bwd_library_ms"] = sdpa_times(
                        q, k, v, g, mask, HEADS, d, n)
            q, k, v, go, mask, kw = flash_inputs(fb, flq, flk, "text", None, dtype, device,
                                                 seed=7, head_dim=d)
            args = (HEADS, *resolve_geometry(fa, q, kw, 0.0, 0), fa.BLOCK_Q, fa.BLOCK_K)
            out, lse = fa._launch_fwd(q, k, v, mask, *args)
            delta = fa._delta(go, out, HEADS)
            row[f"flash_fwd_ms_{tag}"] = time_ms(lambda: fa._launch_fwd(q, k, v, mask, *args),
                                                 **n)
            row[f"flash_dkv_ms_{tag}"] = time_ms(
                lambda: fa._launch_bwd_dkv(q, k, v, mask, go, lse, delta, *args), **n)
            row[f"flash_dq_ms_{tag}"] = time_ms(
                lambda: fa._launch_bwd_dq(q, k, v, mask, go, lse, delta, *args), **n)
            for kernel in ("fwd", "dkv", "dq"):
                t_bytes, t_ops = flash_bound_times(kernel, fb, flq, flk, nbytes, HEADS, d,
                                                   flops_per_s=flops)
                row[f"flash_{kernel}_bound_ms_{tag}"] = max(t_bytes, t_ops)
                row[f"flash_{kernel}_bound_by_{tag}"] = bound_by(t_bytes, t_ops)
            if dtype == torch.bfloat16:
                call = dict(compute_dtype=dtype)
                row["flash_fwd_plain_ms"] = time_ms(
                    lambda: fa.flash_attention_reference(q, k, v, mask, HEADS, **call), **n)
                row["flash_bwd_plain_ms"] = time_ms(
                    lambda: fa.flash_attention_bwd_reference(q, k, v, mask, go, HEADS, out=out,
                                                             lse=lse, **call), **n)
                row["flash_fwd_library_ms"] = row["flash_bwd_library_ms"] = None
                if d % 8 == 0:
                    row["flash_fwd_library_ms"], row["flash_bwd_library_ms"] = sdpa_times(
                        q, k, v, go, mask, HEADS, d, n)
            del q, k, v, go, g, out, lse, delta
        row["launches"] = width_counts(d)
        rows.append(row)
        emit(dict(phase="head_widths", **row))
        torch.cuda.empty_cache()
    return rows


class PathCalls:
    """Within the block, keeps the first call of each kind that the models
    send to the single-block and flash wrappers (models/common.py's
    ATTENTION_BACKENDS, looked up at every call): its inputs, cloned, and
    its keyword arguments, by route, dtype, shapes, heads, geometry and
    dropout. The wrappers then run as they would: this launches nothing."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        import torch

        from mkg_analogy_tpu_torch.models import common

        self._saved = dict(common.ATTENTION_BACKENDS)

        def keeping(route, fn):
            def call(q, k, v, mask, num_heads, **kw):
                key = (route, str(q.dtype).split(".")[-1], tuple(q.shape), k.shape[1],
                       num_heads, kw.get("boundary") is not None,
                       kw.get("dropout_rate", 0.0) > 0.0)
                if key not in self.calls:
                    self.calls[key] = (
                        [t.detach().clone() for t in (q, k, v, mask)], num_heads,
                        {n: t.detach().clone() if torch.is_tensor(t) else t
                         for n, t in kw.items()})
                return fn(q, k, v, mask, num_heads, **kw)

            return call

        for route in ("single", "flash"):
            common.ATTENTION_BACKENDS[route] = keeping(route, self._saved[route])
        return self

    def __exit__(self, *exc):
        from mkg_analogy_tpu_torch.models import common

        common.ATTENTION_BACKENDS.update(self._saved)
        return False


def path_call_errors(calls, what):
    """Each call that PathCalls kept, with its own inputs, geometry, dropout
    rate and seed, through its kernels against their plain versions at the
    kernel phases' bars: rows 1-2 forward within 2e-5 fp32 / 2e-2 bf16 and
    backward (bwd_errors, a cotangent from a seed) within 2e-5 / 2^-7 of
    each result's largest; rows 3-5 by flash_errors. ``{call: errors}``;
    raises beyond a bar."""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    out = {}
    for i, (key, ((q, k, v, mask), heads, kw)) in enumerate(sorted(calls.items(), key=str)):
        route, dtype, shape, lk, _, geometry, dropout = key
        d = q.shape[2] // heads
        name = (f"{route}_{dtype}_B{shape[0]}_{shape[1]}x{lk}_heads{heads}_d{d}"
                f"{'_geometry' if geometry else ''}{'_dropout' if dropout else ''}")
        rate, seed = kw.get("dropout_rate", 0.0), kw.get("dropout_seed") or 0
        mask = mask.to(attn._acc_dtype(q)).contiguous()
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(i)).to(q.device, q.dtype)
        fp32 = q.dtype == torch.float32
        if route == "single":
            got = attn.fused_attention(q, k, v, mask, heads, **kw)
            want = attn.fused_attention_reference(q, k, v, mask, heads, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            bar = 2e-5 if fp32 else 2e-2
            if not err <= bar:
                raise AssertionError(f"{what} {name}: fwd kernel vs plain {err} > {bar}")
            row = {f"fwd_max_abs_err_{dtype}": err}
            row.update(bwd_errors(attn, f"{what} {name}", dtype, q, k, v, mask, g, kw, rate,
                                  seed, 2e-5 if fp32 else 2.0 ** -7, heads=heads))
        else:
            row = {f"flash_{n}": e for n, e in flash_errors(
                fa, f"{what} {name}", dtype, q, k, v, g, mask, kw, rate, seed, head_dim=d,
                heads=heads).items()}
        out[name] = row
    return out


def cli_widths_phase(device):
    """The slice's main paths at head widths other than 64 and 128, the
    launch counts set to 0 before each path and read after it.
    (a) The verify recipe's model (``--hidden_size 32 --num_layers 2
    --num_heads 2 --intermediate_size 64``: head_dim 16) through the CLI:
    a 2-epoch fine-tune and ``--only_test --checkpoint`` on its checkpoint,
    under ``--fused_attention 1`` and ``flash``, in fp32 and bf16, on a
    synthetic MARS/MarKG; the CLI builds the head_dim-16 libraries before
    its first batch; the retest gives the fit's ranks exactly; each fp32
    fit's per-epoch losses within 1e-5 relative of ``--fused_attention 0``'s
    (dropout on: the one logical tile of these lengths draws the
    single-block kernel's masks). (b) MiniLM-L12-H384's widths (384 wide,
    12 layers, 12 heads of 32, MLP 1536) in both towers, one full-length
    fine-tune step (B=32, L=128, dropout on) through ``single`` and
    ``flash``: fp32 against the plain attention at the train phase's bars,
    then 4 bf16 steps each (the loss finite and falling), 24 launches of
    each kernel a step, all at head_dim 32. Each path's calls, of each kind
    the models sent the kernels (PathCalls: the first of each route, dtype,
    shape, geometry and dropout), are then held against the plain versions
    with their own inputs, after the counts were read (path_call_errors)."""
    import numpy as np
    import torch

    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa
    from mkg_analogy_tpu_torch.models.common import DropoutRNG
    from mkg_analogy_tpu_torch.models.registry import create_model
    from mkg_analogy_tpu_torch.train.optim import make_optimizer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    t_start = time.perf_counter()
    out = dict(phase="cli_widths")
    small = ["--hidden_size", "32", "--num_layers", "2", "--num_heads", "2",
             "--intermediate_size", "64"]
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_widths_", dir=".") as root:
        markg, mars = write_dataset(root, n_train=64, n_test=48)

        def argv(name, *extra):
            return ["--data_dir", mars, "--pretrain_path", markg, "--device", "cuda",
                    "--max_seq_length", "48", "--text_vocab_size", "256",
                    "--batch_size", "8", "--eval_batch_size", "16", "--lr", "1e-3",
                    "--image_features", "synthetic", *small,
                    "--output_dir", os.path.join(root, name),
                    "--log_dir", os.path.join(root, name, "logs"),
                    "--cache_dir", os.path.join(root, "cache"), *extra]

        reset_counts()
        attn.WIDTH_LAUNCHES.clear()
        fa.WIDTH_LAUNCHES_FLASH.clear()
        calls_a = PathCalls()
        for fused, dtype in (("1", "float32"), ("1", "bfloat16"), ("flash", "float32"),
                             ("flash", "bfloat16"), ("0", "float32")):
            with calls_a:
                name = f"{fused}_{dtype}"
                with BuildOrder() as order:
                    metrics = cli.main(argv(name, "--fused_attention", fused, "--dtype", dtype,
                                            "--max_epochs", "2"))
                order.check(f"cli_widths {name}")
                order.check_widths(f"cli_widths {name}", [16])
                with open(os.path.join(root, name, "logs", "train_metrics.jsonl")) as f:
                    losses = [json.loads(line)["train/last_loss"] for line in f
                              if "train/last_loss" in line]
                ranks = np.load(os.path.join(root, name, "test_ranks.npz"))["ranks"]
                retest = cli.main(argv(name + "_retest", "--fused_attention", fused,
                                       "--dtype", dtype, "--only_test", "--checkpoint",
                                       os.path.join(root, name, "ckpt")))
                again = np.load(os.path.join(root, name + "_retest", "test_ranks.npz"))["ranks"]
                if not np.array_equal(again, ranks) or retest != metrics:
                    raise AssertionError(f"cli_widths {name}: --only_test --checkpoint did not "
                                         "reproduce the fit's test ranks")
                if not (losses and all(map(math.isfinite, losses))
                        and all(math.isfinite(v) for v in metrics.values())):
                    raise AssertionError(f"cli_widths {name}: losses {losses}, {metrics}")
                runs[name] = dict(losses=losses, test_mrr=metrics["Eval_entity/mrr"])
        counts = width_counts(16)
        out["path_a"] = dict(runs=runs, launches_head_dim_16=counts, widths=small)
        if not (all(counts.values()) and attn.LAUNCHES_D128 == 0):
            raise AssertionError(f"cli_widths (a): a kernel at head_dim 16 was not launched: "
                                 f"{counts}")
        plain = runs["0_float32"]["losses"]
        for name in ("1_float32", "flash_float32"):
            rel = max(abs(a - p) / abs(p) for a, p in zip(runs[name]["losses"], plain))
            runs[name]["loss_rel_diff_vs_plain"] = rel
            if not (len(runs[name]["losses"]) == len(plain) and rel <= 1e-5):
                raise AssertionError(f"cli_widths {name}: losses {runs[name]['losses']} vs "
                                     f"plain {plain}")

    # (b) MiniLM-L12-H384's widths, one full-length step
    batch = train_batch(device)
    minilm = dict(hidden_size=384, num_layers=12, num_heads=12, intermediate_size=1536)
    with torch.device(device):
        model = create_model("MKGformerKGC", vocab_size=42112, dtype="float32", **minilm)
    model.init_params(torch.Generator(device=device).manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(), device=device)
    grads = {}
    calls_b = PathCalls()
    for backend in ("single", "flash", "plain"):
        model.load_state_dict(state)
        set_backend(model, backend)
        model.zero_grad(set_to_none=True)
        with calls_b:
            loss, _ = trainer._finetune_loss(batch, DropoutRNG.from_seed(5, device))
        loss.backward()
        torch.cuda.synchronize()
        grads[backend] = (loss.item(), {n_: p.grad.clone() for n_, p in model.named_parameters()})
    lp, gp = grads.pop("plain")
    top = max(g.abs().max().item() for g in gp.values())
    fp32 = {}
    for backend, (lk_, gk) in grads.items():
        if not (math.isfinite(lk_) and abs(lk_ - lp) <= 1e-5 * abs(lp)):
            raise AssertionError(f"cli_widths (b) fp32 {backend}: loss {lk_} vs plain {lp}")
        worst = 0.0
        for name, want in gp.items():
            err = (gk[name] - want).abs().max().item()
            bound = 1e-3 * want.abs().max().item() + 1e-6 * top
            if not err <= bound:
                raise AssertionError(f"cli_widths (b) fp32 {backend} grad {name}: {err} > "
                                     f"{bound}")
            worst = max(worst, err / bound)
        fp32[backend] = dict(loss=lk_, loss_plain=lp, loss_rel_diff=abs(lk_ - lp) / abs(lp),
                             worst_err_over_bound=worst)
    del grads, gp, model, trainer
    torch.cuda.empty_cache()
    bf16 = {}
    for backend in ("single", "flash"):
        with torch.device(device):
            model = create_model("MKGformerKGC", vocab_size=42112, dtype="bfloat16",
                                 attention=backend, **minilm)
        model.load_state_dict(state)
        trainer = MarTTrainer(model, _AnalogyVocab(), TrainConfig(seed=3), device=device)
        opt = make_optimizer(model, 1e-4, 100, warmup_ratio=0.0)
        reset_counts()
        attn.WIDTH_LAUNCHES.clear()
        fa.WIDTH_LAUNCHES_FLASH.clear()
        losses, times = [], []
        for step in range(4):
            t0 = time.perf_counter()
            with calls_b:
                metrics = trainer._train_step(opt, batch, step)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
        counts = width_counts(32)
        want = (dict(fwd=96, bwd=96) if backend == "single" else
                dict(flash=96, flash_dkv=96, flash_dq=96, flash_fwd_mma=96,
                     flash_dkv_mma=96, flash_dq_mma=96))
        if {k_: counts[k_] for k_ in want} != want:
            raise AssertionError(f"cli_widths (b) bf16 {backend}: launches at head_dim 32 "
                                 f"{counts}, expected {want}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"cli_widths (b) bf16 {backend}: the loss did not fall: "
                                 f"{losses}")
        bf16[backend] = dict(losses=losses, step_ms=times, launches_head_dim_32=counts)
        del model, trainer, opt
        torch.cuda.empty_cache()
    out["path_b"] = dict(widths=minilm, B=TRAIN_BATCH, L=128, fp32=fp32, bf16=bf16)
    # the kernels on each path's own calls (their launches are not the paths')
    out["path_a"]["calls"] = path_call_errors(calls_a.calls, "cli_widths (a)")
    out["path_b"]["calls"] = path_call_errors(calls_b.calls, "cli_widths (b)")
    emit(dict(out, seconds=time.perf_counter() - t_start))
    return dict(a=out["path_a"]["launches_head_dim_16"],
                b={k: v["launches_head_dim_32"] for k, v in bf16.items()},
                calls=[row for p in ("path_a", "path_b") for row in out[p]["calls"].values()])


# Rows 1-2 at key counts the fp32 kernels once refused (whole K and V in a
# block): (name, B, Lq, Lk). Vision rows over a long text K/V (above the
# 717 keys the bf16 route was once capped at) and a square 1024.
LONG_KEY_SHAPES = [("vision_text_1100", 2, 99, 1100), ("square_1024", 2, 1024, 1024)]


def long_keys_phase(device):
    """Rows 1-2 at LONG_KEY_SHAPES (12 heads of 64, no geometry), fp32 (the
    tiled CUDA-core kernels) and bf16 (the tensor-core kernels),
    dropout 0 and 0.1, against the plain versions at the kernel phases'
    bars (forward 2e-5 / 2e-2; backward 2e-5 / 2^-7 of each result's
    largest), each launch counted; then per shape and dtype the kernels'
    times, the plain versions', SDPA's (no multiplier: it computes the same
    function) and the bounds. ViLT's 418 x 418 in fp32 runs in the kernel
    and kernel_bwd phases."""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn

    rows = []
    n = dict(samples=5, per_sample=3)
    for name, b, lq, lk in LONG_KEY_SHAPES:
        row = dict(shape=name, B=b, Lq=lq, Lk=lk, heads=HEADS, head_dim=HEAD_DIM)
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            fp32 = dtype == torch.float32
            for rate in (0.0, 0.1):
                key = f"{tag}{'_dropout' if rate else ''}"
                q, k, v, mask, kw = attention_inputs(lq, lk, None, dtype, device, seed=lk,
                                                     batch=b)
                kw = dict(kw, compute_dtype=dtype, dropout_rate=rate,
                          deterministic=rate == 0.0, dropout_seed=31)
                before = attn.LAUNCHES
                got = attn.fused_attention(q, k, v, mask, HEADS, **kw)
                want = attn.fused_attention_reference(q, k, v, mask, HEADS, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                row[f"max_abs_err_{key}"] = err
                bar = 2e-5 if fp32 else 2e-2
                if attn.LAUNCHES != before + 1 or not err <= bar:
                    raise AssertionError(f"long keys {name} {key}: kernel vs plain {err} > "
                                         f"{bar} (launches {attn.LAUNCHES - before})")
                g = seeded_randn(q.shape, lq, device, dtype)
                row.update(bwd_errors(attn, f"long keys {name} {key}", key, q, k, v, mask, g,
                                      kw, rate, 31, 2e-5 if fp32 else 2.0 ** -7))
            q, k, v, mask, kw = attention_inputs(lq, lk, None, dtype, device, seed=7, batch=b)
            g = seeded_randn(q.shape, 8, device, dtype)
            resolved = resolve_geometry(attn, q, kw, 0.0, 0)
            row[f"fwd_ms_{tag}"] = time_ms(
                lambda: attn._launch_fwd(q, k, v, mask, HEADS, *resolved), **n)
            row[f"bwd_ms_{tag}"] = time_ms(
                main_path_bwd(attn, q, k, v, mask, g, HEADS, resolved), **n)
            call = dict(compute_dtype=dtype)
            row[f"fwd_plain_ms_{tag}"] = time_ms(
                lambda: attn.fused_attention_reference(q, k, v, mask, HEADS, **call), **n)
            row[f"bwd_plain_ms_{tag}"] = time_ms(
                lambda: attn.fused_attention_bwd_reference(q, k, v, mask, g, HEADS, **call),
                **n)
            row[f"fwd_library_ms_{tag}"], row[f"bwd_library_ms_{tag}"] = sdpa_times(
                q, k, v, g, mask, HEADS, HEAD_DIM, n)
            flops = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
            for kernel, times in (("fwd", bound_times), ("bwd", bwd_bound_times)):
                t_bytes, t_ops = times(b, lq, lk, 4 if fp32 else 2)
                t_ops *= BF16_FLOPS_PER_S / flops
                row[f"{kernel}_bound_ms_{tag}"] = max(t_bytes, t_ops)
                row[f"{kernel}_bound_by_{tag}"] = bound_by(t_bytes, t_ops)
            del q, k, v, g, mask
        rows.append(row)
        emit(dict(phase="long_keys", **row))
        torch.cuda.empty_cache()
    return rows


WIDE_HEADS = ["--hidden_size", "768", "--num_heads", "3"]  # MKGformer's width, heads of 256


def cli_wide_phase():
    """The slice's path at full width: the CLI fine-tune of MKGformerKGC at
    width 768 with ``--num_heads 3`` (both towers: three heads of 256, the
    libraries of padded width 256 built by the CLI before its first batch),
    12 layers, on a synthetic MARS/MarKG (32 training examples at B=16,
    L=64), the launch counts set to 0 before each run and read after it:
    bf16 through ``--fused_attention 1`` and ``flash`` (2 steps each, the
    losses finite; every kernel of the route launched at head_dim 256);
    fp32 through ``1`` (the tiled CUDA-core kernels) and ``0``
    (the plain attention), one step each from the same seed
    (``--limit_train_batches 1``), the losses within 1e-5 relative (dropout
    on: the plain attention draws the single-block kernels' masks; after an
    AdamW update the two runs part by more, as each step's update divides
    last-bit gradient differences by their root mean square, which is why
    one step). Then each run's calls,
    of each kind the model sent the kernels (PathCalls), against the plain
    versions with their own inputs (path_call_errors)."""
    from mkg_analogy_tpu_torch.cli import main as cli
    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    t_start = time.perf_counter()
    runs = {}
    calls = PathCalls()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wide_", dir=".") as root:
        markg, mars = write_dataset(root, n_train=32, n_test=32)

        def argv(name, *extra):
            return ["--data_dir", mars, "--pretrain_path", markg, "--device", "cuda",
                    "--max_seq_length", "64", "--batch_size", "16", "--eval_batch_size", "32",
                    "--image_features", "synthetic", *WIDE_HEADS,
                    "--output_dir", os.path.join(root, name),
                    "--log_dir", os.path.join(root, name, "logs"),
                    "--cache_dir", os.path.join(root, "cache"), *extra]

        for fused, dtype, steps in (("1", "bfloat16", 2), ("flash", "bfloat16", 2),
                                    ("1", "float32", 1), ("0", "float32", 1)):
            name = f"{fused}_{dtype}"
            reset_counts()
            attn.WIDTH_LAUNCHES.clear()
            fa.WIDTH_LAUNCHES_FLASH.clear()
            t0 = time.perf_counter()
            with calls, BuildOrder() as order:
                metrics = cli.main(argv(name, "--fused_attention", fused, "--dtype", dtype,
                                        "--max_epochs", "1", "--limit_train_batches",
                                        str(steps)))
            seconds = time.perf_counter() - t0
            order.check_widths(f"cli_wide {name}", [256])
            counts = width_counts(256)
            with open(os.path.join(root, name, "logs", "train_metrics.jsonl")) as f:
                losses = [json.loads(line)["train/last_loss"] for line in f
                          if "train/last_loss" in line]
            if not (len(losses) == 1 and all(map(math.isfinite, losses))
                    and all(math.isfinite(v) for v in metrics.values())):
                raise AssertionError(f"cli_wide {name}: losses {losses}, {metrics}")
            want = {"1": ("fwd", "bwd"), "0": (),
                    "flash": ("flash", "flash_dkv", "flash_dq", "flash_fwd_mma",
                              "flash_dkv_mma", "flash_dq_mma")}[fused]
            if not all(counts[k] for k in want) or (fused == "0" and any(counts.values())):
                raise AssertionError(f"cli_wide {name}: launches at head_dim 256 {counts}")
            runs[name] = dict(steps=steps, losses=losses, test_mrr=metrics["Eval_entity/mrr"],
                              launches_head_dim_256=counts, seconds=seconds)
    plain = runs["0_float32"]["losses"]
    rel = max(abs(a - p) / abs(p) for a, p in zip(runs["1_float32"]["losses"], plain))
    runs["1_float32"]["loss_rel_diff_vs_plain"] = rel
    if not rel <= 1e-5:
        raise AssertionError(f"cli_wide fp32: losses {runs['1_float32']['losses']} vs plain "
                             f"{plain}")
    out = dict(phase="cli_wide", widths=WIDE_HEADS, head_dim=256, runs=runs,
               calls=path_call_errors(calls.calls, "cli_wide"))
    emit(dict(out, seconds=time.perf_counter() - t_start))
    return out


def width_entries(rows, launches, wide):
    """The {"kernels": ...} entries of rows 1-5 at the head widths of
    HEAD_WIDTHS: per row its time, plain, library and bound at MiniLM's
    width 32 (path (b)'s, at the phase's shapes), ``launches`` the main
    paths' (cli_widths: head_dim 16 through the CLI, 32 through the step,
    and in ``calls`` the errors on those paths' own calls; cli_wide
    (``wide``): head_dim 256 through the CLI at width 768), errors the
    largest over the widths, and per width its numbers."""
    at32 = next(r for r in rows if r["head_dim"] == 32)
    entries = []
    for kernel, source, line, pre, grads in (
            ("fused_attention_fwd", "fused_attention_fwd", "attention.py:124", "fwd", None),
            ("fused_attention_bwd", "fused_attention_bwd", "attention.py:159", "bwd",
             ("dq", "dk", "dv")),
            ("flash_attention_fwd", "flash_attention_fwd", "flash_attention.py:98",
             "flash_fwd", None),
            ("flash_attention_bwd_dkv", "flash_attention_bwd", "flash_attention.py:183",
             "flash_dkv", ("dk", "dv")),
            ("flash_attention_bwd_dq", "flash_attention_bwd", "flash_attention.py:271",
             "flash_dq", ("dq",))):
        flash = pre.startswith("flash")
        lead = "flash_" if flash else ""
        keys = ([f"{lead}fwd_max_abs_err_"] if grads is None else
                [f"{lead}max_abs_err_{t}_" for t in grads])

        count = {"fwd": "fwd", "bwd": "bwd", "flash_fwd": "flash_fwd_mma",
                 "flash_dkv": "flash_dkv_mma", "flash_dq": "flash_dq_mma"}[pre]
        wide_launches = sum(r["launches_head_dim_256"][count] for r in wide["runs"].values())
        path_calls = launches["calls"] + list(wide["calls"].values())
        plain = (f"{lead}fwd_plain_ms" if pre.endswith("fwd") else f"{lead}bwd_plain_ms")
        library = plain.replace("plain", "library")
        entries.append(dict(
            name=f"{kernel}_padded_widths", route="cuda",
            source=f"mkg_analogy_tpu_torch/csrc/{source}_mma.cu",
            source_fp32=f"mkg_analogy_tpu_torch/csrc/{source}.cu",
            replaces=f"mkg_analogy_tpu/kernels/{line}", ok=True,
            head_dims=list(HEAD_WIDTHS),
            launches=launches["a"][count] + sum(v[count] for v in launches["b"].values())
            + wide_launches, launches_wide_path=wide_launches,
            max_abs_err=max(r[k_ + t] for r in rows for k_ in keys
                            for t in ("bf16", "bf16_geometry_dropout")),
            max_abs_err_fp32=max(r[k_ + t] for r in rows for k_ in keys
                                 for t in ("fp32", "fp32_geometry_dropout")),
            # on the calls of paths (a) and (b), with their own inputs
            max_abs_err_main_paths=max(r[k_ + "bfloat16"] for r in path_calls
                                       for k_ in keys if k_ + "bfloat16" in r),
            max_abs_err_main_paths_fp32=max(r[k_ + "float32"] for r in path_calls
                                            for k_ in keys if k_ + "float32" in r),
            ms=at32[f"{pre}_ms_bf16"], ms_fp32=at32[f"{pre}_ms_fp32"],
            plain_ms=at32[plain], bound_ms=at32[f"{pre}_bound_ms_bf16"],
            bound_by=at32[f"{pre}_bound_by_bf16"], library_ms=at32[library],
            widths=[dict(head_dim=r["head_dim"], padded_width=r["padded_width"],
                         ms=r[f"{pre}_ms_bf16"], ms_fp32=r[f"{pre}_ms_fp32"],
                         bound_ms=r[f"{pre}_bound_ms_bf16"],
                         bound_ms_fp32=r[f"{pre}_bound_ms_fp32"], plain_ms=r[plain],
                         library_ms=r[library], launches=r["launches"][count])
                    for r in rows]))
    return entries


def flash_entry(rows, kernel, launches, edges):
    """One flash kernel's entry of the {"kernels": ...} line. Its times and
    bounds are per triple pre-train step at B=64 (12 text 96 x 96, 8 vision
    99 x 99 and 4 vision-text 99 x 195 calls, no analogy multiplier, so SDPA
    is the library yardstick of every call); plain_ms is the plain forward,
    or for both backward kernels the plain backward, which computes dq, dk
    and dv in one walk; library_ms likewise SDPA's forward or its whole
    backward; ms_fp32 and bound_ms_fp32 the fp32 route's kernel (the
    CUDA-core one) on the same calls, and the forward's library_ms_fp32
    SDPA's fp32 forward. Errors are the largest over every shape, and over
    the bf16 edge cases (``edges``, the errors of flash_edge_phase) in
    max_abs_err_edges."""
    name, source, source_fp32, line = FLASH_KERNELS[kernel]
    step = [r for r in rows if r["launches_per_triple_step"]]

    def per_step(key):
        return sum(r[key] * r["launches_per_triple_step"] for r in step)

    t_bytes, t_ops = per_step(f"{kernel}_bytes_ms"), per_step(f"{kernel}_operations_ms")
    if kernel == "fwd":
        err = [r[f"fwd_max_abs_err_{d}"] for r in rows for d in ("bf16", "bf16_dropout")]
        err32 = [r[f"fwd_max_abs_err_{d}"] for r in rows for d in ("fp32", "fp32_dropout")]
        edge_err = max(e for n, e in edges.items() if n.startswith("fwd_max_abs_err"))
        lse_err = max(e for r in rows for n, e in r.items() if n.startswith("lse_max_abs_err"))
    else:
        grads = ("dq",) if kernel == "dq" else ("dk", "dv")
        err = [r[f"max_abs_err_{t}_{d}"] for r in rows for t in grads
               for d in ("bf16", "bf16_dropout")]
        err32 = [r[f"max_abs_err_{t}_{d}"] for r in rows for t in grads
                 for d in ("fp32", "fp32_dropout")]
        edge_err = max(e for n, e in edges.items()
                       if n.startswith(tuple(f"max_abs_err_{t}" for t in grads)))
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
    # bf16 on the tensor cores, fp32 on the CUDA cores
    t_bytes, t_ops = (per_step(f"{kernel}_bytes_ms_fp32"),
                      per_step(f"{kernel}_operations_ms_fp32"))
    entry.update(source_fp32=f"mkg_analogy_tpu_torch/csrc/{source_fp32}",
                 ms_fp32=per_step(f"{kernel}_ms_fp32"), bound_ms_fp32=max(t_bytes, t_ops),
                 bound_by_fp32=bound_by(t_bytes, t_ops), max_abs_err_edges=edge_err)
    if kernel == "fwd":
        entry.update(lse_max_abs_err=lse_err, library_ms_fp32=per_step("library_fwd_ms_fp32"))
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
    # the eleven libraries and the attention libraries of HEAD_WIDTHS' padded
    # widths: one nvcc each, all started together, before any timed phase
    kernels = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    widths = sorted({build.library_width(d) for d in HEAD_WIDTHS})
    build.build_jobs([(name, None) for name in kernels]
                     + [(name, w) for w in widths for name in build.ATTENTION_SOURCES])
    emit(dict(phase="build", seconds=time.perf_counter() - t0, kernels=kernels,
              padded_widths=widths, width_libraries=len(widths) * len(build.ATTENTION_SOURCES),
              # what ptxas -v said of the tensor-core kernels (no profiler of
              # kernel internals runs everywhere)
              resources={name: build.resource_usage(name)
                         for name in ("fused_attention_fwd_mma", "fused_attention_bwd_mma",
                                      "flash_attention_fwd_mma", "flash_attention_bwd_mma",
                                      "fused_attention_fwd", "fused_attention_bwd",
                                      "flash_attention_fwd", "flash_attention_bwd",
                                      "gelu_poly", "adamw")}))
    rows, edge_err = kernel_phase(device)
    bwd_rows, bwd_edge_err = kernel_bwd_phase(device)
    gelu_rows = gelu_kernel_phase(device)
    adamw_rows = adamw_phase(device)
    model_phase(device)
    train_phase(device)
    eval_launches, eval_gelu_launches = cli_phase()
    launches = cli_train_phase()
    if not launches["fwd"] or not launches["bwd"]:
        raise AssertionError(f"the main path launched no kernel: {launches}")
    fit_prefetch_phase(device)
    qk_bf16_grad_phase(device)
    fused_qkv_phase(device)
    mesh_1x1_phase(device)
    mesh_launches = gloo_mesh_phases(device)
    mesh_kernel_errors = mesh_kernel_phase(device)
    flash_rows = flash_kernel_phase(device)
    flash_edges = flash_edge_phase(device)
    fp32_masked_row_err = fp32_masked_row_phase(device)
    kimi_row, kimi_launches, kimi_launches_adamw = kimi_vl_phase(device)
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
    if not all(tool_launches.values()) \
            or not all(n for k, n in image_launches.items() if not k.endswith("_d128")):
        raise AssertionError("the image path launched no kernel somewhere: tool "
                             f"{tool_launches}, fine-tune {image_launches}")
    region_rows, d128_masked_err = region_kernel_phase(device)
    flash_d128_rows, flash_d128_masked_err = flash_d128_kernel_phase(device)
    for name in REGION_FAMILIES:
        family_phase(device, name)
    region_launches = cli_region_phase()
    vil, vil_flash = region_launches["vilbert"], region_launches["vilbert_flash"]
    if not all(region_launches[name][f"single_{k}"] for name in REGION_FAMILIES
               for k in ("fwd", "bwd")) \
            or not vil["single_fwd_d128"] or not vil["single_bwd_d128"] \
            or not all(vil_flash[f"flash_{k}_mma{w}"] for k in ("fwd", "dkv", "dq")
                       for w in ("", "_d128")):
        raise AssertionError(f"the region path launched no kernel somewhere: {region_launches}")
    # the KGE silos: plain PyTorch (no TPU kernel lies on their path)
    kge = kge_data()
    kge_ikrl_phase(device, kge)
    kge_rsme_phase(device, kge)
    del kge
    cli_kge_phase()
    width_rows = head_widths_phase(device)
    width_launches = cli_widths_phase(device)
    long_rows = long_keys_phase(device)
    wide = cli_wide_phase()
    region_d64 = {k: sum(r[k] - r[f"{k}_d128"] for r in region_launches.values())
                  for k in ("single_fwd", "single_bwd")}
    d128_rows = [r for r in region_rows if r["head_dim"] == 128]
    visual = next(r for r in region_rows if r["shape"] == "vilbert_visual")

    def d128_entry(kernel, line, launches):
        """A head_dim-128 instantiation's entry: times and bounds of 6 calls
        at ViLBERT's visual stream (B=64, 72 x 72: a forward's 6 calls; a
        step's backward runs 5 of them); errors the largest over the
        head_dim-128 shapes."""
        pre = "" if kernel == "fwd" else "bwd_"
        n = visual["launches_per_forward"]
        if kernel == "fwd":
            err = [r[f"fwd_max_abs_err_{d}"] for r in d128_rows for d in ("bf16", "bf16_dropout")]
            err32 = [r[f"fwd_max_abs_err_{d}"] for r in d128_rows
                     for d in ("fp32", "fp32_dropout")]
        else:
            err = [r[f"max_abs_err_{t}_{d}"] for r in d128_rows for t in ("dq", "dk", "dv")
                   for d in ("bf16", "bf16_dropout")]
            err32 = [r[f"max_abs_err_{t}_{d}"] for r in d128_rows for t in ("dq", "dk", "dv")
                     for d in ("fp32", "fp32_dropout")]
        return dict(
            name=f"fused_attention_{kernel}_d128", route="cuda",
            source=f"mkg_analogy_tpu_torch/csrc/fused_attention_{kernel}_mma.cu",
            source_fp32=f"mkg_analogy_tpu_torch/csrc/fused_attention_{kernel}.cu",
            replaces=f"mkg_analogy_tpu/kernels/attention.py:{line}", head_dim=128, ok=True,
            launches=launches, max_abs_err=max(err), max_abs_err_fp32=max(err32),
            max_abs_err_fp32_masked_rows=d128_masked_err,
            ms=visual[f"{pre}kernel_ms"] * n, plain_ms=visual[f"{pre}plain_ms"] * n,
            bound_ms=visual[f"{pre}bound_ms"] * n, bound_by=visual[f"{pre}bound_by"],
            library_ms=visual[f"{pre}library_ms"] * n, shapes=d128_rows)

    def flash_d128_entry(kernel):
        """A flash kernel's head_dim-128 instances: times and bounds of the
        calls of one ViLBERT step at its visual stream (B=64, 72 x 72: 6
        forward calls, 5 of each backward kernel; plain_ms the plain forward
        or the plain backward, which computes dq, dk and dv in one walk,
        library_ms SDPA's forward or its whole backward); launches the
        ``--fused_attention flash`` CLI fit's; errors the largest over
        FLASH_D128_SHAPES."""
        name, source, source_fp32, line = FLASH_KERNELS[kernel]
        visual = flash_d128_rows[0]
        n = visual["launches_per_vilbert_step"][0 if kernel == "fwd" else 1]
        grads = ("dq",) if kernel == "dq" else ("dk", "dv")

        def errors(tag):
            keys = [f"fwd_max_abs_err_{tag}"] if kernel == "fwd" else [
                f"max_abs_err_{t}_{tag}" for t in grads]
            return max(r[k_ + d] for r in flash_d128_rows for k_ in keys
                       for d in ("", "_dropout"))

        plain, library = ("plain_fwd_ms", "library_fwd_ms") if kernel == "fwd" else (
            "plain_bwd_ms", "library_bwd_ms")
        return dict(
            name=f"{name}_d128", route="cuda", source=f"mkg_analogy_tpu_torch/csrc/{source}",
            source_fp32=f"mkg_analogy_tpu_torch/csrc/{source_fp32}",
            replaces=f"mkg_analogy_tpu/kernels/flash_attention.py:{line}", head_dim=128,
            ok=True, launches=vil_flash[f"flash_{kernel}_mma_d128"], max_abs_err=errors("bf16"),
            max_abs_err_fp32=errors("fp32"), max_abs_err_fp32_masked_rows=flash_d128_masked_err,
            ms=visual[f"{kernel}_ms"] * n, ms_fp32=visual[f"{kernel}_ms_fp32"] * n,
            plain_ms=visual[plain] * n, bound_ms=visual[f"{kernel}_bound_ms"] * n,
            bound_by=visual[f"{kernel}_bound_by"],
            bound_ms_fp32=visual[f"{kernel}_bound_ms_fp32"] * n,
            library_ms=visual[library] * n,
            shapes=[{k: v for k, v in r.items()
                     if k.startswith((kernel, "shape", "B", "L", "tiles", "keys", "geometry",
                                      plain, library))} for r in flash_d128_rows])

    def kimi_entry(kernel):
        """A flash kernel's causal instance with values 128 wide under heads
        of 192 (the ``-DMKG_ATTN_DP`` code of the 192-wide library): times
        and bounds of the 14 calls of one Kimi-VL step at its latent
        attention (B=32, 16 heads, 228 x 228; plain_ms the plain forward or
        the plain backward, which computes dq, dk and dv in one walk);
        launches those of the full-width KimiVLKGC step at head width 192
        (its CLIP tower's at 64 beside them); errors the largest at that
        shape."""
        name, source, _, line = FLASH_KERNELS[kernel]
        n = kimi_row["launches_per_step"]
        keys = ["fwd_max_abs_err"] if kernel == "fwd" else [
            f"max_abs_err_{t}" for t in (("dq",) if kernel == "dq" else ("dk", "dv"))]
        plain = "plain_fwd_ms" if kernel == "fwd" else "plain_bwd_ms"
        return dict(
            name=f"{name}_causal_d192_v128", route="cuda",
            source=f"mkg_analogy_tpu_torch/csrc/{source}",
            replaces=f"mkg_analogy_tpu/kernels/flash_attention.py:{line}", head_dim=192,
            head_dim_v=128, causal=True, ok=True, launches=kimi_launches[f"{kernel}_mma_d192"],
            launches_clip_d64=kimi_launches[f"{kernel}_mma_d64"],
            max_abs_err=max(kimi_row[f"{k}_{d}"] for k in keys for d in ("bf16", "bf16_dropout")),
            ms=kimi_row[f"{kernel}_ms"] * n, plain_ms=kimi_row[plain] * n,
            bound_ms=kimi_row[f"{kernel}_bound_ms"] * n, bound_by=kimi_row[f"{kernel}_bound_by"],
            library_ms=None,  # no single PyTorch call applies the analogy multiplier
            shapes=[kimi_row])

    def per_call_set(rows, key, n):
        return sum(r[key] * r[n] for r in rows)

    def adamw_entry():
        """Row 8: one step over Kimi-VL's 1.61 B parameters; FLAVA's and
        MKGformer's sets in ``shapes``; launches the fine-tune CLI's (one a
        step) and the Kimi-VL step's."""
        kimi = adamw_rows[0]
        return dict(
            name="adamw", route="cuda", source="mkg_analogy_tpu_torch/csrc/adamw.cu",
            replaces=None,  # optax.adamw (train/optim.py) is jnp that XLA fuses
            ok=True, launches=launches["adamw"], launches_kimi_vl_path=kimi_launches_adamw,
            differing_bits=0, ms=kimi["ms"], plain_ms=kimi["plain_ms"],
            bound_ms=kimi["bound_ms"], bound_by=kimi["bound_by"],
            library_ms=kimi["library_ms"],  # torch.optim.AdamW(foreach=True); never called
            shapes=adamw_rows)

    def gelu_entry(way):
        """Row 7's kernel ``way``: one call at MKGformer's text-layer FFN
        (B=32, L=128, 3072 wide), bf16; the other shapes and fp32 in
        ``shapes``; launches the fine-tune CLI's, and those of the other
        main paths."""
        mkg = gelu_rows[0]
        return dict(
            name=f"gelu_poly_{way}", route="cuda", source="mkg_analogy_tpu_torch/csrc/gelu_poly.cu",
            replaces=None,  # JAX's gelu_poly (models/common.py) is jnp that XLA fuses
            ok=True, launches=launches[f"gelu_{way}"],
            launches_eval_path=eval_gelu_launches if way == "fwd" else 0,
            launches_pretrain_path=flash_launches[f"gelu_{way}"],
            launches_image_path=image_launches[f"gelu_{way}"],
            launches_region_path=sum(r[f"gelu_{way}"] for r in region_launches.values()),
            differing_bits=0, ms=mkg[f"{way}_ms"], plain_ms=mkg[f"plain_{way}_ms"],
            bound_ms=mkg[f"{way}_bound_ms"], bound_by=mkg[f"{way}_bound_by"],
            library_ms=mkg[f"library_{way}_ms"],  # F.gelu in bf16 (exact erf)
            ms_fp32=mkg[f"{way}_ms_fp32"], bound_ms_fp32=mkg[f"{way}_bound_ms_fp32"],
            shapes=gelu_rows)

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
        # each rank's forward launches on the gloo meshes (fp32, CUDA cores)
        launches_mesh_path={k: [r["fwd"] for r in v] for k, v in mesh_launches.items()},
        launches_image_path=image_launches["single_fwd"],
        launches_region_path=region_d64["single_fwd"],
        launches_image_tool=tool_launches["attention_fwd"],
        max_abs_err=max(r[f"max_abs_err_bf16{d}"] for r in rows for d in ("", "_dropout")),
        max_abs_err_edges=edge_err,
        # on a 2 x 2 mesh rank's rows and heads (mesh_kernel_phase)
        max_abs_err_mesh_rank=mesh_kernel_errors["fused_attention_fwd_mma"],
        max_abs_err_mesh_rank_fp32=mesh_kernel_errors["fused_attention_fwd"],
        max_abs_err_fp32=max(r["max_abs_err_fp32"] for r in rows if "fp32" not in r),
        # the four fp32 CUDA-core kernels at rows whose keys are all masked
        max_abs_err_fp32_masked_rows=fp32_masked_row_err,
        # per full-width forward at B=128: 12 text + 8 vision + 4 vision-text calls
        ms=per_call_set(rows, "kernel_ms", "launches_per_forward"),
        plain_ms=per_call_set(rows, "plain_ms", "launches_per_forward"),
        bound_ms=max(t_bytes, t_ops), bound_by=bound_by(t_bytes, t_ops),
        library_ms=None,  # no single PyTorch call applies the analogy multiplier
        # the same set of calls on the fp32 route (the tiled CUDA-core kernel)
        ms_fp32=per_call_set(rows, "kernel_ms_fp32", "launches_per_forward"),
        plain_ms_fp32=per_call_set(rows, "plain_ms_fp32", "launches_per_forward"),
        bound_ms_fp32=per_call_set(rows, "bound_ms_fp32", "launches_per_forward"),
        shapes=rows, shapes_region=[r for r in region_rows if r["head_dim"] == 64],
        # both dtypes at 99 x 1100 and 1024 x 1024 (fp32 at 418 in ``shapes``)
        max_abs_err_long_keys=max(r[f"max_abs_err_bf16{d}"] for r in long_rows
                                  for d in ("", "_dropout")),
        max_abs_err_long_keys_fp32=max(r[f"max_abs_err_fp32{d}"] for r in long_rows
                                       for d in ("", "_dropout")),
        shapes_long_keys=[{k: v for k, v in r.items() if not k.startswith("bwd")}
                          for r in long_rows],
    ), dict(
        name="fused_attention_bwd", route="cuda",
        source="mkg_analogy_tpu_torch/csrc/fused_attention_bwd_mma.cu",  # bf16, every main path
        source_fp32="mkg_analogy_tpu_torch/csrc/fused_attention_bwd.cu",
        replaces="mkg_analogy_tpu/kernels/attention.py:159",
        ok=True, launches=launches["bwd"],
        launches_mesh_path={k: [r["bwd"] for r in v] for k, v in mesh_launches.items()},
        launches_image_path=image_launches["single_bwd"],
        launches_region_path=region_d64["single_bwd"],
        max_abs_err=max(r[f"max_abs_err_{t}_bf16{d}"] for r in bwd_rows
                        for t in ("dq", "dk", "dv") for d in ("", "_dropout")),
        max_abs_err_edges=bwd_edge_err,
        max_abs_err_mesh_rank=mesh_kernel_errors["fused_attention_bwd_mma"],
        max_abs_err_mesh_rank_fp32=mesh_kernel_errors["fused_attention_bwd"],
        max_abs_err_fp32=max(r[f"max_abs_err_{t}_fp32{d}"] for r in bwd_rows
                             if "fp32" not in r
                             for t in ("dq", "dk", "dv") for d in ("", "_dropout")),
        max_abs_err_fp32_masked_rows=fp32_masked_row_err,
        max_abs_err_long_keys=max(r[f"max_abs_err_{t}_bf16{d}"] for r in long_rows
                                  for t in ("dq", "dk", "dv") for d in ("", "_dropout")),
        max_abs_err_long_keys_fp32=max(r[f"max_abs_err_{t}_fp32{d}"] for r in long_rows
                                       for t in ("dq", "dk", "dv") for d in ("", "_dropout")),
        shapes_long_keys=[{k: v for k, v in r.items() if not k.startswith("fwd")}
                          for r in long_rows],
        # per full-width train step at B=32: 12 text + 8 vision + 4 vision-text calls
        ms=per_call_set(bwd_rows, "kernel_ms", "launches_per_step"),
        plain_ms=per_call_set(bwd_rows, "plain_ms", "launches_per_step"),
        bound_ms=max(b_bytes, b_ops), bound_by=bound_by(b_bytes, b_ops),
        library_ms=None,  # per shape below: SDPA's backward at the vision shapes
        ms_fp32=per_call_set(bwd_rows, "kernel_ms_fp32", "launches_per_step"),
        plain_ms_fp32=per_call_set(bwd_rows, "plain_ms_fp32", "launches_per_step"),
        bound_ms_fp32=per_call_set(bwd_rows, "bound_ms_fp32", "launches_per_step"),
        shapes=bwd_rows,
    ), d128_entry("fwd", 124, vil["single_fwd_d128"]),
        d128_entry("bwd", 159, vil["single_bwd_d128"])] + [dict(flash_entry(flash_rows, kernel, flash_launches[f"{kernel}_mma"], flash_edges),
               launches_image_path=image_launches[f"flash_{kernel}_mma"],
               launches_region_path=vil_flash[f"flash_{kernel}_mma"]
               - vil_flash[f"flash_{kernel}_mma_d128"],
               max_abs_err_fp32_masked_rows=fp32_masked_row_err,
               max_abs_err_mesh_rank=mesh_kernel_errors[
                   f"flash_attention_{'fwd' if kernel == 'fwd' else 'bwd'}_mma"],
               max_abs_err_mesh_rank_fp32=mesh_kernel_errors[
                   f"flash_attention_{'fwd' if kernel == 'fwd' else 'bwd'}"])
          # the bf16 main paths' launches, all on the tensor cores
          for kernel in ("fwd", "dkv", "dq")] + [
        flash_d128_entry(kernel) for kernel in ("fwd", "dkv", "dq")] + [dict(
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
    ), gelu_entry("fwd"), gelu_entry("bwd"), adamw_entry()] + width_entries(width_rows, width_launches, wide)
        + [kimi_entry(kernel) for kernel in ("fwd", "dkv", "dq")]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
