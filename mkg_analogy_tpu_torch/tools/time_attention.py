"""Time the single-block attention kernels of one checkout on the card, to
compare two checkouts in one call (run it for each, in turns):

    python3 mkg_analogy_tpu_torch/tools/time_attention.py --root <checkout>

bf16, the tensor-core kernels (or with ``--dtype float32`` the CUDA-core
ones), at the MKGformer main path's shapes (12
heads of 64: text 128 x 128 with the analogy multiplier, vision 99 x 99,
vision over text K/V 99 x 227; the forward at B=128, the backward at B=32
with dropout 0.1 where the multiplier applies), at ViLT's 418 x 418 (the
multiplier over the text block from row 1; the forward at B=128, the
backward at B=32 with dropout 0.1) and at 99 x 1100 and 1024 x 1024 (B=2),
and with ``--head_dim 128`` at ViLBERT's visual stream too (8 heads of 128,
72 x 72, B=64). The backward is timed as the checkout's main path calls
it: from the fp32 forward's out and lse where its wrapper takes them. With
``--yardsticks`` also the plain versions and, where no multiplier applies,
scaled_dot_product_attention on the same inputs (and the backend that
ran). With ``--flash``, the three tensor-core flash kernels instead
(forward, dK/dV, dQ) at the triple pre-train shapes (B=64, 12 heads of 64:
text 96 x 96, vision 99 x 99, vision over text K/V 99 x 195, the logical
tiles of one call) and at FLAVA's fine-tune calls (B=24, 12 heads of 64:
text 128 x 128, image 393 x 393, multimodal 522 x 522; no multiplier, so
SDPA applies), with dropout 0 and 0.1 (with ``--dtype float32`` the
CUDA-core ones, and ``--yardsticks`` their plain versions, SDPA and
bounds). With ``--flash --causal`` and/or ``--head_dim_v``, the three at
latent attention's call instead (B=32, 16 heads, 228 x 228 with MarT's
multiplier over the text rows from 100, queries and keys of ``--head_dim``,
values of ``--head_dim_v``; 14 calls a step; ``--yardsticks`` adds the
causal bounds of port_bench/bounds_mla.py's formulas). With
``--fp32_step``, the full-width fp32 fine-tune step of
``--family`` (ViLT through the single-block kernels, FLAVA through the
flash ones) instead (chip_smoke.py:fp32_step_cost of this checkout, on the
package of ``--root``). Any other ``--head_dim`` from 1 to 256 times the same shapes
with 12 heads of that width (the instance of its padded width,
kernels/build.py:library_width; above 128 at half the batch). Prints one
JSON line: the card, each shape's ms (median of 21 samples of 10 calls, by
CUDA events), and each set's sum weighted by its calls a forward or step
(12 / 8 / 4; with ``--flash`` FLAVA's 12 / 12 / 6 a step in sets of their
own; the shapes of other models count 0). Imports the
``mkg_analogy_tpu_torch`` of ``--root``, whose kernels it builds there.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys

# (name, Lq, Lk, geometry (row_start, text_len) or None, calls a forward or
# step, head_dim, heads, forward batch or None for the width's default,
# backward batch or None)
SHAPES = [("text", 128, 128, (0, None), 12, 64, 12, None, None),
          ("vision", 99, 99, None, 8, 64, 12, None, None),
          ("vision_text", 99, 227, None, 4, 64, 12, None, None)]
OTHER_SHAPES = [("vilt", 418, 418, (1, 128), 0, 64, 12, 128, 32),
                ("long_keys_1100", 99, 1100, None, 0, 64, 12, 2, 2),
                ("square_1024", 1024, 1024, None, 0, 64, 12, 2, 2)]
D128_SHAPE = ("vilbert_visual", 72, 72, None, 6, 128, 8, None, None)
# (name, Lq, Lk, calls a step, batch, set): the triple pre-train's and FLAVA's
# fine-tune step's (text 12, image 12, multimodal 6 calls)
FLASH_SHAPES = [("text", 96, 96, 12, 64, ""), ("vision", 99, 99, 8, 64, ""),
                ("vision_text", 99, 195, 4, 64, ""),
                ("flava_text", 128, 128, 12, 24, "flava_"),
                ("flava_image", 393, 393, 12, 24, "flava_"),
                ("flava_multimodal", 522, 522, 6, 24, "flava_")]
FP32_FLOPS_PER_S = 67e12   # H100 SXM data sheet, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # the same, bf16 on the tensor cores


def time_ms(fn, samples=21, per_sample=10):
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    p.add_argument("--head_dim", type=int, default=64,
                   help="1 to 256: the shapes' head width (128 also times ViLBERT's "
                        "visual stream)")
    p.add_argument("--flash", action="store_true",
                   help="time the tensor-core flash kernels instead")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                   help="the kernels' dtype (float32: the CUDA-core ones)")
    p.add_argument("--yardsticks", action="store_true",
                   help="also time the plain versions and SDPA, and give the bounds")
    p.add_argument("--fp32_step", action="store_true",
                   help="time the full-width fp32 fine-tune step of --family instead")
    p.add_argument("--family", choices=("vilt", "flava"), default="vilt",
                   help="the family of --fp32_step")
    p.add_argument("--causal", action="store_true",
                   help="with --flash: latent attention's causal call instead")
    p.add_argument("--head_dim_v", type=int, default=None,
                   help="with --flash: the values' head width (default --head_dim)")
    args = p.parse_args(argv)
    if not 1 <= args.head_dim <= 256:
        p.error(f"--head_dim {args.head_dim}: the kernels take 1 to 256")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from mkg_analogy_tpu_torch.kernels import attention as attn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dtype = getattr(torch, args.dtype)
    if args.fp32_step:
        step = _chip_smoke().fp32_step_cost(torch.device("cuda"), args.family)
        print(json.dumps(dict(card=card, root=args.root, family=args.family, fp32_step=step)))
        return 0
    if args.flash:
        rows, sets = time_flash(args.head_dim, dtype, args.yardsticks, args.head_dim_v,
                                args.causal)
        print(json.dumps(dict(card=card, root=args.root, flash=True, dtype=args.dtype,
                              causal=args.causal, head_dim_v=args.head_dim_v or args.head_dim,
                              shapes=rows, per_set_ms=sets)))
        return 0
    shapes = SHAPES + ([D128_SHAPE] if args.head_dim == 128 else [])
    if args.head_dim not in (64, 128):
        shapes = [shape[:5] + (args.head_dim,) + shape[6:] for shape in SHAPES]
    if args.head_dim == 64:
        shapes += OTHER_SHAPES
    rows, sets = [], {}
    for name, lq, lk, geometry, calls, d, heads, fwd_b, bwd_b in shapes:
        gen = torch.Generator().manual_seed(7)
        row = dict(shape=name, Lq=lq, Lk=lk, head_dim=d)
        for kind, b in (("fwd", fwd_b or (64 if d >= 128 else 128)),
                        ("bwd", bwd_b or (64 if d == 128 else 16 if d > 128 else 32))):
            q, g = (torch.randn(b, lq, heads * d, generator=gen).to("cuda", dtype)
                    for _ in range(2))
            k, v = (torch.randn(b, lk, heads * d, generator=gen).to("cuda", dtype)
                    for _ in range(2))
            mask = torch.ones(b, lk, device="cuda")
            mask[:, lk - 9:] = 0.0
            kw, row_start, text_len = {}, 0, None
            if geometry:
                row_start, text_len = geometry
                kw = dict(boundary=torch.full((b,), min(lq, 128) // 3, dtype=torch.int32,
                                              device="cuda"),
                          w0=torch.tensor([0.3], device="cuda"),
                          w1=torch.tensor([0.7], device="cuda"))
            rate = 0.1 if geometry and kind == "bwd" else 0.0
            resolved = attn._resolve(q, kw.get("boundary"), kw.get("w0"), kw.get("w1"),
                                     text_len, row_start, 0, rate, rate == 0.0, 99)
            call = dict(kw, compute_dtype=dtype, row_start=row_start, text_len=text_len,
                        dropout_rate=rate, deterministic=rate == 0.0, dropout_seed=99)
            row[f"{kind}_B"] = b
            if kind == "fwd":
                row["fwd_ms"] = time_ms(
                    lambda: attn._launch_fwd(q, k, v, mask, heads, *resolved))
            else:
                row["bwd_ms"] = time_ms(backward_call(attn, q, k, v, mask, g, heads, resolved))
            if args.yardsticks:
                row.update(yardsticks(attn, kind, q, k, v, g, mask, heads, d, call, geometry))
            sets[f"{kind}_d{d}"] = sets.get(f"{kind}_d{d}", 0.0) + row[f"{kind}_ms"] * calls
            del q, g, k, v
        rows.append(row)
        torch.cuda.empty_cache()
    print(json.dumps(dict(card=card, root=args.root, dtype=args.dtype, shapes=rows,
                          per_set_ms=sets)))
    return 0


def _chip_smoke():
    """chip_smoke.py of this tool's own checkout, as a module (its helpers
    import the package at call time: the one of ``--root``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_checkout", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def backward_call(attn, q, k, v, mask, g, heads, resolved):
    """A backward call as the checkout's main path makes it: from the fp32
    forward's out and lse where its wrapper takes them (computed here,
    once), else from the inputs alone."""
    import torch

    residuals = ()
    if q.dtype == torch.float32 and "lse" in inspect.signature(attn._launch_bwd).parameters:
        residuals = (None, *attn._launch_fwd_cuda_cores(q, k, v, mask, heads, *resolved))
    return lambda: attn._launch_bwd(q, k, v, mask, g, heads, *resolved, *residuals)


def yardsticks(attn, kind, q, k, v, g, mask, heads, d, call, geometry):
    """The plain version's ms of one call, the bound (each input read and
    each output written once over 3.35 TB/s, or 4 (forward) / 10 (backward)
    B·heads·Lq·Lk·d flops over the dtype's peak, the larger) and, where no
    multiplier applies, SDPA's ms on the same inputs (without dropout) and
    the name of its longest kernel."""
    import torch
    import torch.nn.functional as F

    b, lq, _ = q.shape
    lk = k.shape[1]
    nbytes = q.element_size()
    flops = FP32_FLOPS_PER_S if q.dtype == torch.float32 else BF16_FLOPS_PER_S
    if kind == "fwd":
        plain = time_ms(lambda: attn.fused_attention_reference(q, k, v, mask, heads, **call),
                        samples=5, per_sample=2)
        moved = (2 * b * lq + 2 * b * lk) * heads * d * nbytes + b * lk * 4
        work = 4 * b * heads * lq * lk * d
    else:
        plain = time_ms(lambda: attn.fused_attention_bwd_reference(q, k, v, mask, g, heads,
                                                                   **call),
                        samples=5, per_sample=2)
        moved = (3 * b * lq + 4 * b * lk) * heads * d * nbytes + b * lk * 4
        work = 10 * b * heads * lq * lk * d
    t_bytes, t_ops = moved / 3.35e12 * 1e3, work / flops * 1e3
    out = {f"{kind}_plain_ms": plain, f"{kind}_bound_ms": max(t_bytes, t_ops),
           f"{kind}_bound_by": "bytes" if t_bytes >= t_ops else "operations",
           f"{kind}_library_ms": None, f"{kind}_library_kernel": None}
    if geometry is None and d % 8 == 0:
        def split(x):
            return x.view(b, x.shape[1], heads, d).transpose(1, 2).detach().requires_grad_(True)

        qh, kh, vh = split(q), split(k), split(v)
        gh = g.view(b, lq, heads, d).transpose(1, 2)
        bias = ((1.0 - mask) * -10000.0).to(q.dtype)[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qh, kh, vh), gh)

        fwd = time_ms(sdpa, samples=5, per_sample=2)
        fn = sdpa
        if kind == "fwd":
            out["fwd_library_ms"] = fwd
        else:
            out["bwd_library_ms"] = time_ms(sdpa_fwd_bwd, samples=5, per_sample=2) - fwd
            fn = sdpa_fwd_bwd
        out[f"{kind}_library_kernel"] = longest_kernel(fn)
    return out


def longest_kernel(fn):
    """The name of the device kernel that takes most of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0), e.key)
            for e in prof.key_averages()]
    return max(rows)[1][:90] if rows else None


def time_flash(d=64, dtype=None, with_yardsticks=False, dv=None, causal=False):
    """(rows, per-set sums) of the three flash kernels at FLASH_SHAPES (and
    at 128 ViLBERT's visual stream, 8 heads, 72 x 72, B=64), 12 heads of
    ``d``, dropout 0 and 0.1: on the tensor cores in bf16, on the CUDA cores
    in fp32; ``with_yardsticks`` also each kernel's bound (flash_bounds),
    the plain versions (the forward; one backward computing dq, dk and dv)
    and SDPA on the same inputs, without dropout. With ``causal`` or a value
    width ``dv``, latent attention's call alone (MLA_SHAPE), its bounds
    causal, no plain version or SDPA."""
    import torch
    import torch.nn.functional as F

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    dtype = dtype or torch.bfloat16
    if causal or dv is not None:
        return time_mla(fa, attn, d, dv or d, causal, dtype, with_yardsticks)
    shapes = [shape + (12,) for shape in FLASH_SHAPES]
    if d == 128:
        shapes.append(("vilbert_visual", 72, 72, 6, 64, "", 8))
    rows, sets = [], {}
    for name, lq, lk, calls, b, set_name, heads in shapes:
        gen = torch.Generator().manual_seed(7)
        q, go = (torch.randn(b, lq, heads * d, generator=gen).to("cuda", dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, lk, heads * d, generator=gen).to("cuda", dtype)
                for _ in range(2))
        mask = torch.ones(b, lk, device="cuda")
        mask[:, lk - 9:] = 0.0
        row = dict(shape=name, B=b, Lq=lq, Lk=lk, heads=heads, head_dim=d,
                   tiles=list(fa._blocks(lq, lk, fa.BLOCK_Q, fa.BLOCK_K)))
        for rate in (0.0, 0.1):
            bnd, w, geo, rate, seed = attn._resolve(q, None, None, None, None, 0, 0, rate,
                                                    rate == 0.0, 99)
            tiles = (fa.BLOCK_Q, fa.BLOCK_K)
            out, lse = fa._launch_fwd(q, k, v, mask, heads, bnd, w, geo, rate, seed, *tiles)
            delta = fa._delta(go, out, heads)
            tail = (heads, bnd, w, geo, rate, seed, *tiles)
            timed = {
                "fwd": lambda: fa._launch_fwd(q, k, v, mask, *tail),
                "dkv": lambda: fa._launch_bwd_dkv(q, k, v, mask, go, lse, delta, *tail),
                "dq": lambda: fa._launch_bwd_dq(q, k, v, mask, go, lse, delta, *tail),
            }
            for kernel, fn in timed.items():
                key = f"{kernel}_ms_dropout_{rate}"
                row[key] = time_ms(fn)
                sets[set_name + key] = sets.get(set_name + key, 0.0) + row[key] * calls
        if with_yardsticks:
            call = dict(compute_dtype=dtype)
            few = dict(samples=5, per_sample=2)
            row["fwd_plain_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, mask, heads, **call), **few)
            row["bwd_plain_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_reference(q, k, v, mask, go, heads, out=out,
                                                         lse=lse, **call), **few)
            for kernel in ("fwd", "dkv", "dq"):
                row[f"{kernel}_bound_ms"], row[f"{kernel}_bound_by"] = flash_bound(
                    kernel, b, lq, lk, heads, d, q.element_size(),
                    FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S)

            def split(x):
                return x.view(b, x.shape[1], heads, d).transpose(1, 2).detach().requires_grad_()

            qh, kh, vh = split(q), split(k), split(v)
            gh = go.view(b, lq, heads, d).transpose(1, 2)
            bias = ((1.0 - mask) * -10000.0).to(dtype)[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

            def sdpa_fwd_bwd():
                torch.autograd.grad(sdpa(), (qh, kh, vh), gh)

            row["fwd_library_ms"] = time_ms(sdpa, **few)
            row["bwd_library_ms"] = time_ms(sdpa_fwd_bwd, **few) - row["fwd_library_ms"]
            row["fwd_library_kernel"] = longest_kernel(sdpa)
            row["bwd_library_kernel"] = longest_kernel(sdpa_fwd_bwd)
        rows.append(row)
        del q, go, k, v
        torch.cuda.empty_cache()
    return rows, sets


# (name, L, calls a step, batch, heads, first text row, boundary): Kimi-VL's
# latent attention in the MarT cell, 100 image and 128 text positions
MLA_SHAPE = ("mla", 228, 14, 32, 16, 100, 140)


def time_mla(fa, attn, d, dv, causal, dtype, with_yardsticks):
    """(rows, per-set sums) of the three flash kernels at MLA_SHAPE, queries
    and keys of ``d``, values of ``dv``, dropout 0."""
    import torch

    name, n, calls, b, heads, row_start, bnd = MLA_SHAPE
    gen = torch.Generator().manual_seed(7)
    q, k = (torch.randn(b, n, heads * d, generator=gen).to("cuda", dtype) for _ in range(2))
    v, go = (torch.randn(b, n, heads * dv, generator=gen).to("cuda", dtype) for _ in range(2))
    mask = torch.ones(b, n, device="cuda")
    mask[:, n - 9:] = 0.0
    boundary = torch.full((b,), bnd, dtype=torch.int32, device="cuda")
    w0, w1 = torch.tensor([0.3], device="cuda"), torch.tensor([0.7], device="cuda")
    resolved = attn._resolve(q, boundary, w0, w1, n, row_start, 0, 0.0, True, 99)
    tail = (heads, *resolved, fa.BLOCK_Q, fa.BLOCK_K, None, causal)
    out, lse = fa._launch_fwd(q, k, v, mask, *tail)
    delta = fa._delta(go, out, heads)
    row = dict(shape=name, B=b, Lq=n, Lk=n, heads=heads, head_dim=d, head_dim_v=dv,
               causal=causal)
    timed = {"fwd": lambda: fa._launch_fwd(q, k, v, mask, *tail),
             "dkv": lambda: fa._launch_bwd_dkv(q, k, v, mask, go, lse, delta, *tail),
             "dq": lambda: fa._launch_bwd_dq(q, k, v, mask, go, lse, delta, *tail)}
    if with_yardsticks:  # the benchmark's causal bounds, of this tool's checkout
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
        from port_bench import bounds_mla
    sets = {}
    for kernel, fn in timed.items():
        row[f"{kernel}_ms"] = time_ms(fn)
        sets[f"mla_{kernel}_ms"] = row[f"{kernel}_ms"] * calls
        if with_yardsticks:
            t = bounds_mla.flash_bound_s(kernel, b, heads, n, n, d, dv, causal, "bfloat16")
            row[f"{kernel}_bound_ms"] = max(t) * 1e3
            row[f"{kernel}_bound_by"] = "bytes" if t[0] >= t[1] else "operations"
    return [row], sets


def flash_bound(kernel, b, lq, lk, heads, d, nbytes, flops_per_s):
    """(bound ms, "bytes" or "operations") of one flash kernel call
    (chip_smoke.py:flash_bound_times): each input read and each output
    written once over 3.35 TB/s, against its products (forward 2, dK/dV 4,
    dQ 3 of 2·B·heads·Lq·Lk·d flops) over ``flops_per_s``."""
    tensors, stats, products = {"fwd": ((2 * lq + 2 * lk), 1, 2),
                                "dkv": ((2 * lq + 4 * lk), 2, 4),
                                "dq": ((3 * lq + 2 * lk), 2, 3)}[kernel]
    moved = b * tensors * heads * d * nbytes + stats * b * heads * lq * 4 + b * lk * 4 + b * 4
    t_bytes = moved / 3.35e12 * 1e3
    t_ops = products * 2 * b * heads * lq * lk * d / flops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


if __name__ == "__main__":
    sys.exit(main())
