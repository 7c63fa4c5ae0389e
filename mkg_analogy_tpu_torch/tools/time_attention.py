"""Time the single-block attention kernels of one checkout on the card, to
compare two checkouts in one call (run it for each, in turns):

    python3 mkg_analogy_tpu_torch/tools/time_attention.py --root <checkout>

bf16, the tensor-core kernels (or with ``--dtype float32`` the CUDA-core
ones), at the MKGformer main path's shapes (12
heads of 64: text 128 x 128 with the analogy multiplier, vision 99 x 99,
vision over text K/V 99 x 227; the forward at B=128, the backward at B=32
with dropout 0.1 where the multiplier applies), and with ``--head_dim 128``
at ViLBERT's visual stream too (8 heads of 128, 72 x 72, B=64). With
``--flash``, the three tensor-core flash kernels instead (forward, dK/dV,
dQ) at the triple pre-train shapes (B=64, 12 heads of 64: text 96 x 96,
vision 99 x 99, vision over text K/V 99 x 195, the logical tiles of one
call), with dropout 0 and 0.1. Any other ``--head_dim`` from 1 to 256
times the same shapes with 12 heads of that width (the instance of its
padded width, kernels/build.py:library_width; above 128 at half the
batch). Prints one JSON line: the card, each
shape's ms (median of 21 samples of 10 calls, by CUDA events), and each
set's sum weighted by its calls a forward or step (12 / 8 / 4). Imports the
``mkg_analogy_tpu_torch`` of ``--root``, whose kernels it builds there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = [("text", 128, 128, True, 12, 64, 12), ("vision", 99, 99, False, 8, 64, 12),
          ("vision_text", 99, 227, False, 4, 64, 12)]
D128_SHAPE = ("vilbert_visual", 72, 72, False, 6, 128, 8)
FLASH_SHAPES = [("text", 96, 96, 12), ("vision", 99, 99, 8), ("vision_text", 99, 195, 4)]


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
                   help="the single-block kernels' dtype (float32: the CUDA-core ones)")
    args = p.parse_args(argv)
    if not 1 <= args.head_dim <= 256:
        p.error(f"--head_dim {args.head_dim}: the kernels take 1 to 256")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    from mkg_analogy_tpu_torch.kernels import attention as attn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.flash:
        rows, sets = time_flash(args.head_dim)
        print(json.dumps(dict(card=card, root=args.root, flash=True, shapes=rows,
                              per_set_ms=sets)))
        return 0
    dtype = getattr(torch, args.dtype)
    shapes = SHAPES + ([D128_SHAPE] if args.head_dim == 128 else [])
    if args.head_dim not in (64, 128):
        shapes = [shape[:5] + (args.head_dim,) + shape[6:] for shape in SHAPES]
    rows, sets = [], {}
    for name, lq, lk, geometry, calls, d, heads in shapes:
        gen = torch.Generator().manual_seed(7)
        row = dict(shape=name, Lq=lq, Lk=lk, head_dim=d)
        for kind, b in (("fwd", 64 if d >= 128 else 128), ("bwd", 64 if d == 128 else
                                                              16 if d > 128 else 32)):
            q, g = (torch.randn(b, lq, heads * d, generator=gen).to("cuda", dtype)
                    for _ in range(2))
            k, v = (torch.randn(b, lk, heads * d, generator=gen).to("cuda", dtype)
                    for _ in range(2))
            mask = torch.ones(b, lk, device="cuda")
            mask[:, lk - 9:] = 0.0
            kw = {}
            if geometry:
                kw = dict(boundary=torch.full((b,), lq // 3, dtype=torch.int32, device="cuda"),
                          w0=torch.tensor([0.3], device="cuda"),
                          w1=torch.tensor([0.7], device="cuda"))
            rate = 0.1 if geometry and kind == "bwd" else 0.0
            bnd, w, geo, rate, seed = attn._resolve(q, kw.get("boundary"), kw.get("w0"),
                                                    kw.get("w1"), None, 0, 0, rate,
                                                    rate == 0.0, 99)
            if kind == "fwd":
                row["fwd_ms"] = time_ms(
                    lambda: attn._launch_fwd(q, k, v, mask, heads, bnd, w, geo, rate, seed))
            else:
                row["bwd_ms"] = time_ms(
                    lambda: attn._launch_bwd(q, k, v, mask, g, heads, bnd, w, geo, rate, seed))
            sets[f"{kind}_d{d}"] = sets.get(f"{kind}_d{d}", 0.0) + row[f"{kind}_ms"] * calls
        rows.append(row)
    print(json.dumps(dict(card=card, root=args.root, dtype=args.dtype, shapes=rows,
                          per_set_ms=sets)))
    return 0


def time_flash(d=64):
    """(rows, per-set sums) of the three tensor-core flash kernels at
    FLASH_SHAPES, bf16, B=64, 12 heads of ``d``, dropout 0 and 0.1."""
    import torch

    from mkg_analogy_tpu_torch.kernels import attention as attn
    from mkg_analogy_tpu_torch.kernels import flash_attention as fa

    rows, sets = [], {}
    for name, lq, lk, calls in FLASH_SHAPES:
        gen = torch.Generator().manual_seed(7)
        b, heads = 64, 12
        q, go = (torch.randn(b, lq, heads * d, generator=gen).to("cuda", torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(b, lk, heads * d, generator=gen).to("cuda", torch.bfloat16)
                for _ in range(2))
        mask = torch.ones(b, lk, device="cuda")
        mask[:, lk - 9:] = 0.0
        row = dict(shape=name, Lq=lq, Lk=lk)
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
                sets[key] = sets.get(key, 0.0) + row[key] * calls
        rows.append(row)
    return rows, sets


if __name__ == "__main__":
    sys.exit(main())
