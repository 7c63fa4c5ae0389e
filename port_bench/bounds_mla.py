"""Byte and operation bounds of a causal flash call whose values are
narrower than its queries and keys (latent attention: d = 192, d_v = 128),
and of the grouped products of an expert layer, on one NVIDIA H100 SXM
(``port_bench/bounds.py``'s peaks).

A flash call of (B, heads, L, L, d, d_v), causal: the (query, key) pairs a
head computes are the L (L + 1) / 2 on or below the diagonal. Each input is
read once and each output written once:

- forward: q and k (L x heads·d), v (L x heads·d_v) in, the output (L x
  heads·d_v) and the lse out, the fp32 key mask and the int32 boundary;
  Q Kᵀ (d deep) and P V (d_v wide) over the pairs;
- dK/dV: q, k, v, the output's gradient g in (with lse and delta), dk and
  dv out; Sᵀ = K Qᵀ and dPᵀ = V gᵀ, then dV += Pᵀ g and dK += dSᵀ Q;
- dQ: q, k, v, g in (with lse and delta), dq out; S, dP and dQ += dS K.

A grouped product (m x k) times (k x n), per expert or over the rows of all
experts: 2 m k n flops; its operands read and its result written once, in
bf16.
"""

from __future__ import annotations

from port_bench.bounds import DTYPE_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS_PER_S


def pairs(lq: int, lk: int, causal: bool) -> int:
    """The (query, key) pairs of one head: all, or those with key <= query."""
    return lq * (lq + 1) // 2 if causal else lq * lk


def flash_bound_s(kernel, b, heads, lq, lk, d, dv, causal, dtype):
    """(seconds for the bytes, seconds for the operations) of one call of a
    flash kernel: "fwd", "dkv" or "dq"."""
    nb = DTYPE_BYTES[dtype]
    qk_rows, v_rows, stats, depth = {
        "fwd": (lq + lk, lk + lq, 1, d + dv),
        "dkv": (lq + 2 * lk, 2 * lk + lq, 2, 2 * d + 2 * dv),
        "dq": (2 * lq + lk, lk + lq, 2, 2 * d + dv)}[kernel]
    nbytes = (b * heads * (qk_rows * d + v_rows * dv) * nb + stats * b * heads * lq * 4
              + b * lk * 4 + b * 4)
    flops = 2 * b * heads * pairs(lq, lk, causal) * depth
    return nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_PER_S[dtype]


def call_bound_s(call, dtype, backward: bool) -> float:
    """The bound of one attention call (a dict of b, heads, lq, lk, head_dim
    and, for latent attention, head_dim_v and causal): the forward's and,
    with ``backward``, the dK/dV and dQ kernels', each the larger of its two
    bounds."""
    args = (call["b"], call["heads"], call["lq"], call["lk"], call["head_dim"],
            call.get("head_dim_v", call["head_dim"]), call.get("causal", False), dtype)
    kernels = ("fwd", "dkv", "dq") if backward else ("fwd",)
    return sum(max(flash_bound_s(k, *args)) for k in kernels)


def grouped_bound_s(products, experts: int, dtype) -> float:
    """The summed bound of grouped products, each (m, k, n, per_expert): an
    (m x k) by (k x n) product over ``experts`` groups whose ``per_expert``
    side ("b": the k x n operand, a weight; "out": the m x n result, a
    weight's gradient) is one matrix an expert, the other sides split by
    rows. The larger of its bytes (each read or written once) and its
    flops."""
    nb, total = DTYPE_BYTES[dtype], 0.0
    for m, k, n, per_expert in products:
        b_side = experts * k * n if per_expert == "b" else k * n
        out = experts * m * n if per_expert == "out" else m * n
        nbytes = (m * k + b_side + out) * nb
        total += max(nbytes / HBM_BYTES_PER_S, 2 * m * k * n / PEAK_FLOPS_PER_S[dtype])
    return total
