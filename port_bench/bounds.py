"""Peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W) and the byte and
operation bounds of an attention call.

The bound of a call is the larger of its bytes once over the HBM rate and
its operations over the peak of its dtype. The formulas are those the
port's kernel tables use (each input read once and each output written
once; 2 flops a multiply-add):

- forward: q, k, v in, the output out, the fp32 key mask and the int32
  boundary; QKᵀ and PV, 4·B·heads·Lq·Lk·d flops;
- backward: q, k, v and the output's gradient in, dq, dk, dv out, the mask
  and the boundary; QKᵀ recomputed, dV, dP, dQ and dK, 10·B·heads·Lq·Lk·d;
- the flash kernels one by one (forward; dK/dV; dQ), with the (B, heads,
  Lq) fp32 statistics they read or write.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # fp32: CUDA cores, TF32 off
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def fwd_bound_s(b, heads, lq, lk, head_dim, dtype):
    """(seconds for the bytes, seconds for the operations) of one forward."""
    hd, nb = heads * head_dim, DTYPE_BYTES[dtype]
    nbytes = (b * lq * hd + 2 * b * lk * hd + b * lq * hd) * nb + b * lk * 4 + b * 4
    flops = 4 * b * heads * lq * lk * head_dim
    return nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_PER_S[dtype]


def bwd_bound_s(b, heads, lq, lk, head_dim, dtype):
    """(seconds for the bytes, seconds for the operations) of one backward."""
    hd, nb = heads * head_dim, DTYPE_BYTES[dtype]
    nbytes = (3 * b * lq * hd + 4 * b * lk * hd) * nb + b * lk * 4 + b * 4
    flops = 10 * b * heads * lq * lk * head_dim
    return nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_PER_S[dtype]


def flash_bound_s(kernel, b, heads, lq, lk, head_dim, dtype):
    """(seconds for the bytes, seconds for the operations) of one call of a
    flash kernel: "fwd", "dkv" or "dq"."""
    hd, nb = heads * head_dim, DTYPE_BYTES[dtype]
    tensors, stats, products = {"fwd": (2 * lq + 2 * lk, 1, 2),
                                "dkv": (2 * lq + 4 * lk, 2, 4),
                                "dq": (3 * lq + 2 * lk, 2, 3)}[kernel]
    nbytes = b * tensors * hd * nb + stats * b * heads * lq * 4 + b * lk * 4 + b * 4
    flops = products * 2 * b * heads * lq * lk * head_dim
    return nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_PER_S[dtype]


def attention_bound_s(calls, dtype, backward: bool) -> float:
    """The summed bound of ``calls`` (dicts of b, heads, lq, lk, head_dim,
    count), forward and, with ``backward``, backward."""
    total = 0.0
    for c in calls:
        shape = (c["b"], c["heads"], c["lq"], c["lk"], c["head_dim"], dtype)
        t = max(fwd_bound_s(*shape))
        if backward:
            t += max(bwd_bound_s(*shape))
        total += c["count"] * t
    return total
