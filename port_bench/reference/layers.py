"""Plain fp32 building blocks of the reference models.

Written from the published architectures (BERT-base, CLIP-ViT, FLAVA) and
MarT's adaptive analogy mask, in plain ``torch`` operations: no kernel, no
cache, no batching trick. Parameters are a flat dict of tensors keyed by
name, so the same dict can be handed to the program through
``load_state_dict``.

Numerics: every matrix product goes through :meth:`Numerics.mm`, which by
default multiplies in fp32 (TF32 off, set by the caller). The control of a
bf16 configuration runs the same code with ``Numerics("fp8")``: each
product's two operands rounded to float8 e4m3 with a per-tensor scale (the
precision below bf16), summed in fp32, the gradient passed straight through
the rounding.

Dropout: the hidden-dropout masks are uniform draws of ``torch.rand`` from a
device generator seeded per step, in the order the layers run, and the
attention-dropout masks the counter hash of MarT's JAX kernels (lowbias32 of
the element index xor ``seed * 0x9E3779B9``), one seed an attention call
drawn from a host generator. :class:`DropoutDraws` derives both generators
from the step's seed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_BIAS = -10000.0  # additive bias of a padded key
FP8_MAX = 448.0      # largest finite float8 e4m3 value


def step_seed(seed: int, step: int) -> int:
    """The 63-bit seed of training step ``step`` under run seed ``seed``: a
    splitmix64 finaliser of the pair."""
    x = (seed * 0x9E3779B97F4A7C15 + step + 1) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) >> 1


class DropoutDraws:
    """The generators of one training forward: ``device`` for the hidden
    dropout, ``host`` for the attention calls' seeds (the step seed xor
    0x5DEECE66D)."""

    def __init__(self, seed: int, device):
        self.device = torch.Generator(device=device).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed ^ 0x5DEECE66D)

    def attention_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host))


class Numerics:
    """How matrix products are computed: "fp32" exactly, "bf16" or "fp8"
    with both operands rounded to bfloat16 or to float8 e4m3 (per-tensor
    scale), summed in fp32."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"numerics {mode!r}: fp32, bf16 or fp8")
        self.mode = mode

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return x
        if self.mode == "bf16":
            return x + (x.detach().to(torch.bfloat16).to(torch.float32) - x.detach())
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a), self.round(b))

    def linear(self, x, w, b=None):
        y = self.mm(x, w.t())
        return y if b is None else y + b

    def conv_patches(self, x, w, b, patch: int):
        """A conv of stride = kernel = ``patch`` (N, C, H, W) -> (N, P, out)
        as one product over the unfolded patches, patches row-major."""
        cols = F.unfold(x, patch, stride=patch)              # (N, C*p*p, P)
        y = self.mm(cols.transpose(1, 2), w.reshape(w.shape[0], -1).t())
        return y if b is None else y + b


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def gelu(x):
    """Exact erf gelu (BERT, FLAVA)."""
    return F.gelu(x)


def quick_gelu(x):
    """CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def clip(x, lo: float, hi: float):
    """clip with the gradient of a tie with a bound split evenly between x
    and the bound (``torch.minimum``/``torch.maximum`` of tensors), as the
    JAX formulation the configuration states."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def dropout(x, rate: float, draws: Optional[DropoutDraws]):
    """Keep where a uniform draw is at least ``rate``, kept values / (1 - rate)."""
    if draws is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=draws.device, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


# --------------------------------------------------------- attention dropout
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _keep_bits(idx, seeds, rate: float):
    x = idx ^ _mul32(seeds & _M32, 0x9E3779B9)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= int(rate * float(2 ** 32))


def _plane_keep(seeds, rows: int, cols: int, rate: float):
    """(..., rows, cols) keep bits of a plane of ``rows * cols`` indices for
    each seed (int64, any shape)."""
    dev = seeds.device
    idx = torch.arange(rows, device=dev)[:, None] * cols + torch.arange(cols, device=dev)[None, :]
    return _keep_bits(idx, seeds[..., None, None], rate)


def keep_single(b, heads, lq, lk, rate, seed, device):
    """(B, heads, Lq, Lk) keep mask of one call on the single-block route:
    one plane a (row, head), seed ``seed + b * heads + head``."""
    cells = torch.arange(b, device=device)[:, None] * heads + torch.arange(heads, device=device)
    return _plane_keep(cells + seed, lq, lk, rate)


def keep_flash(b, heads, lq, lk, rate, seed, device, block_q=256, block_k=512):
    """(B, heads, Lq, Lk) keep mask of one call on the flash route: logical
    tiles of ``min(block_q, Lq)`` rows by ``min(block_k, Lk)`` keys, each
    tile a plane of its own (row stride the tile's width, also in a ragged
    last tile) under the seed ``seed + ((b * heads + head) * n_q + qb) *
    n_k + kb``."""
    bq, bk = min(block_q, lq), min(block_k, lk)
    n_q, n_k = -(-lq // bq), -(-lk // bk)
    cells = torch.arange(b, device=device)[:, None] * heads + torch.arange(heads, device=device)
    keep = torch.empty(b, heads, lq, lk, dtype=torch.bool, device=device)
    for qb in range(n_q):
        r0, r1 = qb * bq, min((qb + 1) * bq, lq)
        for kb in range(n_k):
            c0, c1 = kb * bk, min((kb + 1) * bk, lk)
            tile = _plane_keep(seed + (cells * n_q + qb) * n_k + kb, bq, bk, rate)
            keep[:, :, r0:r1, c0:c1] = tile[:, :, :r1 - r0, :c1 - c0]
    return keep


# ------------------------------------------------------------------ attention
def analogy_multiplier(boundary, w0, w1, lq, lk, row_start, text_len):
    """(B, 1, Lq, Lk) multiplier of MarT's adaptive analogy mask: scores of
    example rows (``row_start`` <= row < boundary) on answer columns
    (boundary <= col < text_len) times clip(w0, 0, 0.5), of answer rows on
    answer columns times clip(w1, 0.5, 1), all else 1."""
    dev = boundary.device
    rows = torch.arange(lq, device=dev)[:, None]
    cols = torch.arange(lk, device=dev)[None, :]
    bnd = boundary.long()[:, None, None]
    col_answer = (cols >= bnd) & (cols < text_len)
    row_example = (rows >= row_start) & (rows < bnd)
    row_answer = rows >= bnd
    in_scope = (row_example | row_answer) & (rows < text_len)
    w0c, w1c = clip(w0, 0.0, 0.5), clip(w1, 0.5, 1.0)
    one = torch.ones((), device=dev)
    mult = torch.where(col_answer & in_scope & row_example, w0c,
                       torch.where(col_answer & in_scope, w1c, one))
    return mult[:, None]


def split_heads(x, heads):
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(1, 2)


def merge_heads(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def attention(num: Numerics, q, k, v, mask, heads, mult=None, keep=None, rate=0.0):
    """softmax(d^-1/2 Q Kᵀ · mult + (1 - mask) · -1e4), dropped by ``keep``,
    times V; (B, L, heads·d) packed in and out. ``mask`` (B, Lk) of 0/1."""
    qh, kh, vh = split_heads(q, heads), split_heads(k, heads), split_heads(v, heads)
    s = num.mm(qh, kh.transpose(-1, -2)) * (q.shape[-1] // heads) ** -0.5
    if mult is not None:
        s = s * mult
    s = s + ((1.0 - mask) * NEG_BIAS)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - rate), torch.zeros((), device=p.device))
    return merge_heads(num.mm(p, vh))


class AttentionCall:
    """One attention layer's call: the projections of ``prefix`` (query, key,
    value, out), the route's dropout masks and the analogy multiplier."""

    def __init__(self, num: Numerics, params, prefix: str, heads: int, route: str,
                 rate: float):
        self.num, self.p, self.prefix, self.heads = num, params, prefix, heads
        self.route, self.rate = route, rate

    def proj(self, name, x):
        return self.num.linear(x, self.p[f"{self.prefix}.{name}.weight"],
                               self.p.get(f"{self.prefix}.{name}.bias"))

    def __call__(self, x, mask, draws=None, mult=None, extra_kv=None, extra_mask=None,
                 want_kv=False):
        """(out, (k, v) or None, raw context before the out projection)."""
        q, k, v = self.proj("query", x), self.proj("key", x), self.proj("value", x)
        kv = (k, v) if want_kv else None
        if extra_kv is not None:
            k = torch.cat([extra_kv[0], k], dim=1)
            v = torch.cat([extra_kv[1], v], dim=1)
            mask = torch.cat([extra_mask, mask], dim=1)
        keep = None
        if draws is not None and self.rate > 0.0:
            seed = draws.attention_seed()
            b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
            make = keep_single if self.route == "single" else keep_flash
            keep = make(b, self.heads, lq, lk, self.rate, seed, q.device)
        ctx = attention(self.num, q, k, v, mask, self.heads, mult=mult, keep=keep,
                        rate=self.rate)
        return self.proj("out", ctx), kv, ctx


def tied_logits(num: Numerics, params, hidden, vocab_ids):
    """Logits of ``hidden`` (B, H) over the word-table rows ``vocab_ids``."""
    table = params["word_embeddings"][vocab_ids]
    return num.mm(hidden, table.t()) + params["mlm_bias"][vocab_ids]


def gather_positions(seq, positions):
    idx = positions.long()[:, :, None].expand(-1, -1, seq.shape[-1])
    return torch.gather(seq, 1, idx)


def mlm_transform(num: Numerics, params, x, eps):
    h = gelu(num.linear(x, params["mlm_transform.dense.weight"],
                        params["mlm_transform.dense.bias"]))
    return layer_norm(h, params["mlm_transform.ln.weight"], params["mlm_transform.ln.bias"], eps)


def text_embeddings(params, input_ids, token_type_ids, eps, rate, draws):
    n = input_ids.shape[1]
    x = (params["word_embeddings"][input_ids.long()]
         + params["text_embeddings.position_embeddings"][:n][None]
         + params["text_embeddings.token_type_embeddings"][token_type_ids.long()])
    x = layer_norm(x, params["text_embeddings.ln.weight"], params["text_embeddings.ln.bias"], eps)
    return dropout(x, rate, draws)

