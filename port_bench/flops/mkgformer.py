"""Matrix-product FLOPs of one MKGformer forward and the shapes of its
attention calls, from the configuration's sizes (2 flops a multiply-add).

A forward of one example at padded text length L: the patch embedding; 12
vision layers over Nv = images x (size / patch)^2 + 1 tokens (Q/K/V/out
projections, the MLP, QKᵀ and PV over Nv keys, Nv + L from ``fusion_start``,
where the previous text layer's K/V are prepended); 12 text layers over L
tokens (projections, MLP, QKᵀ and PV, and from ``fusion_start`` the fusion's
two products over the vision states and ``fusion_dense``); the MLM
transform at the gathered positions and the decoder over the analogy
entities at the mask position.
"""

GATHERED_POSITIONS = 5  # [mask, rel_ex, rel_q, q_head, a_head]


def vision_tokens(cfg) -> int:
    return cfg["num_images"] * (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1


def forward_flops(cfg, seq_len: int) -> float:
    """FLOPs of the forward of one example."""
    h, inner, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_layers"]
    nv, L = vision_tokens(cfg), seq_len
    patch = 2 * (nv - 1) * 3 * cfg["patch_size"] ** 2 * h
    total = patch
    for i in range(n):
        fused = i >= cfg["fusion_start"]
        lk = nv + (L if fused else 0)
        total += 8 * nv * h * h + 4 * nv * h * inner + 4 * nv * lk * h
        total += 8 * L * h * h + 4 * L * h * inner + 4 * L * L * h
        if fused:
            total += 4 * L * nv * h + 2 * L * h * inner
    total += 2 * GATHERED_POSITIONS * h * h + 2 * h * cfg["analogy_entities"]
    return float(total)


def attention_calls(cfg, batch: int, seq_len: int):
    """The attention calls of one forward: dicts of b, heads, lq, lk,
    head_dim and count."""
    nv, heads = vision_tokens(cfg), cfg["num_heads"]
    d, n, f = cfg["hidden_size"] // heads, cfg["num_layers"], cfg["fusion_start"]
    calls = [dict(b=batch, heads=heads, lq=seq_len, lk=seq_len, head_dim=d, count=n),
             dict(b=batch, heads=heads, lq=nv, lk=nv, head_dim=d, count=min(f, n))]
    if n > f:
        calls.append(dict(b=batch, heads=heads, lq=nv, lk=nv + seq_len, head_dim=d,
                          count=n - f))
    return calls
