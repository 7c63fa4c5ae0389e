"""Matrix-product FLOPs of one FLAVA forward and the shapes of its attention
calls, from the configuration's sizes (2 flops a multiply-add).

A forward of one example at padded text length L: the patch embedding (two
images); ``image_layers`` layers over Ni = 2 x (size / patch)^2 + 1 tokens,
``num_layers`` text layers over L, the two projections into the multimodal
tower and ``multimodal_layers`` layers over M = 1 + Ni + L tokens (each
layer: Q/K/V/out, the MLP, QKᵀ and PV over its own tokens); the MLM
transform at the gathered positions and the decoder over the analogy
entities at the mask position.
"""

GATHERED_POSITIONS = 5  # [mask, rel_ex, rel_q, q_head, a_head]


def image_tokens(cfg) -> int:
    return 2 * (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1


def _layer(tokens, h, inner):
    return 8 * tokens * h * h + 4 * tokens * h * inner + 4 * tokens * tokens * h


def forward_flops(cfg, seq_len: int) -> float:
    """FLOPs of the forward of one example."""
    h, inner = cfg["hidden_size"], cfg["intermediate_size"]
    ni, L = image_tokens(cfg), seq_len
    m = 1 + ni + L
    total = 2 * (ni - 1) * 3 * cfg["patch_size"] ** 2 * h
    total += cfg["image_layers"] * _layer(ni, h, inner)
    total += cfg["num_layers"] * _layer(L, h, inner)
    total += 2 * (ni + L) * h * h
    total += cfg["multimodal_layers"] * _layer(m, h, inner)
    total += 2 * GATHERED_POSITIONS * h * h + 2 * h * cfg["analogy_entities"]
    return float(total)


def attention_calls(cfg, batch: int, seq_len: int):
    """The attention calls of one forward: dicts of b, heads, lq, lk,
    head_dim and count."""
    heads = cfg["num_heads"]
    d, ni = cfg["hidden_size"] // heads, image_tokens(cfg)
    m = 1 + ni + seq_len
    return [dict(b=batch, heads=heads, lq=n, lk=n, head_dim=d, count=c)
            for n, c in ((ni, cfg["image_layers"]), (seq_len, cfg["num_layers"]),
                         (m, cfg["multimodal_layers"]))]
