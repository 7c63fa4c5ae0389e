"""Matrix-product FLOPs of one Kimi-VL-A3B (MarT backbone) forward and the
shapes of its attention calls, from the configuration's sizes (2 flops a
multiply-add).

A forward of one example at padded text length L: two images through
CLIP-ViT-B/32 (the patch embedding, 12 layers over 50 tokens each), the
projector (768 -> 2048 -> 2048) on their 100 states; then
``num_hidden_layers`` decoder layers over n = 100 + L positions: MLA's four
projections (q, the latent and its RoPE key, the latent's keys and values,
out), Q Kᵀ (192 deep) and P V (128 wide) over the causal half, n (n + 1) / 2
(query, key) pairs a head; a SwiGLU of ``intermediate_size`` in the first
``first_k_dense_replace`` layers, in the others the router (64 wide), the
shared experts (one SwiGLU of 2 x 1,408) and the held experts at their
expected share of a token's slots, experts_per_token x held / router = 0.75
(each slot one SwiGLU of 1,408); the decoder over the analogy entities at
the mask position.
"""

GATHERED_POSITIONS = 5  # [mask, rel_ex, rel_q, q_head, a_head]


def image_tokens(cfg) -> int:
    return cfg["num_images"] * ((cfg["image_size"] // cfg["patch_size"]) ** 2 + 1)


def held_slots_per_token(cfg) -> float:
    """The expected (token, held expert) pairs of a token: its k slots over
    the router's experts, of which this card holds ``n_routed_experts``."""
    return cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / cfg["router_experts"]


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def _vision(cfg) -> float:
    vh, vi, n_img = cfg["vision_hidden_size"], cfg["vision_intermediate_size"], cfg["num_images"]
    per = image_tokens(cfg) // n_img
    total = 2 * (per - 1) * 3 * cfg["patch_size"] ** 2 * vh
    total += cfg["vision_layers"] * (8 * per * vh * vh + 4 * per * vh * vi + 4 * per * per * vh)
    return n_img * total


def forward_flops(cfg, seq_len: int) -> float:
    """FLOPs of the forward of one example."""
    h = cfg["hidden_size"]
    heads, rank = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, pe, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    moe = cfg["moe_intermediate_size"]
    ni = image_tokens(cfg)
    n = ni + seq_len
    total = _vision(cfg) + 2 * ni * cfg["vision_hidden_size"] * h + 2 * ni * h * h
    mla = 2 * n * h * (heads * (nope + pe) + rank + pe + heads * vd)
    mla += 2 * n * rank * heads * (nope + vd)
    mla += 2 * heads * causal_pairs(n) * (nope + pe + vd)
    for i in range(cfg["num_hidden_layers"]):
        total += mla
        if i < cfg["first_k_dense_replace"]:
            total += 6 * n * h * cfg["intermediate_size"]
        else:
            total += 2 * n * h * cfg["router_experts"]
            total += 6 * n * h * cfg["n_shared_experts"] * moe
            total += 6 * n * h * moe * held_slots_per_token(cfg)
    total += 2 * h * cfg["analogy_entities"]
    return float(total)


def attention_calls(cfg, batch: int, seq_len: int):
    """The attention calls of one forward: dicts of b, heads, lq, lk,
    head_dim and count, and for latent attention's calls also head_dim_v and
    causal."""
    n = image_tokens(cfg) + seq_len
    per = image_tokens(cfg) // cfg["num_images"]
    vision = dict(b=batch * cfg["num_images"], heads=cfg["vision_heads"], lq=per, lk=per,
                  head_dim=cfg["vision_hidden_size"] // cfg["vision_heads"],
                  count=cfg["vision_layers"])
    mla = dict(b=batch, heads=cfg["num_attention_heads"], lq=n, lk=n,
               head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
               head_dim_v=cfg["v_head_dim"], causal=True, count=cfg["num_hidden_layers"])
    return [vision, mla]


def expert_products(cfg, rows: float):
    """The grouped products of one expert layer's forward and backward at
    ``rows`` (token, held expert) pairs, as (m, k, n, the side that is one
    matrix an expert: "b" a weight, "out" a weight's gradient): gate and up
    (rows x H by H x 2I), down (rows x I by I x H); in the backward dA (rows
    x H by H x I), dW_down (I x rows by rows x H), dX (rows x 2I by 2I x H)
    and dW_gate_up (H x rows by rows x 2I)."""
    h, moe = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return [(rows, h, 2 * moe, "b"), (rows, moe, h, "b"), (rows, h, moe, "b"),
            (moe, rows, h, "out"), (rows, 2 * moe, h, "b"), (h, rows, 2 * moe, "out")]
