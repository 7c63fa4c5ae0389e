"""Where the bf16 spread of MKGformer's logits comes from.

On the card the port's bf16 logits through the attention kernel and through
the plain attention differ by up to 1.5 at full width and rank 27-30% of a
small test set differently, while the two attention formulations differ by
one bf16 ulp and fp32 agrees to the last bits. The question was whether
that is a fault of the port or a property of the random-weight model. So
here, on the CPU, at width 128 (2 heads of 64, 4 layers a tower, BertFusion
from layer 2), the same random weights run through two attention
formulations that round at different points, the single-block kernel
(probabilities rounded to bf16 after the softmax) and the flash kernel
(exp-weights rounded against each tile's running max), in JAX (Pallas in
interpret mode) and in the port (their plain versions). In fp32 all four
agree to the model bar and rank every example alike; in bf16 JAX's pair
spreads the logits as far as the port's pair does, and as far as the port
is from JAX. The model amplifies any bf16 rounding; the port adds no spread
of its own.

Run as a script it prints the same figures at other sizes, e.g. full width:

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/test_torch_port_bf16_spread.py \
        --width 768 --layers 12 --batch 8
"""

import argparse
import json

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.models import common
from mkg_analogy_tpu_torch.models import unimo
from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax
from test_torch_port_unimo import MODEL_ATOL, port_config

torch.set_num_threads(1)

VOCAB, B, L = 512, 16, 48


def config(dtype, width=128, layers=4):
    """Towers of ``width`` (heads of 64) and ``layers`` layers, BertFusion
    from the middle layer."""
    from mkg_analogy_tpu.models.unimo import TextConfig, UnimoConfig, VisionConfig

    tower = dict(hidden_size=width, num_layers=layers, num_heads=width // 64,
                 intermediate_size=2 * width)
    return UnimoConfig(
        text=TextConfig(vocab_size=VOCAB, max_position_embeddings=128, **tower),
        vision=VisionConfig(image_size=32, patch_size=16, **tower),
        fusion_start=layers // 2, dtype=dtype)


def batch(b=B):
    """(numpy inputs of b examples, their labels)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(20, L + 1, b)
    return dict(
        input_ids=rng.integers(0, VOCAB, (b, L)).astype(np.int32),
        attention_mask=(np.arange(L)[None] < lens[:, None]).astype(np.int32),
        token_type_ids=np.zeros((b, L), np.int32),
        pixel_values=rng.standard_normal((b, 2, 3, 32, 32)).astype(np.float32),
        positions=rng.integers(1, 10, (b, 5)).astype(np.int32),
        boundary=(lens // 2).astype(np.int32)), rng.integers(0, VOCAB, b)


def logits(dtype, width=128, layers=4, b=B):
    """{(framework, backend): (b, VOCAB) fp32 logits} of one random-weight
    model, in ``dtype``, through the single-block and the flash attention."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.models import common as jcommon
    from mkg_analogy_tpu.models.unimo import UnimoForMaskedLM as FlaxUnimo

    inputs, _ = batch(b)
    flax_model = FlaxUnimo(config(dtype, width, layers))
    params = jax.device_get(flax_model.init(
        jax.random.PRNGKey(0), **{k: jnp.asarray(v) for k, v in inputs.items()},
        deterministic=True))
    out = {}
    try:
        for backend in ("single", "flash"):
            jcommon.set_fused_attention(True, interpret=True, backend=backend)
            trans = flax_model.apply(params, **{k: jnp.asarray(v) for k, v in inputs.items()},
                                     deterministic=True)
            out["jax", backend] = np.asarray(
                flax_model.apply(params, trans[:, 0], method=FlaxUnimo.logits), np.float32)
    finally:
        jcommon.set_fused_attention(False)
    model = unimo.UnimoForMaskedLM(port_config(config(dtype, width, layers)))
    model.load_state_dict(unimo_params_from_jax(params), strict=True)
    for backend in ("single", "flash"):
        for m in model.modules():
            if isinstance(m, common.AttentionCore):
                m.backend = backend
        with torch.inference_mode():
            trans = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
            out["port", backend] = model.logits(trans[:, 0]).float().numpy()
    return out


def spread(a, b):
    """(largest logit gap, share of examples whose label ranks differently)."""
    n = a.shape[0]
    labels = batch(n)[1]

    def ranks(x):
        return (x > x[np.arange(n), labels][:, None]).sum(1)

    return float(np.abs(a - b).max()), float((ranks(a) != ranks(b)).mean())


PAIRS = [(("jax", "single"), ("jax", "flash")), (("port", "single"), ("port", "flash")),
         (("jax", "single"), ("port", "single"))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_spread_is_the_models_not_the_ports(dtype):
    out = logits(dtype)
    gaps = {pair: spread(out[pair[0]], out[pair[1]]) for pair in PAIRS}
    if dtype == "float32":
        # the same math: within the model bar, every example ranked alike
        for pair, (gap, moved) in gaps.items():
            assert gap <= MODEL_ATOL and moved == 0.0, (pair, gap, moved)
        return
    # bf16: the logits span ~0.85, an ulp there ~0.003. JAX's own pair
    # spreads them by many ulps and moves most ranks, and so do the port's
    # pair and the port against JAX, within a factor of 4 of each other
    jax_gap, jax_moved = gaps[PAIRS[0]]
    assert jax_gap > 0.02 and jax_moved > 0.3, (jax_gap, jax_moved)
    for pair in PAIRS[1:]:
        gap, moved = gaps[pair]
        assert jax_gap / 4 <= gap <= 4 * jax_gap and moved > 0.3, (pair, gap, moved)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--width", type=int, default=128)
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--batch", type=int, default=B)
    args = parser.parse_args()
    for dtype in ("float32", "bfloat16"):
        out = logits(dtype, args.width, args.layers, args.batch)
        print(json.dumps(dict(dtype=dtype, width=args.width, layers=args.layers,
                              batch=args.batch, logit_max=float(np.abs(out["jax", "single"]).max()),
                              **{f"{a[0]}_{a[1]}_vs_{c[0]}_{c[1]}": spread(out[a], out[c])
                                 for a, c in PAIRS})), flush=True)
