"""Port parity for models/: the PyTorch UnimoForMaskedLM against the Flax
one on the same weights (a Flax init carried over by
models/convert.unimo_params_from_jax) and the same numpy inputs, at the
tiny config of tests/util.tiny_unimo_config (fp32, 2 layers, width 32,
fusion_start=1, so the text K/V hand-over and BertFusion both run); and the
activations against models/common.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.models import common as jcommon
from mkg_analogy_tpu.models.unimo import UnimoForMaskedLM as FlaxUnimo
from mkg_analogy_tpu_torch.models import common
from mkg_analogy_tpu_torch.models import unimo
from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax
from tests.util import tiny_unimo_config

torch.set_num_threads(1)

# full-model activation bar: the one the JAX package met against the
# reference torch model (COMPONENTS.md M5); fp32 on both sides, two towers
# of matmuls summed in different orders.
MODEL_ATOL = 2e-4
VOCAB = 256


def port_config(cfg):
    return unimo.UnimoConfig(
        text=unimo.TextConfig(**{f: getattr(cfg.text, f)
                                 for f in cfg.text.__dataclass_fields__}),
        vision=unimo.VisionConfig(**{f: getattr(cfg.vision, f)
                                     for f in cfg.vision.__dataclass_fields__}),
        fusion_start=cfg.fusion_start, dtype=cfg.dtype)


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_unimo_config(vocab_size=VOCAB)
    b, length = 3, 16
    rng = np.random.default_rng(0)
    mask = np.ones((b, length), np.int32)
    mask[1, 12:] = 0
    mask[2, 9:] = 0
    batch = dict(
        input_ids=rng.integers(0, VOCAB, (b, length)).astype(np.int32),
        attention_mask=mask,
        token_type_ids=(np.arange(length)[None] >= 7).astype(np.int32).repeat(b, 0),
        pixel_values=rng.standard_normal((b, 2, 3, 16, 16)).astype(np.float32),
        positions=rng.integers(0, 9, (b, 5)).astype(np.int32),
        boundary=np.array([4, 6, 8], np.int32),
    )
    flax_model = FlaxUnimo(cfg)
    params = flax_model.init(jax.random.PRNGKey(0),
                             **{k: jnp.asarray(v) for k, v in batch.items()},
                             deterministic=True)
    params = jax.device_get(params)
    model = unimo.UnimoForMaskedLM(port_config(cfg))
    model.load_state_dict(unimo_params_from_jax(params), strict=True)
    return flax_model, params, model, batch


def flax_trans(flax_model, params, batch):
    return np.asarray(flax_model.apply(
        params, **{k: None if v is None else jnp.asarray(v) for k, v in batch.items()},
        deterministic=True))


def port_trans(model, batch):
    with torch.inference_mode():
        return model(**{k: None if v is None else torch.from_numpy(v)
                        for k, v in batch.items()})


def test_converter_covers_every_parameter(pair):
    """strict=True loaded in the fixture; the pre-fusion text layer has no
    fusion_dense (models/unimo.py:275-282), the fusion layer has one."""
    _, params, model, _ = pair
    sd = unimo_params_from_jax(params)
    assert set(sd) == set(model.state_dict())
    assert "encoder.text_0.fusion_dense.weight" not in sd
    assert sd["encoder.text_1.fusion_dense.weight"].shape == (64, 32)
    assert sd["vision_embeddings.patch_embedding.weight"].shape == (32, 3, 8, 8)
    np.testing.assert_array_equal(
        sd["encoder.text_1.attn.query.weight"].numpy(),
        np.asarray(params["params"]["encoder"]["text_1"]["attn"]["query"]["kernel"]).T)


@pytest.mark.parametrize("with_boundary", [True, False])
def test_transformed_hidden_states_match_jax(pair, with_boundary):
    flax_model, params, model, batch = pair
    if not with_boundary:
        batch = dict(batch, boundary=None)
    want = flax_trans(flax_model, params, batch)
    got = port_trans(model, batch).numpy()
    assert got.shape == (3, 5, 32)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)


@pytest.mark.parametrize("slice_kind", ["vocab_ids", "range", "full"])
def test_logits_match_jax(pair, slice_kind):
    flax_model, params, model, batch = pair
    trans = flax_trans(flax_model, params, batch)[:, 0]
    kw = {"vocab_ids": np.array([3, 200, 17, 255, 0], np.int32),
          "range": dict(vocab_start=40, vocab_end=90), "full": {}}[slice_kind]
    if slice_kind == "vocab_ids":
        jkw, tkw = dict(vocab_ids=jnp.asarray(kw)), dict(vocab_ids=torch.from_numpy(kw))
    else:
        jkw = tkw = kw
    want = np.asarray(flax_model.apply(params, jnp.asarray(trans),
                                       method=FlaxUnimo.logits, **jkw))
    with torch.inference_mode():
        got = model.logits(port_trans(model, batch)[:, 0], **tkw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)


# the activations run elementwise on the same fp32 values; erf / sigmoid
# implementations differ in the last ulps
ACT_ATOL = 1e-6
XS = np.concatenate([np.linspace(-9, 9, 4001),
                     np.random.default_rng(4).standard_normal(2000) * 3]).astype(np.float32)


def test_gelu_poly_matches_jax():
    want = np.asarray(jcommon.gelu_poly(jnp.asarray(XS)))
    np.testing.assert_allclose(common.gelu_poly(torch.from_numpy(XS)).numpy(), want,
                               atol=ACT_ATOL)
    # and the bf16 dispatch: poly in fp32, cast back
    xb = torch.from_numpy(XS).bfloat16()
    got = common.gelu(xb, "poly")
    assert got.dtype == torch.bfloat16
    want_b = np.asarray(jcommon.gelu_poly(jnp.asarray(XS, jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want_b)


def test_gelu_erf_matches_jax():
    """fp32 always takes exact erf, whatever the bf16 choice."""
    want = np.asarray(jax.nn.gelu(jnp.asarray(XS), approximate=False))
    for impl in ("poly", "erf", "tanh"):
        got = common.gelu(torch.from_numpy(XS), impl).numpy()
        np.testing.assert_allclose(got, want, atol=ACT_ATOL, err_msg=impl)


def test_quick_gelu_matches_jax():
    want = np.asarray(jcommon.quick_gelu(jnp.asarray(XS)))
    np.testing.assert_allclose(common.quick_gelu(torch.from_numpy(XS)).numpy(), want,
                               atol=ACT_ATOL)
