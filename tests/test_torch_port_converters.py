"""Port parity of the reference-format converters
(mkg_analogy_tpu_torch/models/export_torch.py, import_torch.py) against the
JAX package's (mkg_analogy_tpu/models/export_torch.py, import_torch.py), for
all five families:

- at tiny configs, on the same weights (a Flax init, carried into the port
  by models/convert.params_from_jax): the port's export equals JAX's key for
  key and value for value, exactly, and the port's import of that export
  gives the port's state_dict back exactly;
- at the full configs, built without compute (the port's modules on the
  meta device, the Flax trees by jax.eval_shape filled with zero-stride
  arrays): the same key surface and shapes, and import after export is the
  identity on it;
- ViLT's ``interpolate_patch_positions`` and the BERT + CLIP surgery
  ``unimo_params_from_bert_clip`` against JAX's on synthetic state dicts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.models import export_torch as jex
from mkg_analogy_tpu.models import flava as jflava
from mkg_analogy_tpu.models import import_torch as jim
from mkg_analogy_tpu.models import unimo as junimo
from mkg_analogy_tpu.models import vilbert as jvilbert
from mkg_analogy_tpu.models import vilt as jvilt
from mkg_analogy_tpu.models import visualbert as jvisualbert
from mkg_analogy_tpu_torch.models import export_torch as ex
from mkg_analogy_tpu_torch.models import flava, unimo, vilbert, vilt, visualbert
from mkg_analogy_tpu_torch.models import import_torch as im
from mkg_analogy_tpu_torch.models.convert import params_from_jax
from tests.util import tiny_unimo_config

torch.set_num_threads(1)

B, L, V = 2, 16, 128
TEXT = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=64)
VILBERT = dict(v_hidden_size=256, v_num_heads=2, v_intermediate_size=64, v_feature_size=48,
               bi_hidden_size=256, bi_num_heads=2, v_num_layers=2, v_biattention_id=(1,),
               t_biattention_id=(1,))


def _jax_text(**kw):
    return junimo.TextConfig(**kw)


def _port_text(**kw):
    return unimo.TextConfig(**kw)


def _copy_fields(cfg, cls, **over):
    return cls(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}, **over)


# name -> (flax model, port module class, port config, image input shape,
#          region features?, export keywords, import keywords)
def _families(full: bool):
    text = {} if full else TEXT
    u_cfg = junimo.UnimoConfig() if full else tiny_unimo_config(V)
    pix = (B, 2, 3) + ((224, 224) if full else (16, 16))
    vilt_kw = {} if full else dict(image_size=16, patch_size=8)
    flava_kw = {} if full else dict(image_size=16, patch_size=8, image_layers=2,
                                    multimodal_layers=1)
    vb_kw = {} if full else dict(visual_embedding_dim=48)
    vl_kw = {} if full else VILBERT
    n = 12 if full else 2
    return {
        "unimo": (
            junimo.UnimoForMaskedLM(u_cfg), unimo.UnimoForMaskedLM,
            unimo.UnimoConfig(text=_copy_fields(u_cfg.text, unimo.TextConfig),
                              vision=_copy_fields(u_cfg.vision, unimo.VisionConfig),
                              fusion_start=u_cfg.fusion_start, dtype=u_cfg.dtype),
            pix, False, dict(num_layers=n),
            dict(num_layers=n, fusion_start=u_cfg.fusion_start)),
        "visualbert": (
            jvisualbert.VisualBertForMaskedLM(jvisualbert.VisualBertConfig(
                text=_jax_text(**text), **vb_kw)), visualbert.VisualBertForMaskedLM,
            visualbert.VisualBertConfig(text=_port_text(**text), **vb_kw),
            (B, 72, 2048 if full else 48), True, dict(num_layers=n), dict(num_layers=n)),
        "vilt": (
            jvilt.ViltForMaskedLM(jvilt.ViltConfig(text=_jax_text(**text), **vilt_kw)),
            vilt.ViltForMaskedLM, vilt.ViltConfig(text=_port_text(**text), **vilt_kw),
            (B, 2, 3) + ((384, 384) if full else (16, 16)), False, dict(num_layers=n),
            dict(num_layers=n)),
        "flava": (
            jflava.FlavaForMaskedLM(jflava.FlavaConfig(text=_jax_text(**text), **flava_kw)),
            flava.FlavaForMaskedLM, flava.FlavaConfig(text=_port_text(**text), **flava_kw),
            pix, False, dict(num_layers=n, mm_layers=6 if full else 1),
            dict(num_layers=n, mm_layers=6 if full else 1)),
        "vilbert": (
            jvilbert.VilBertForMaskedLM(jvilbert.VilBertConfig(text=_jax_text(**text),
                                                               **vl_kw)),
            vilbert.VilBertForMaskedLM, vilbert.VilBertConfig(text=_port_text(**text), **vl_kw),
            (B, 72, 2048 if full else 48), True,
            dict(num_layers=n, v_num_layers=6 if full else 2,
                 num_connections=6 if full else 1),
            dict(num_layers=n, v_num_layers=6 if full else 2,
                 num_connections=6 if full else 1)),
    }


EXPORT = {"unimo": (jex.unimo_params_to_reference, ex.unimo_params_to_reference),
          "visualbert": (jex.visualbert_params_to_reference, ex.visualbert_params_to_reference),
          "vilt": (jex.vilt_params_to_reference, ex.vilt_params_to_reference),
          "flava": (jex.flava_params_to_reference, ex.flava_params_to_reference),
          "vilbert": (jex.vilbert_params_to_reference, ex.vilbert_params_to_reference)}
IMPORT = {"unimo": im.unimo_params_from_reference,
          "visualbert": im.visualbert_params_from_reference,
          "vilt": im.vilt_params_from_reference,
          "flava": im.flava_params_from_reference,
          "vilbert": im.vilbert_params_from_reference}
NAMES = sorted(EXPORT)


def _batch(img_shape, regions):
    batch = dict(
        input_ids=jnp.zeros((B, L), jnp.int32),
        attention_mask=jnp.ones((B, L), jnp.int32),
        token_type_ids=jnp.zeros((B, L), jnp.int32),
        pixel_values=jnp.zeros(img_shape, jnp.float32),
        positions=jnp.zeros((B, 5), jnp.int32),
        boundary=jnp.full((B,), 6, jnp.int32),
    )
    if regions:
        batch["visual_attention_mask"] = jnp.ones(img_shape[:2], jnp.float32)
    return batch


@pytest.fixture(scope="module", params=NAMES)
def tiny(request):
    """(name, Flax params, the port's module on them, export kw, import kw)
    at the tiny config."""
    name = request.param
    flax_model, port_cls, port_cfg, img, regions, ex_kw, im_kw = _families(False)[name]
    params = jax.device_get(flax_model.init(jax.random.PRNGKey(0), **_batch(img, regions),
                                            deterministic=True))
    model = port_cls(port_cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return name, params, model, ex_kw, im_kw


@pytest.mark.parametrize("vocab_rows", [None, 100], ids=["all_rows", "stripped"])
def test_export_equals_jax_export(tiny, vocab_rows):
    """Key for key, value for value, exactly, with and without the
    vocabulary strip."""
    name, params, model, ex_kw, _ = tiny
    jax_export, port_export = EXPORT[name]
    want = jax_export(params, vocab_rows=vocab_rows, **ex_kw)
    got = port_export(model.state_dict(), vocab_rows=vocab_rows, **ex_kw)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    if name == "vilbert":
        assert not got["bert.v_embeddings.image_location_embeddings.weight"].any()


def test_import_after_export_is_the_identity(tiny):
    """The port's import of its export gives its state_dict back exactly
    (the padding rows of a stripped vocabulary come back as zeros), and
    JAX's import of the same export is that state_dict's Flax tree."""
    name, params, model, ex_kw, im_kw = tiny
    _, port_export = EXPORT[name]
    sd = model.state_dict()
    back = IMPORT[name](port_export(sd, **ex_kw), **im_kw)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
    stripped = IMPORT[name](port_export(sd, vocab_rows=100, **ex_kw), vocab_rows=V, **im_kw)
    assert torch.equal(stripped["word_embeddings"][:100], sd["word_embeddings"][:100])
    assert not stripped["word_embeddings"][100:].any() and not stripped["mlm_bias"][100:].any()
    jax_import = getattr(jim, IMPORT[name].__name__)
    jax_kw = dict(im_kw)
    want = params_from_jax(jax_import({k: v.numpy() for k, v in port_export(sd, **ex_kw).items()},
                                      **jax_kw))
    if name == "vilbert":
        # JAX maps image_location_embeddings to a loc_proj the models never
        # materialise; the port's module has none
        want = {k: v for k, v in want.items() if not k.startswith("loc_proj")}
    assert set(want) == set(sd)
    for key, value in want.items():
        assert torch.equal(value, sd[key]), key


def _zero_tree(shapes):
    """A Flax tree of zero-stride float32 arrays: the shapes at no memory."""
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)


@pytest.mark.parametrize("name", NAMES)
def test_full_size_key_surface_matches_jax(name):
    """At each family's full config (vocab 42,112, BERT-base text, the
    families' own towers): the port's export of a meta-device module has
    JAX's keys and shapes, and its import gives the module's state_dict
    names and shapes back."""
    flax_model, port_cls, port_cfg, img, regions, ex_kw, im_kw = _families(True)[name]
    shapes = jax.eval_shape(
        lambda key: flax_model.init(key, **_batch(img, regions), deterministic=True),
        jax.random.PRNGKey(0))
    jax_export, port_export = EXPORT[name]
    want = jax_export(_zero_tree(shapes), **ex_kw)
    with torch.device("meta"):
        model = port_cls(port_cfg)
    sd = model.state_dict()
    got = port_export(sd, **ex_kw)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    back = IMPORT[name](got, **im_kw)
    assert {k: tuple(v.shape) for k, v in back.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    if name == "unimo":
        stripped = port_export(sd, vocab_rows=42006, **ex_kw)
        assert stripped["unimo.text_embeddings.word_embeddings.weight"].shape[0] == 42006


@pytest.mark.parametrize("p0,num_patches", [(49, 144), (144, 49), (144, 144), (4, 1)])
def test_interpolate_patch_positions_matches_jax(p0, num_patches):
    """ViLT's position-table resize (align_corners bilinear) against JAX's
    numpy one, exactly, in its float64."""
    pos = np.random.default_rng(p0).standard_normal((p0 + 1, 24)).astype(np.float32)
    want = jim.interpolate_patch_positions(pos, num_patches)
    got = im.interpolate_patch_positions(torch.from_numpy(pos), num_patches)
    assert got.shape == want.shape == (num_patches + 1, 24)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vilt_import_interpolates_positions_as_jax():
    """A 2 x 2 grid checkpoint into a 3 x 3 model: the interpolated table,
    cast to the port's float32, is JAX's."""
    flax_model, port_cls, port_cfg, img, regions, ex_kw, im_kw = _families(False)["vilt"]
    params = jax.device_get(flax_model.init(jax.random.PRNGKey(0), **_batch(img, regions),
                                            deterministic=True))
    sd = jex.vilt_params_to_reference(params, **ex_kw)
    sd["vilt.embeddings.position_embeddings"] = sd["vilt.embeddings.position_embeddings"][:, :5]
    want = params_from_jax(jim.vilt_params_from_reference(sd, num_patches=9, **im_kw))
    got = im.vilt_params_from_reference(sd, num_patches=9, **im_kw)
    pos = got["image_embeddings.position_embeddings"]
    assert pos.shape == (10, 32) and pos.dtype == torch.float32
    assert torch.equal(pos, want["image_embeddings.position_embeddings"])


def test_unimo_from_bert_clip_matches_jax():
    """The BERT + CLIP surgery (MarT/main.py:90-109) on synthetic tiny state
    dicts in the HuggingFace layouts: the port's state_dict equals
    params_from_jax of JAX's tree, exactly, and loads strictly into the
    port's tiny UniMo."""
    cfg = tiny_unimo_config(V)
    flax_model = junimo.UnimoForMaskedLM(cfg)
    params = jax.device_get(flax_model.init(jax.random.PRNGKey(0),
                                            **_batch((B, 2, 3, 16, 16), False),
                                            deterministic=True))
    ref = jex.unimo_params_to_reference(params, num_layers=2)
    rng = np.random.default_rng(4)
    bert, clip = {}, {}
    for key, value in ref.items():
        value = rng.standard_normal(value.shape).astype(np.float32)
        if key.startswith("unimo.text_embeddings."):
            bert["embeddings." + key[len("unimo.text_embeddings."):]] = value
        elif key.startswith("unimo.encoder.text_layer.") and "adaptive" not in key \
                and "fusion" not in key:
            bert["encoder.layer." + key[len("unimo.encoder.text_layer."):]] = value
        elif key.startswith("unimo.vision_embeddings."):
            clip["embeddings." + key[len("unimo.vision_embeddings."):]] = value
        elif key.startswith("unimo.vision_pre_layrnorm."):
            clip["pre_layrnorm." + key.split(".")[-1]] = value
        elif key.startswith("unimo.encoder.vision_layers."):
            clip["encoder.layers." + key[len("unimo.encoder.vision_layers."):]] = value
    want = params_from_jax(jim.unimo_params_from_bert_clip(bert, clip, num_layers=2,
                                                           vocab_rows=V, fusion_start=1))
    got = im.unimo_params_from_bert_clip(bert, clip, num_layers=2, vocab_rows=V,
                                         fusion_start=1)
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    model = unimo.UnimoForMaskedLM(_families(False)["unimo"][2])
    model.load_state_dict(got, strict=True)
