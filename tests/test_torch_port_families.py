"""Port parity for the ViLT and FLAVA families, against the Flax models on
the same weights (a Flax init carried over by models/convert.params_from_jax)
and the same numpy inputs, at the tiny configs of
tests/test_model_families.py (fp32, width 32, 2 text layers): the forward
through each attention backend, the analogy multiplier's effect, ViLT's
reference mask geometry on and off, one fp32 fine-tune step each (loss and
every gradient leaf against ``jax.grad`` of the JAX trainer's
``_finetune_loss``), the registry, and the CLI on the CPU from a pixel store
that the port's image tool wrote."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.models import flava as jflava
from mkg_analogy_tpu.models import vilt as jvilt
from mkg_analogy_tpu.models.unimo import TextConfig as FlaxTextConfig
from mkg_analogy_tpu_torch.cli import main as port_cli
from mkg_analogy_tpu_torch.models import common, flava, registry, vilt
from mkg_analogy_tpu_torch.models.convert import params_from_jax
from mkg_analogy_tpu_torch.models.unimo import TextConfig
from mkg_analogy_tpu_torch.tools import encode_images as tool
from tests.util import make_tiny_dataset

torch.set_num_threads(1)

# full-model activation bar (COMPONENTS.md M5): fp32 on both sides, stacks of
# matmuls summed in different orders
MODEL_ATOL = 2e-4
B, L, V, H = 3, 16, 128, 32
TINY_TEXT = dict(vocab_size=V, hidden_size=H, num_layers=2, num_heads=2,
                 intermediate_size=64, max_position_embeddings=64)
FAMILIES = {
    "vilt": (jvilt.ViltForMaskedLM, jvilt.ViltConfig, vilt.ViltForMaskedLM, vilt.ViltConfig,
             dict(image_size=16, patch_size=8)),
    "flava": (jflava.FlavaForMaskedLM, jflava.FlavaConfig, flava.FlavaForMaskedLM,
              flava.FlavaConfig, dict(image_size=16, patch_size=8, image_layers=2,
                                      multimodal_layers=1)),
}


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.int32)
    mask[1, 12:] = 0
    mask[2, 10:] = 0
    return dict(
        input_ids=rng.integers(5, V, (B, L)).astype(np.int32),
        attention_mask=mask,
        token_type_ids=(np.arange(L)[None] >= 7).astype(np.int32).repeat(B, 0),
        pixel_values=rng.standard_normal((B, 2, 3, 16, 16)).astype(np.float32),
        positions=rng.integers(0, 10, (B, 5)).astype(np.int32),
        boundary=np.array([6, 9, 4], np.int32),
    )


def build_pair(name, dropout=True, **cfg_kw):
    """(flax model, its variables, the port's model on the converted
    weights). The adaptive scalars are moved off their clip bound (w1 = 0.5
    exactly) and made to differ per layer, so a wrong geometry shows."""
    flax_cls, flax_cfg, port_cls, port_cfg, kw = FAMILIES[name]
    text = dict(TINY_TEXT)
    if not dropout:
        text.update(hidden_dropout=0.0, attention_dropout=0.0)
    kw = dict(kw, dtype="float32", **cfg_kw)
    flax_model = flax_cls(flax_cfg(text=FlaxTextConfig(**text), **kw))
    batch = make_batch()
    params = jax.device_get(jax.jit(lambda key, b: flax_model.init(key, **b, deterministic=True))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    rng = np.random.default_rng(1)
    for layer in params["params"].values():
        if isinstance(layer, dict) and "adaptive_w0" in layer:
            layer["adaptive_w0"] = rng.uniform(0.05, 0.45, 1).astype(np.float32)
            layer["adaptive_w1"] = rng.uniform(0.55, 0.95, 1).astype(np.float32)
    model = port_cls(port_cfg(text=TextConfig(**text), **kw))
    model.load_state_dict(params_from_jax(params), strict=True)
    return flax_model, params, model


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    return (request.param,) + build_pair(request.param)


def flax_trans(flax_model, params, batch):
    return np.asarray(flax_model.apply(
        params, **{k: None if v is None else jnp.asarray(v) for k, v in batch.items()},
        deterministic=True))


def port_trans(model, batch):
    with torch.inference_mode():
        return model(**{k: None if v is None else torch.from_numpy(v)
                        for k, v in batch.items()}).numpy()


def set_backend(model, backend):
    for m in model.modules():
        if isinstance(m, common.AttentionCore):
            m.backend = backend


@pytest.mark.parametrize("backend", ["single", "flash", "plain"])
def test_forward_matches_jax(pair, backend):
    """Transformed states and tied logits through each attention backend
    (on the CPU each kernel's plain version) against the Flax model."""
    name, flax_model, params, model = pair
    batch = make_batch()
    set_backend(model, backend)
    want = flax_trans(flax_model, params, batch)
    got = port_trans(model, batch)
    assert got.shape == want.shape == (B, 5, H)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)
    ids = np.array([3, 100, 17, 127, 0], np.int32)
    want_logits = np.asarray(flax_model.apply(params, jnp.asarray(want[:, 0]),
                                              vocab_ids=jnp.asarray(ids),
                                              method=type(flax_model).logits))
    with torch.inference_mode():
        got_logits = model.logits(torch.from_numpy(got[:, 0]),
                                  vocab_ids=torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got_logits, want_logits, atol=MODEL_ATOL)


def test_converter_names_follow_the_flax_tree(pair):
    name, _, params, model = pair
    sd = params_from_jax(params)
    assert set(sd) == set(model.state_dict())
    if name == "vilt":
        assert sd["layer_1.layer.attn.query.weight"].shape == (H, H)
        assert sd["layer_0.adaptive_w0"].shape == (1,)
        assert sd["image_embeddings.patch_embedding.weight"].shape == (H, 3, 8, 8)
        assert sd["modal_type_embeddings"].shape == (2, H)
    else:
        assert sd["text_1.layer.fc1.weight"].shape == (64, H)
        assert sd["image_0.attn.out.weight"].shape == (H, H)
        assert "image_0.adaptive_w0" not in sd and "text_0.adaptive_w1" in sd
        assert sd["mm_cls_token"].shape == (1, 1, H)
        assert sd["image_embeddings.position_embeddings"].shape == (5, H)


def test_analogy_multiplier_and_images_have_effect(pair):
    """The boundary changes the output (the adaptive mask is active, on both
    sides alike), no boundary is the plain attention, and the images reach
    the text positions."""
    _, flax_model, params, model = pair
    batch = make_batch()
    base = port_trans(model, batch)
    moved = dict(batch, boundary=np.array([3, 13, 8], np.int32))
    got = port_trans(model, moved)
    assert np.abs(got - base).max() > 1e-4
    np.testing.assert_allclose(got, flax_trans(flax_model, params, moved), atol=MODEL_ATOL)
    none = dict(batch, boundary=None)
    got = port_trans(model, none)
    assert np.abs(got - base).max() > 1e-4
    np.testing.assert_allclose(got, flax_trans(flax_model, params, none), atol=MODEL_ATOL)
    dark = dict(batch, pixel_values=batch["pixel_values"] * 0.0)
    assert np.abs(port_trans(model, dark) - base).max() > 1e-4


@pytest.mark.parametrize("backend", ["single", "flash", "plain"])
def test_vilt_reference_mask_offset_matches_jax(backend):
    """``compat_ref_mask_offset``: the geometry shifted by the image length
    (2 x 5 tokens here: rows from 11, the boundary at sep + 10, columns to
    the sequence end), against the Flax model, and unlike the default."""
    flax_model, params, model = build_pair("vilt", compat_ref_mask_offset=True)
    assert model.layer_0.compat_img_offset == 10 and model.layer_0.row_start == 1
    set_backend(model, backend)
    batch = make_batch()
    got = port_trans(model, batch)
    np.testing.assert_allclose(got, flax_trans(flax_model, params, batch), atol=MODEL_ATOL)
    default = vilt.ViltForMaskedLM(dataclasses.replace(model.cfg, compat_ref_mask_offset=False))
    default.load_state_dict(model.state_dict())
    assert np.abs(port_trans(default, batch) - got).max() > 1e-4


def test_flava_tail_positions_reuse_the_cls_row():
    """The tail image's patches take table rows 0..P-1, the CLS row
    included (modeling_flava.py:336-343): zero pixels and a zero patch bias
    leave the position rows alone."""
    _, _, model = build_pair("flava")
    emb = model.image_embeddings
    with torch.no_grad():
        emb.patch_embedding.bias.zero_()
        tokens = emb(torch.zeros(1, 2, 3, 16, 16))[0]
    pos, p = emb.position_embeddings, model.cfg.patches_per_image
    assert tokens.shape == (2 * p + 1, H) and p == 4
    torch.testing.assert_close(tokens[0], emb.cls_token[0, 0] + pos[0])
    torch.testing.assert_close(tokens[1:p + 1], pos[1:])
    torch.testing.assert_close(tokens[p + 1:], pos[:p])


class _Vocab:
    analogy_entity_ids = np.arange(16, dtype=np.int32) + 40
    analogy_relation_ids = np.arange(4, dtype=np.int32) + 100
    r_token_id = 110
    entity_id_st, entity_id_ed = 40, 90
    relation_id_st, relation_id_ed = 90, 110
    padded_vocab_size = V


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_finetune_step_matches_jax(name):
    """One fp32 fine-tune step, dropout rates 0, on the same converted
    weights and batch: the JAX trainer's ``_finetune_loss`` differentiated
    by ``jax.grad`` against the port's through its default backend (ViLT
    the single-block attention, FLAVA the flash attention; on the CPU their
    plain forward and backward). The loss and its two terms within 1e-5
    relative; each gradient leaf within 1e-4 of that leaf's largest
    |gradient| plus 1e-7 of the model's largest (leaves whose exact gradient
    is 0, the key biases, carry round-off only)."""
    from mkg_analogy_tpu.core.mesh import make_mesh
    from mkg_analogy_tpu.train import trainer as jtrainer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    flax_model, params, model = build_pair(name, dropout=False)
    rng = np.random.default_rng(2)
    mask = np.ones((B, L), np.int32)
    mask[1, 15:] = 0
    batch = dict(
        input_ids=rng.integers(5, V, (B, L)).astype(np.int32),
        attention_mask=mask,
        token_type_ids=np.zeros((B, L), np.int32),
        pixel_values=rng.standard_normal((B, 2, 3, 16, 16)).astype(np.float32),
        label=rng.integers(0, 16, (B,)).astype(np.int32),
        sep_idx=np.tile(np.array([2, 4, 6, 9, 11, 14], np.int32), (B, 1)),
        rel_idx=np.tile(np.array([3, 10], np.int32), (B, 1)),
        q_head_idx=np.ones((B,), np.int32),
        a_head_idx=np.full((B,), 7, np.int32),
        mask_idx=np.full((B,), 13, np.int32),
    )
    batch["sep_idx"][:, 2] = [6, 9, 4]
    jt = jtrainer.MarTTrainer(flax_model, _Vocab(), jtrainer.TrainConfig(alpha=0.43),
                              mesh=make_mesh(dp=1, tp=1, devices=jax.devices()[:1]))
    (want_loss, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jt._finetune_loss(p, b, jax.random.PRNGKey(1)), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    pt = MarTTrainer(model, _Vocab(), TrainConfig(alpha=0.43), device="cpu")
    model.zero_grad(set_to_none=True)
    loss, aux = pt._finetune_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                                  common.DropoutRNG.from_seed(1, "cpu"))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for k in ("ce", "sim"):
        assert abs(aux[k].item() - float(want_aux[k])) <= 1e-5 * abs(float(want_aux[k]))
    want = params_from_jax(jax.device_get(want_g))
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    top = max(float(w.abs().max()) for w in want.values())
    for leaf, w in want.items():
        g = got[leaf].grad
        assert g is not None, leaf
        bound = 1e-4 * float(w.abs().max()) + 1e-7 * top
        err = float((g - w).abs().max())
        assert err <= bound, (leaf, err, bound)
    first = "layer_0" if name == "vilt" else "text_0"
    assert float(got[f"{first}.adaptive_w0"].grad) != 0.0


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_training_forward_draws_dropout(name):
    """A training forward needs a DropoutRNG, differs from the evaluation
    forward, repeats for the same seed and differs for another."""
    _, _, model = build_pair(name)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with torch.no_grad():
        with pytest.raises(ValueError, match="DropoutRNG"):
            model(**batch, deterministic=False)
        base = model(**batch)
        a = model(**batch, deterministic=False, rng=common.DropoutRNG.from_seed(3, "cpu"))
        b = model(**batch, deterministic=False, rng=common.DropoutRNG.from_seed(3, "cpu"))
        c = model(**batch, deterministic=False, rng=common.DropoutRNG.from_seed(4, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, base)


def test_registry_creates_the_pixel_families():
    """Full-width constructors (on the meta device: no memory), with the
    attention backend of each family's default and an explicit one."""
    assert registry.DEFAULT_ATTENTION == {"MKGformerKGC": "single", "ViltKGC": "single",
                                          "FlavaKGC": "flash", "VisualBertKGC": "single",
                                          "VilBertKGC": "single", "KimiVLKGC": "flash"}
    with torch.device("meta"):
        v = registry.create_model("ViltKGC", vocab_size=256)
        f = registry.create_model("FlavaKGC", vocab_size=256, attention="single")
    assert isinstance(v, vilt.ViltForMaskedLM) and isinstance(f, flava.FlavaForMaskedLM)
    assert v.cfg.tokens_per_image == 145 and v.cfg.image_size == 384
    assert v.layer_11.layer.attn.backend == "single" and v.final_ln.eps == 1e-12
    assert f.cfg.image_tokens == 393 and f.mm_5.attn.backend == "single"
    assert f.image_embeddings.position_embeddings.shape == (197, 768)
    assert hasattr(v, "logits") and hasattr(f, "logits")
    small = registry.create_model("FlavaKGC", vocab_size=256, hidden_size=32, num_layers=2,
                                  num_heads=2, intermediate_size=64, dtype="float32")
    assert small.text_1.layer.attn.backend == "flash" and small.cfg.dtype == "float32"


@pytest.fixture(scope="module")
def dataset_with_images(tmp_path_factory):
    """tests/util.make_tiny_dataset plus an image folder for 12 of its 16
    entities, PNG files written with PIL."""
    from PIL import Image

    root = tmp_path_factory.mktemp("families_kg")
    markg_dir, mars_dir = make_tiny_dataset(str(root))
    rng = np.random.default_rng(5)
    for i in range(12):
        d = root / "images" / f"Q{i}"
        d.mkdir(parents=True)
        for j in range(1 + i % 2):
            h, w = (int(x) for x in rng.integers(20, 90, 2))
            Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
                d / f"{j}.png")
    return str(root), markg_dir, mars_dir


@pytest.mark.parametrize("model_class,size,stats,alpha", [("ViltKGC", 384, "vilt", "0.3"),
                                                          ("FlavaKGC", 224, "clip", "0.45")])
def test_cli_finetunes_from_the_tools_store(dataset_with_images, tmp_path, model_class,
                                            size, stats, alpha):
    """This slice's path end to end on the CPU: the port's tool writes the
    family's pixel store (384 px with ViLT statistics, 224 px with CLIP's),
    the CLI fine-tunes one tiny epoch from it and tests with the best-dev
    checkpoint, and ``--only_test --checkpoint`` reproduces the ranks."""
    from mkg_analogy_tpu_torch.train import checkpoint

    root, markg_dir, mars_dir = dataset_with_images
    store = str(tmp_path / "pixels.npy")
    tool.main(["--images_dir", root + "/images", "--markg", markg_dir, "--out", store,
               "--mode", "pixels", "--size", str(size), "--stats", stats, "--device", "cpu"])
    assert np.load(store, mmap_mode="r").shape == (16, 3, size, size)

    def flags(tag, *extra):
        return ["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--device", "cpu",
                "--model_class", model_class, "--image_features", store, "--alpha", alpha,
                "--max_epochs", "1", "--batch_size", "8", "--eval_batch_size", "8",
                "--max_seq_length", "48", "--text_vocab_size", "256", "--hidden_size", "32",
                "--num_layers", "2", "--num_heads", "2", "--intermediate_size", "64",
                "--dtype", "float32", "--lr", "1e-3",
                "--output_dir", str(tmp_path / f"out_{tag}"),
                "--log_dir", str(tmp_path / f"logs_{tag}"),
                "--cache_dir", str(tmp_path / "cache"), *extra]

    got = port_cli.main(flags("fit"))
    assert all(np.isfinite(v) for v in got.values()) and 0.0 < got["Eval_entity/mrr"] <= 1.0
    ckpt = tmp_path / "out_fit" / "ckpt"
    assert checkpoint.list_steps(str(ckpt)) == [3]  # 24 examples / 8 a batch
    ranks = np.load(tmp_path / "out_fit" / "test_ranks.npz")["ranks"]
    retest = port_cli.main(flags("retest", "--only_test", "--checkpoint", str(ckpt)))
    np.testing.assert_array_equal(
        np.load(tmp_path / "out_retest" / "test_ranks.npz")["ranks"], ranks)
    assert retest == got
