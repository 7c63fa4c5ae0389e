"""Port parity for the two region-feature families, VisualBERT and ViLBERT,
against the Flax models on the same weights (a Flax init carried over by
models/convert.params_from_jax) and the same numpy inputs, at the tiny
configs of tests/test_model_families.py (fp32, text width 32, 2 text
layers). ViLBERT's visual stream and bi-attention are 256 wide with 2 heads,
so its visual self-attention runs at head_dim 128, the second width of the
single-block kernels. The region inputs are (B, 72, 2048) with one image's
36 regions masked in one batch row and all 72 in another, as the trainer's
region gather builds them. Covered: the forward through each attention
backend (``flash`` against the Flax model on JAX's own flash route, its
Pallas kernels in interpret mode), VisualBERT's reference mask geometry
off and on, ViLBERT's
``ablate_img_to_txt`` off and on, one fp32 fine-tune step each (loss and
every gradient leaf against ``jax.grad`` of the JAX trainer's
``_finetune_loss``), the registry (its connection schedule against JAX's,
``available_models``) and the CLI on the CPU with ``--image_features
synthetic``."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.models import common as jcommon
from mkg_analogy_tpu.models import registry as jregistry
from mkg_analogy_tpu.models import vilbert as jvilbert
from mkg_analogy_tpu.models import visualbert as jvisualbert
from mkg_analogy_tpu.models.unimo import TextConfig as FlaxTextConfig
from mkg_analogy_tpu_torch.cli import main as port_cli
from mkg_analogy_tpu_torch.models import common, registry, vilbert, visualbert
from mkg_analogy_tpu_torch.models.convert import params_from_jax
from mkg_analogy_tpu_torch.models.unimo import TextConfig
from tests.util import make_tiny_dataset

torch.set_num_threads(1)

# full-model activation bar (COMPONENTS.md M5): fp32 on both sides, stacks of
# matmuls summed in different orders
MODEL_ATOL = 2e-4
B, L, V, H = 3, 16, 128, 32
REGIONS, FEAT = 72, 2048
TINY_TEXT = dict(vocab_size=V, hidden_size=H, num_layers=2, num_heads=2,
                 intermediate_size=64, max_position_embeddings=64)
# the visual stream at head_dim 128: 256 wide, 2 heads; two visual layers
# around one connection layer after text layer 0
TINY_VILBERT = dict(v_hidden_size=256, v_num_heads=2, v_intermediate_size=64,
                    bi_hidden_size=256, bi_num_heads=2, v_num_layers=2,
                    v_biattention_id=(1,), t_biattention_id=(1,))
FAMILIES = {
    "visualbert": (jvisualbert.VisualBertForMaskedLM, jvisualbert.VisualBertConfig,
                   visualbert.VisualBertForMaskedLM, visualbert.VisualBertConfig, {}),
    "vilbert": (jvilbert.VilBertForMaskedLM, jvilbert.VilBertConfig,
                vilbert.VilBertForMaskedLM, vilbert.VilBertConfig, TINY_VILBERT),
}


def region_mask():
    """(B, 72): batch row 1 misses its second image (36 regions masked),
    batch row 2 both (every region masked)."""
    vam = np.ones((B, REGIONS), np.float32)
    vam[1, REGIONS // 2:] = 0.0
    vam[2] = 0.0
    return vam


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.int32)
    mask[1, 12:] = 0
    mask[2, 10:] = 0
    return dict(
        input_ids=rng.integers(5, V, (B, L)).astype(np.int32),
        attention_mask=mask,
        token_type_ids=(np.arange(L)[None] >= 7).astype(np.int32).repeat(B, 0),
        pixel_values=rng.standard_normal((B, REGIONS, FEAT)).astype(np.float32),
        positions=rng.integers(0, 10, (B, 5)).astype(np.int32),
        boundary=np.array([6, 9, 4], np.int32),
        visual_attention_mask=region_mask(),
    )


def build_pair(name, dropout=True, **cfg_kw):
    """(flax model, its variables, the port's model on the converted
    weights, loaded strictly). The adaptive scalars are moved off their clip
    bound (w1 = 0.5 exactly) and made to differ per layer, so a wrong
    geometry shows."""
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


@contextlib.contextmanager
def jax_attention(backend):
    """The Flax models' attention route for a port backend: ``flash`` takes
    JAX's flash kernels (``--fused_attention flash``: the Pallas kernels, in
    interpret mode on the CPU), the others its einsum path."""
    saved = (jcommon.USE_FUSED_ATTENTION, jcommon.FUSED_INTERPRET, jcommon.FUSED_BACKEND)
    try:
        if backend == "flash":
            jcommon.set_fused_attention(True, interpret=True, backend="flash")
        yield
    finally:
        (jcommon.USE_FUSED_ATTENTION, jcommon.FUSED_INTERPRET,
         jcommon.FUSED_BACKEND) = saved


def flax_trans(flax_model, params, batch, backend="plain"):
    with jax_attention(backend):
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


@pytest.mark.parametrize("backend", ["single", "plain", "flash"])
def test_forward_matches_jax(pair, backend):
    """Transformed states and tied logits through each attention backend
    (on the CPU each kernel's plain version; ViLBERT's visual layers at
    head_dim 128) against the Flax model, through JAX's flash kernels where
    the port takes its own."""
    name, flax_model, params, model = pair
    batch = make_batch()
    set_backend(model, backend)
    want = flax_trans(flax_model, params, batch, backend)
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
    """The converted tree loads strictly (it did in build_pair) and has the
    names and shapes of the port's module; ViLBERT's tree has no loc_proj."""
    name, _, params, model = pair
    sd = params_from_jax(params)
    assert set(sd) == set(model.state_dict())
    if name == "visualbert":
        assert sd["embeddings.visual_projection.weight"].shape == (H, FEAT)
        assert sd["embeddings.visual_position_embeddings"].shape == (64, H)
        assert sd["layer_1.adaptive_w1"].shape == (1,)
    else:
        assert not any(k.startswith("loc_proj") for k in sd)
        assert sd["image_proj.weight"].shape == (256, FEAT)
        assert sd["v_layer_1.attn.query.weight"].shape == (256, 256)
        assert sd["c_layer_0.txt_from_img.key.weight"].shape == (256, 256)
        assert sd["c_layer_0.img_from_txt.out.weight"].shape == (256, 256)
        assert model.v_layer_0.attn.num_heads == 2  # head_dim 128


def test_regions_and_multiplier_have_effect(pair):
    """The boundary changes the output (the adaptive mask is active, on both
    sides alike), no boundary is the plain attention, the region features
    reach the text positions, and so does the region mask."""
    _, flax_model, params, model = pair
    batch = make_batch()
    base = port_trans(model, batch)
    moved = dict(batch, boundary=np.array([3, 13, 8], np.int32))
    got = port_trans(model, moved)
    assert np.abs(got - base).max() > 1e-4
    np.testing.assert_allclose(got, flax_trans(flax_model, params, moved), atol=MODEL_ATOL)
    none = dict(batch, boundary=None)
    np.testing.assert_allclose(port_trans(model, none), flax_trans(flax_model, params, none),
                               atol=MODEL_ATOL)
    dark = dict(batch, pixel_values=batch["pixel_values"] * 0.0)
    assert np.abs(port_trans(model, dark) - base).max() > 1e-4
    unmasked = dict(batch, visual_attention_mask=None)
    got = port_trans(model, unmasked)
    assert np.abs(got - base).max() > 1e-4
    np.testing.assert_allclose(got, flax_trans(flax_model, params, unmasked), atol=MODEL_ATOL)


@pytest.mark.parametrize("backend", ["single", "plain", "flash"])
def test_visualbert_reference_mask_offset_matches_jax(backend):
    """``compat_ref_mask_offset``: the geometry shifted by the 72 regions
    (rows from 73, the boundary at sep + 72, columns to the sequence end),
    against the Flax model, and unlike the default."""
    flax_model, params, model = build_pair("visualbert", compat_ref_mask_offset=True)
    assert model.layer_0.compat_img_offset == REGIONS and model.layer_0.row_start == 1
    set_backend(model, backend)
    batch = make_batch()
    got = port_trans(model, batch)
    np.testing.assert_allclose(got, flax_trans(flax_model, params, batch, backend),
                               atol=MODEL_ATOL)
    default = visualbert.VisualBertForMaskedLM(
        visualbert.VisualBertConfig(text=model.cfg.text, dtype="float32"))
    default.load_state_dict(model.state_dict())
    assert np.abs(port_trans(default, batch) - got).max() > 1e-4


@pytest.mark.parametrize("backend", ["single", "plain", "flash"])
def test_vilbert_ablate_img_to_txt_matches_jax(backend):
    """``ablate_img_to_txt``: the image->text co-attention context dropped,
    against the Flax model; the regions then no longer reach the text."""
    flax_model, params, model = build_pair("vilbert", ablate_img_to_txt=True)
    set_backend(model, backend)
    batch = make_batch()
    got = port_trans(model, batch)
    np.testing.assert_allclose(got, flax_trans(flax_model, params, batch, backend),
                               atol=MODEL_ATOL)
    dark = dict(batch, pixel_values=batch["pixel_values"] * 0.0)
    np.testing.assert_array_equal(port_trans(model, dark), got)


def test_vilbert_refuses_region_boxes():
    """The model has no loc_proj: region boxes raise instead of being
    dropped."""
    model = vilbert.VilBertForMaskedLM(vilbert.VilBertConfig(
        text=TextConfig(**TINY_TEXT), dtype="float32", **TINY_VILBERT))
    model.init_params(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with pytest.raises(ValueError, match="loc_proj"):
        model(**batch, image_locs=torch.zeros(B, REGIONS, 5))


class _Vocab:
    analogy_entity_ids = np.arange(16, dtype=np.int32) + 40
    analogy_relation_ids = np.arange(4, dtype=np.int32) + 100
    r_token_id = 110
    entity_id_st, entity_id_ed = 40, 90
    relation_id_st, relation_id_ed = 90, 110
    padded_vocab_size = V


class _CrossAttentionNoDropout(jvilbert.CrossAttention):
    """The Flax cross-attention with its fixed probability dropout (0.1,
    not a config field) off."""

    dropout: float = 0.0


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_finetune_step_matches_jax(name, monkeypatch):
    """One fp32 fine-tune step, dropout rates 0 (ViLBERT's cross-attention
    dropout too, a fixed 0.1 on both sides), on the same converted weights
    and batch: the JAX trainer's ``_finetune_loss`` differentiated by
    ``jax.grad`` against the port's through the single-block attention (on
    the CPU its plain forward and backward; ViLBERT's visual layers at
    head_dim 128). The loss and its two terms within 1e-5 relative; each
    gradient leaf within 1e-4 of that leaf's largest |gradient| plus 1e-7 of
    the model's largest (leaves whose exact gradient is 0, the key biases,
    carry round-off only)."""
    from mkg_analogy_tpu.core.mesh import make_mesh
    from mkg_analogy_tpu.train import trainer as jtrainer
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    monkeypatch.setattr(jvilbert, "CrossAttention", _CrossAttentionNoDropout)
    flax_model, params, model = build_pair(name, dropout=False)
    for m in model.modules():
        if isinstance(m, vilbert.CrossAttention):
            m.dropout_rate = 0.0
    rng = np.random.default_rng(2)
    mask = np.ones((B, L), np.int32)
    mask[1, 15:] = 0
    batch = dict(
        input_ids=rng.integers(5, V, (B, L)).astype(np.int32),
        attention_mask=mask,
        token_type_ids=np.zeros((B, L), np.int32),
        pixel_values=rng.standard_normal((B, REGIONS, FEAT)).astype(np.float32),
        visual_attention_mask=region_mask(),
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
        if g is None:
            # a parameter the loss never reads (ViLBERT's visual stream after
            # its last connection layer): JAX's gradient is exactly zero
            assert name == "vilbert" and not w.any(), leaf
            continue
        bound = 1e-4 * float(w.abs().max()) + 1e-7 * top
        err = float((g - w).abs().max())
        assert err <= bound, (leaf, err, bound)
    first = "layer_0" if name == "visualbert" else "t_layer_0"
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


def _vilbert_schedule(cfg):
    return cfg.v_num_layers, tuple(cfg.v_biattention_id), tuple(cfg.t_biattention_id)


@pytest.mark.parametrize("num_layers", [2, 3, 4, 12])
def test_registry_connection_schedule_matches_jax(num_layers):
    """The reduced-depth rendezvous schedule of ViLBERT (JAX
    registry.py:_vilbert) at 2, 3, 4 and 12 text layers, built on the meta
    device at full width; the ablation flag passes through."""
    want = jregistry.create_model("VilBertKGC", vocab_size=256, num_layers=num_layers,
                                  vilbert_ablate_img_to_txt=True).cfg
    with torch.device("meta"):
        got = registry.create_model("VilBertKGC", vocab_size=256, num_layers=num_layers,
                                    vilbert_ablate_img_to_txt=True)
    assert _vilbert_schedule(got.cfg) == _vilbert_schedule(want)
    assert got.cfg.ablate_img_to_txt and want.ablate_img_to_txt
    assert sum(1 for n, _ in got.named_children() if n.startswith("c_layer_")) == len(
        want.v_biattention_id)


def test_registry_creates_the_region_families():
    """Full-width constructors on the meta device: VisualBERT 88.2M and
    ViLBERT 211.2M parameters at vocab 256 (the JAX models' counts by
    jax.eval_shape), the single-block attention by default, ViLBERT's visual
    stream at head_dim 128; ``available_models`` lists JAX's names and
    KimiVLKGC, the one family without a JAX counterpart."""
    assert registry.DEFAULT_ATTENTION["VisualBertKGC"] == "single"
    assert registry.DEFAULT_ATTENTION["VilBertKGC"] == "single"
    assert registry.available_models() == sorted(jregistry.available_models() + ["KimiVLKGC"])
    with torch.device("meta"):
        vb = registry.create_model("VisualBertKGC", vocab_size=256)
        vl = registry.create_model("VilBertKGC", vocab_size=256, attention="plain")
    assert isinstance(vb, visualbert.VisualBertForMaskedLM)
    assert isinstance(vl, vilbert.VilBertForMaskedLM)
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert round(count(vb) / 1e6, 1) == 88.2 and round(count(vl) / 1e6, 1) == 211.2
    assert vb.layer_11.layer.attn.backend == "single"
    attn = vl.v_layer_5.attn
    assert attn.backend == "plain" and attn.query.out_features // attn.num_heads == 128
    assert hasattr(vb, "logits") and hasattr(vl, "logits")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("region_kg")
    return make_tiny_dataset(str(root))


@pytest.fixture(scope="module")
def jax_metric_keys(dataset, tmp_path_factory):
    """The metric keys of the JAX CLI's region-feature evaluation
    (VisualBERT, synthetic regions, ``--only_test``: the keys a fit's test
    returns, whatever the family)."""
    from mkg_analogy_tpu.cli import main as jax_cli

    markg_dir, mars_dir = dataset
    out = tmp_path_factory.mktemp("jax_cli")
    metrics = jax_cli.main([
        "--data_dir", mars_dir, "--pretrain_path", markg_dir, "--model_class",
        "VisualBertKGC", "--image_features", "synthetic", "--only_test",
        "--eval_batch_size", "8", "--max_seq_length", "48",
        "--text_vocab_size", "256", "--hidden_size", "32", "--num_layers", "2",
        "--num_heads", "2", "--intermediate_size", "64", "--dtype", "float32",
        "--output_dir", str(out / "out"), "--log_dir", str(out / "logs"),
        "--cache_dir", str(out / "cache")])
    return set(metrics)


@pytest.mark.parametrize("model_class,alpha", [("VisualBertKGC", "0.43"),
                                               ("VilBertKGC", "0.43")])
def test_cli_finetunes_on_synthetic_regions(dataset, jax_metric_keys, tmp_path, model_class,
                                            alpha):
    """This slice's path end to end on the CPU: synthetic region tables
    (each entity's 36 regions one Gaussian 2048-d code, built from a seeded
    torch.Generator), one tiny fine-tune epoch with the best-dev checkpoint,
    the JAX CLI's metric keys with finite values, and ``--only_test
    --checkpoint`` reproducing the ranks."""
    from mkg_analogy_tpu_torch.train import checkpoint

    markg_dir, mars_dir = dataset

    def flags(tag, *extra):
        return ["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--device", "cpu",
                "--model_class", model_class, "--image_features", "synthetic",
                "--alpha", alpha, "--max_epochs", "1", "--batch_size", "8",
                "--eval_batch_size", "8", "--max_seq_length", "48", "--text_vocab_size", "256",
                "--hidden_size", "32", "--num_layers", "2", "--num_heads", "2",
                "--intermediate_size", "64", "--dtype", "float32", "--lr", "1e-3",
                "--output_dir", str(tmp_path / f"out_{tag}"),
                "--log_dir", str(tmp_path / f"logs_{tag}"),
                "--cache_dir", str(tmp_path / "cache"), *extra]

    got = port_cli.main(flags("fit"))
    # the port's one extra key: rows whose gold logit is not finite, none here
    assert set(got) == jax_metric_keys | {"Eval_entity/nonfinite_gold"}
    assert got["Eval_entity/nonfinite_gold"] == 0.0
    assert all(np.isfinite(v) for v in got.values()) and 0.0 < got["Eval_entity/mrr"] <= 1.0
    ckpt = tmp_path / "out_fit" / "ckpt"
    assert checkpoint.list_steps(str(ckpt)) == [3]  # 24 examples / 8 a batch
    ranks = np.load(tmp_path / "out_fit" / "test_ranks.npz")["ranks"]
    retest = port_cli.main(flags("retest", "--only_test", "--checkpoint", str(ckpt)))
    np.testing.assert_array_equal(
        np.load(tmp_path / "out_retest" / "test_ranks.npz")["ranks"], ranks)
    assert retest == got


def test_synthetic_region_tables():
    """The region branch of ``synthetic_image_table``: (N + 1, 36, 2048)
    bf16, the last row the zero pad row; "synthetic" one code an entity
    shared by its 36 regions, "synthetic_noise" independent draws."""
    ident = port_cli.synthetic_image_table("synthetic", 5, None, torch.device("cpu"),
                                           kind="regions")
    noise = port_cli.synthetic_image_table("synthetic_noise", 5, None, torch.device("cpu"),
                                           kind="regions")
    for tab in (ident, noise):
        assert tab.shape == (6, 36, 2048) and tab.dtype == torch.bfloat16
        assert not tab[5].any() and tab[:5].float().std() > 0.5
    assert torch.equal(ident[:, :1].expand(-1, 36, -1), ident)
    assert not torch.equal(noise[:, :1].expand(-1, 36, -1), noise)
    again = port_cli.synthetic_image_table("synthetic", 5, None, torch.device("cpu"),
                                           kind="regions")
    assert torch.equal(again, ident)


@pytest.mark.parametrize("model_class", ["VisualBertKGC", "VilBertKGC"])
def test_cli_cuda_without_gpu_raises(dataset, tmp_path, model_class):
    """--device cuda (the default) never falls back to the CPU, for the
    region families too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    markg_dir, mars_dir = dataset
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--data_dir", mars_dir, "--pretrain_path", markg_dir,
                       "--model_class", model_class, "--image_features", "synthetic",
                       "--output_dir", str(tmp_path / "out")])
