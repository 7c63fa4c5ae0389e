"""Port parity for the pre-training slice, against the JAX package on
tests/util.make_tiny_dataset: the triple and pseudo-analogy features and
their cache keys; one fp32 triple pre-train step through the flash
attention (loss and every gradient leaf) against ``jax.grad`` of the JAX
trainer's ``_pretrain_loss`` on converted weights; the triple evaluation's
entity and relation ranks; the mixed diet's batch order; the attention
auto-route at L=512; and the CLI's three formats and a fine-tune from a
pre-train checkpoint on the CPU."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.cli import main as port_cli
from mkg_analogy_tpu_torch.data.module import KGCDataModule
from mkg_analogy_tpu_torch.models import common
from mkg_analogy_tpu_torch.train import checkpoint
from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig
from tests.util import make_tiny_dataset, tiny_unimo_config

torch.set_num_threads(1)

SEQ = 48


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_tiny_dataset(str(tmp_path_factory.mktemp("port_pretrain_kg")))


def _module_kwargs(dataset, cache_dir=None):
    markg_dir, mars_dir = dataset
    return dict(data_dir=mars_dir, pretrain_path=markg_dir, max_seq_length=SEQ,
                text_vocab_size=200, image_size=16, pretrain=True, seed=3,
                cache_dir=cache_dir)


@pytest.fixture(scope="module")
def data_pair(dataset):
    from mkg_analogy_tpu.data.module import KGCDataModule as JaxDataModule

    kw = _module_kwargs(dataset)
    return JaxDataModule(**kw), KGCDataModule(**kw)


@pytest.mark.parametrize("fmt", ["triple", "analogy"])
def test_pretrain_features_equal_jax(data_pair, fmt):
    """build_pretrain_features / build_pseudo_analogy_features through the
    data modules: the same arrays, dtypes and keys (the modality draws and
    the partner draws come from the same default_rng(seed) stream)."""
    jdata, pdata = data_pair
    want, got = jdata.features("train", fmt=fmt), pdata.features("train", fmt=fmt)
    assert set(got) == set(want)
    assert ("pre_type" in got) == (fmt == "triple")
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{fmt}/{k}")
    for data in (jdata, pdata):
        with pytest.raises(ValueError, match="diet"):
            data.features("train", fmt="mixed")


def test_pretrain_cache_keys_equal_jax(dataset, tmp_path):
    """The cache file of each format carries the seed (_S) and, past the
    triple format, the format (_F), as the JAX module names it; a cached
    read returns the built arrays."""
    from mkg_analogy_tpu.data.module import KGCDataModule as JaxDataModule

    kw = _module_kwargs(dataset, cache_dir=str(tmp_path))
    jdata, pdata = JaxDataModule(**kw), KGCDataModule(**kw)
    for fmt in ("triple", "analogy"):
        name = os.path.basename(pdata._cache_path("train", fmt))
        assert name == os.path.basename(jdata._cache_path("train", fmt))
        assert "_S3" in name and (("_Fanalogy" in name) == (fmt == "analogy"))
        built = pdata.features("train", fmt=fmt)
        cached = pdata.features("train", fmt=fmt)
        for k in built:
            np.testing.assert_array_equal(cached[k], built[k])


def test_builders_refuse_labels_out_of_range(data_pair):
    """The host-side label-range check of build_pretrain_features: a
    relation label past the relation range raises."""
    from mkg_analogy_tpu_torch.data import prompt

    _, pdata = data_pair
    vocab = dataclasses.replace(pdata.vocab)  # a copy with a shorter relation range
    vocab.relation_id_ed = vocab.relation_id_st + 1
    with pytest.raises(ValueError, match="relation labels"):
        prompt.build_pretrain_features(pdata.markg, vocab, SEQ, seed=3)


@pytest.fixture(scope="module")
def tiny_models(data_pair):
    """A Flax UnimoForMaskedLM with random weights and a factory of port
    models on the same converted weights (fp32, 2 layers, dropout 0)."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.models.unimo import UnimoForMaskedLM as FlaxUnimo
    from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax
    from mkg_analogy_tpu_torch.models.unimo import UnimoForMaskedLM
    from tests.test_torch_port_unimo import port_config

    jdata, _ = data_pair
    assert jdata.vocab.padded_vocab_size <= 256
    cfg = tiny_unimo_config(vocab_size=256)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, hidden_dropout=0.0, attention_dropout=0.0))
    b = 2
    rng = np.random.default_rng(0)
    sample = dict(
        input_ids=rng.integers(0, 256, (b, SEQ)).astype(np.int32),
        attention_mask=np.ones((b, SEQ), np.int32),
        token_type_ids=np.zeros((b, SEQ), np.int32),
        pixel_values=rng.standard_normal((b, 2, 3, 16, 16)).astype(np.float32),
        positions=rng.integers(0, 9, (b, 5)).astype(np.int32),
        boundary=np.array([4, 6], np.int32),
    )
    flax_model = FlaxUnimo(cfg)
    params = jax.device_get(jax.jit(lambda key, batch: flax_model.init(
        key, **batch, deterministic=True))(
        jax.random.PRNGKey(2), {k: jnp.asarray(v) for k, v in sample.items()}))

    def port_model(attention):
        model = UnimoForMaskedLM(dataclasses.replace(port_config(cfg), attention=attention))
        model.load_state_dict(unimo_params_from_jax(params), strict=True)
        return model

    return flax_model, params, port_model


def _jax_mesh():
    import jax
    from mkg_analogy_tpu.core.mesh import make_mesh

    return make_mesh(dp=1, tp=1, devices=jax.devices()[:1])


def test_triple_pretrain_step_matches_jax(data_pair, tiny_models):
    """One fp32 triple pre-train step on the same converted weights and
    batch (link and relation prediction rows mixed), dropout 0, both sides
    through the flash attention: JAX's Pallas flash kernels in interpret
    mode under jax.grad, the port's autograd.Function (plain flash forward
    and backward on the CPU). The loss and its two terms within 1e-5
    relative; each gradient leaf within 1e-4 of that leaf's largest
    |gradient| plus 1e-7 of the model's largest (fp32 on both sides, summed
    in other orders; the floor covers the key biases, whose exact gradient
    is 0)."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.models import common as jcommon
    from mkg_analogy_tpu.train import trainer as jtrainer
    from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax

    jdata, pdata = data_pair
    flax_model, params, port_model = tiny_models
    feats = jdata.features("train", fmt="triple")
    batch = {k: v[:6] for k, v in feats.items()}
    assert set(batch["pre_type"].tolist()) == {1, 2}
    batch["pixel_values"] = np.random.default_rng(7).standard_normal(
        (6, 2, 3, 16, 16)).astype(np.float32)

    jt = jtrainer.MarTTrainer(flax_model, jdata.vocab, jtrainer.TrainConfig(pretrain=True),
                              mesh=_jax_mesh())
    saved = (jcommon.USE_FUSED_ATTENTION, jcommon.FUSED_INTERPRET, jcommon.FUSED_BACKEND)
    try:
        jcommon.set_fused_attention(True, interpret=True, backend="flash")
        (want_loss, want_aux), want_g = jax.jit(jax.value_and_grad(
            lambda p, b: jt._pretrain_loss(p, b, jax.random.PRNGKey(1)), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        (jcommon.USE_FUSED_ATTENTION, jcommon.FUSED_INTERPRET,
         jcommon.FUSED_BACKEND) = saved

    model = port_model("flash")
    pt = MarTTrainer(model, pdata.vocab, TrainConfig(pretrain=True), device="cpu")
    loss, aux = pt._pretrain_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                                  common.DropoutRNG.from_seed(1, "cpu"))
    loss.backward()
    for k in ("loss", "ent_loss", "rel_loss"):
        want = float(want_loss) if k == "loss" else float(want_aux[k])
        assert abs(aux[k].item() - want) <= 1e-5 * abs(want), (k, aux[k].item(), want)
    want = unimo_params_from_jax(jax.device_get(want_g))
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    top = max(float(w.abs().max()) for w in want.values())
    unused = set()
    for name, w in want.items():
        g = got[name].grad
        if g is None:  # not reached by this loss; the optimizer takes zeros
            unused.add(name)
            g = torch.zeros_like(w)
        bound = 1e-4 * float(w.abs().max()) + 1e-7 * top
        err = float((g - w).abs().max())
        assert err <= bound, (name, err, bound)
    # the triple prompt has no analogy boundary: the adaptive scalars alone
    # get no gradient (JAX: exact zeros)
    assert unused == {f"encoder.text_{i}.adaptive_w{j}" for i in (0, 1) for j in (0, 1)}


@pytest.mark.parametrize("fmt", ["triple", "analogy"])
def test_pretrain_evaluate_matches_jax(data_pair, tiny_models, tmp_path, fmt):
    """The same converted weights, features and image table: identical
    ranks and relation flags (triple: entity ranks over the entity range,
    relation ranks over the relation range; analogy: over every MarKG
    entity), every metric within 1e-6 (fp32 means over the same ranks)."""
    import jax
    from mkg_analogy_tpu.train import trainer as jtrainer

    jdata, pdata = data_pair
    flax_model, params, port_model = tiny_models
    table = np.random.default_rng(1).standard_normal(
        (jdata.markg.num_entities + 1, 3, 16, 16)).astype(np.float32)
    table[-1] = 0.0
    flags = dict(pretrain=True, analogy_pretrain=fmt == "analogy", eval_batch_size=8)
    feats = jdata.features("train", fmt=fmt)
    jt = jtrainer.MarTTrainer(flax_model, jdata.vocab, jtrainer.TrainConfig(**flags),
                              mesh=_jax_mesh())
    jt.set_image_table(table)
    want = jt.evaluate(jax.device_put(params), feats, dump_path=str(tmp_path / "jax.npz"))

    pt = MarTTrainer(port_model("flash"), pdata.vocab, TrainConfig(**flags), device="cpu")
    pt.set_image_table(table)
    got = pt.evaluate(pdata.features("train", fmt=fmt), dump_path=str(tmp_path / "port.npz"))
    jd, pd = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert set(pd.files) == set(jd.files)
    for k in jd.files:
        np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
    assert pd["is_rel"].any() == (fmt == "triple")
    # the port's extra keys: rows whose gold logit is not finite, none here
    extra = {f"Eval_{kind}/nonfinite_gold"
             for kind in (("entity", "relation") if fmt == "triple" else ("entity",))}
    assert set(got) == set(want) | extra
    assert all(got[k] == 0.0 for k in extra)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_mixed_diet_order_matches_jax_fit(data_pair, tiny_models, monkeypatch):
    """The mixed diet takes its batches in the JAX fit's order: per epoch a
    default_rng(seed) shuffle of the batch tags over two iterators seeded
    seed and seed + 1, after the batch JAX draws to shape its state. Both
    fits run with their train steps replaced by recorders; two epochs."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.train import trainer as jtrainer

    jdata, pdata = data_pair
    flax_model, _, port_model = tiny_models
    flags = dict(pretrain=True, analogy_pretrain=True, mixed_pretrain=True, batch_size=4,
                 max_epochs=2, seed=5, check_val_every_n_epoch=100)
    feats = (jdata.features("train", fmt="triple"), jdata.features("train", fmt="analogy"))

    jax_order = []
    jt = jtrainer.MarTTrainer(flax_model, jdata.vocab, jtrainer.TrainConfig(**flags),
                              mesh=_jax_mesh())

    def jax_step(name):
        def step(state, batch, rng, *rest):
            jax_order.append(("triple" if name == "train_triple" else "finetune",
                              np.asarray(batch["input_ids"]).tobytes()))
            return state, {"loss": jnp.zeros(())}
        return step

    monkeypatch.setattr(jt, "init_state", lambda rng, sample, total: object())
    monkeypatch.setattr(jt, "_get_jitted", lambda name, fn, donate=(): jax_step(name))
    jt.fit(feats, feats[1])

    port_order = []
    pt = MarTTrainer(port_model("plain"), pdata.vocab, TrainConfig(**flags), device="cpu")

    def port_step(optimizer, batch, step, image_table=None, loss_kind=None):
        port_order.append((loss_kind, batch["input_ids"].numpy().tobytes()))
        return {}

    monkeypatch.setattr(pt, "_train_step", port_step)
    steps, _ = pt.fit(feats, feats[1])
    n_t, n_a = len(feats[0]["label"]) // 4, len(feats[1]["label"]) // 4
    assert steps == 2 * (n_t + n_a) == len(port_order)
    assert {kind for kind, _ in port_order} == {"triple", "finetune"}
    assert port_order == jax_order


def test_auto_route_takes_flash_from_512(monkeypatch):
    """On the plain route a query length of FLASH_AUTO_MIN_LEN (512) or more
    goes to the flash attention, as JAX's force_flash does; 511 stays plain.
    Through the model at L=512: every text layer routes there, the vision
    layers (99 queries) do not."""
    from mkg_analogy_tpu_torch.models.unimo import (
        TextConfig,
        UnimoConfig,
        UnimoForMaskedLM,
        VisionConfig,
    )

    calls = []
    real = common.ATTENTION_BACKENDS["flash"]

    def spy(q, *args, **kwargs):
        calls.append(q.shape[1])
        return real(q, *args, **kwargs)

    monkeypatch.setitem(common.ATTENTION_BACKENDS, "flash", spy)
    core = common.AttentionCore(16, 2, 8, backend="plain")
    for length in (511, 512):
        x = torch.from_numpy(np.random.default_rng(length).standard_normal(
            (1, length, 16)).astype(np.float32))
        got, _ = core(x)
        ctx = common.fused_attention_reference(
            core.query(x), core.key(x), core.value(x), torch.ones(1, length), 2,
            compute_dtype=torch.float32)
        torch.testing.assert_close(got, core.out(ctx), atol=1e-5, rtol=0)
    assert calls == [512]

    calls.clear()
    model = UnimoForMaskedLM(UnimoConfig(
        text=TextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                        intermediate_size=64, max_position_embeddings=512),
        vision=VisionConfig(hidden_size=32, num_layers=2, num_heads=2,
                            intermediate_size=64, image_size=16, patch_size=8),
        fusion_start=1, dtype="float32", attention="plain"))
    model.init_params(torch.Generator().manual_seed(0))
    ids = torch.zeros(1, 512, dtype=torch.int64)
    with torch.inference_mode():
        model(input_ids=ids, attention_mask=torch.ones_like(ids), token_type_ids=ids,
              pixel_values=torch.zeros(1, 2, 3, 16, 16),
              positions=torch.zeros(1, 1, dtype=torch.int64))
    assert calls == [512, 512]


def _flags(dataset, tmp_path, tag, *extra):
    markg_dir, mars_dir = dataset
    return ["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--device", "cpu",
            "--max_epochs", "1", "--batch_size", "8", "--eval_batch_size", "8",
            "--max_seq_length", str(SEQ), "--text_vocab_size", "256", "--hidden_size", "32",
            "--num_layers", "2", "--num_heads", "2", "--intermediate_size", "64",
            "--dtype", "float32", "--lr", "1e-3", "--fused_attention", "flash",
            "--output_dir", str(tmp_path / f"out_{tag}"),
            "--log_dir", str(tmp_path / f"logs_{tag}"),
            "--cache_dir", str(tmp_path / "cache"), *extra]


@pytest.mark.parametrize("fmt", ["triple", "analogy", "mixed"])
def test_cli_pretrain_formats(dataset, tmp_path, fmt):
    """--pretrain 1 --fused_attention flash on the CPU for each format:
    finite metrics on the training features (relation metrics for the
    triple format), a checkpoint of the best Hits@10, and the JAX CLI's
    metric names."""
    got = port_cli.main(_flags(dataset, tmp_path, fmt, "--pretrain", "1",
                               "--pretrain_format", fmt))
    assert all(np.isfinite(v) for v in got.values())
    assert 0.0 < got["Eval_entity/mrr"] <= 1.0
    assert ("Eval_relation/mrr" in got) == (fmt == "triple")
    assert ("Eval_entity/tie_mean" in got) == (fmt != "triple")
    assert len(checkpoint.list_steps(str(tmp_path / f"out_{fmt}" / "ckpt"))) == 1


def test_cli_finetune_from_pretrain_checkpoint(dataset, tmp_path):
    """A triple pre-train, then a fine-tune whose --checkpoint is the
    pre-train checkpoint: the fit starts from the pre-trained weights (its
    first loss differs from a fit from the seed's weights) and tests."""
    port_cli.main(_flags(dataset, tmp_path, "pre", "--pretrain", "1"))
    ckpt = str(tmp_path / "out_pre" / "ckpt")
    assert checkpoint.list_steps(ckpt)
    tuned = port_cli.main(_flags(dataset, tmp_path, "ft", "--checkpoint", ckpt))
    fresh = port_cli.main(_flags(dataset, tmp_path, "fresh"))
    assert all(np.isfinite(v) for v in tuned.values())
    assert "Eval_relation/mrr" not in tuned
    assert tuned != fresh
