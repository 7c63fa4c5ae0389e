"""The port's slice as a whole, against the JAX package on
tests/util.make_tiny_dataset: the fine-tune features, MarTTrainer.evaluate
on the same (converted) weights, and the --only_test CLI."""

import jax
import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.cli import main as port_cli
from mkg_analogy_tpu_torch.data.module import KGCDataModule
from mkg_analogy_tpu_torch.models import registry
from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax
from mkg_analogy_tpu_torch.models.unimo import UnimoForMaskedLM
from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig
from tests.test_torch_port_unimo import port_config
from tests.util import make_tiny_dataset, tiny_unimo_config

torch.set_num_threads(1)

SEQ = 48


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_kg")
    # 60 analogies -> 15 test examples: two eval batches of 8, one padded
    markg_dir, mars_dir = make_tiny_dataset(str(root), n_analogy=60)
    return str(root), markg_dir, mars_dir


@pytest.fixture(scope="module")
def data_pair(dataset):
    from mkg_analogy_tpu.data.module import KGCDataModule as JaxDataModule

    _, markg_dir, mars_dir = dataset
    kw = dict(data_dir=mars_dir, pretrain_path=markg_dir, max_seq_length=SEQ,
              text_vocab_size=256, image_size=16)
    return JaxDataModule(**kw), KGCDataModule(**kw)


def test_features_equal_jax(data_pair):
    jdata, pdata = data_pair
    assert pdata.vocab.padded_vocab_size == jdata.vocab.padded_vocab_size
    np.testing.assert_array_equal(pdata.vocab.analogy_entity_ids,
                                  jdata.vocab.analogy_entity_ids)
    for split in ("train", "test"):
        want, got = jdata.features(split), pdata.features(split)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split}/{k}")


def test_evaluate_matches_jax(data_pair, tmp_path):
    """Same converted weights, same features, same bf16-rounded image table:
    identical ranks, ties and modes; every metric within 1e-6 (fp32 means
    over the same ranks, summed in another order)."""
    from mkg_analogy_tpu.core.mesh import make_mesh
    from mkg_analogy_tpu.data.batching import BatchIterator
    from mkg_analogy_tpu.models.unimo import UnimoForMaskedLM as FlaxUnimo
    from mkg_analogy_tpu.train import trainer as jtrainer

    jdata, pdata = data_pair
    cfg = tiny_unimo_config(jdata.vocab.padded_vocab_size)
    rng = np.random.default_rng(0)
    table = rng.standard_normal((jdata.markg.num_entities + 1, 3, 16, 16)).astype(np.float32)
    table[-1] = 0.0
    feats = jdata.features("test")

    jt = jtrainer.MarTTrainer(FlaxUnimo(cfg), jdata.vocab,
                              jtrainer.TrainConfig(eval_batch_size=8),
                              mesh=make_mesh(dp=1, tp=1, devices=jax.devices()[:1]))
    jt.set_image_table(table)
    sample = next(iter(BatchIterator(feats, 8, shuffle=False)))
    sample.pop("valid")
    params = jt.init_state(jax.random.PRNGKey(0), sample, total_steps=1).params
    want = jt.evaluate(params, feats, dump_path=str(tmp_path / "jax.npz"))

    model = UnimoForMaskedLM(port_config(cfg))
    model.load_state_dict(unimo_params_from_jax(jax.device_get(params)), strict=True)
    pt = MarTTrainer(model, pdata.vocab, TrainConfig(eval_batch_size=8), device="cpu")
    pt.set_image_table(table)
    got = pt.evaluate(pdata.features("test"), dump_path=str(tmp_path / "port.npz"))

    jd, pd = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert len(pd["ranks"]) == 15
    for k in ("ranks", "tie", "mode", "is_rel"):
        np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
    # the port's one extra key: rows whose gold logit is not finite, none here
    assert set(got) == set(want) | {"Eval_entity/nonfinite_gold"}
    assert got["Eval_entity/nonfinite_gold"] == 0.0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def cli_flags(dataset, tmp_path):
    _, markg_dir, mars_dir = dataset
    return ["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--only_test",
            "--eval_batch_size", "8", "--max_seq_length", str(SEQ),
            "--text_vocab_size", "256", "--hidden_size", "32", "--num_layers", "2",
            "--num_heads", "2", "--intermediate_size", "64", "--dtype", "float32",
            "--output_dir", str(tmp_path / "out"), "--log_dir", str(tmp_path / "logs"),
            "--cache_dir", str(tmp_path / "cache")]


def test_cli_only_test_keys_match_jax(dataset, tmp_path):
    from mkg_analogy_tpu.cli.main import main as jax_main

    flags = cli_flags(dataset, tmp_path)
    got = port_cli.main(flags + ["--device", "cpu"])
    want = jax_main(flags)
    assert set(got) == set(want) | {"Eval_entity/nonfinite_gold"}
    assert all(np.isfinite(v) for v in got.values())
    assert 0.0 < got["Eval_entity/mrr"] <= 1.0
    assert got["Eval_entity/hits1"] <= got["Eval_entity/hits10"]
    assert (tmp_path / "out" / "test_ranks.npz").exists()


def test_cli_cuda_without_gpu_raises(dataset, tmp_path):
    """--device cuda (the default) never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(cli_flags(dataset, tmp_path))


@pytest.fixture(scope="module")
def single_process_metrics(dataset, tmp_path_factory):
    """The single-process CLI's test metrics, --only_test and after a
    one-epoch fit (batch 4), on the CPU."""
    tmp = tmp_path_factory.mktemp("port_cli_single")
    return {only_test: port_cli.main(_mesh_cli_flags(dataset, tmp, only_test))
            for only_test in (True, False)}


def _mesh_cli_flags(dataset, tmp_path, only_test):
    flags = [f for f in cli_flags(dataset, tmp_path) if f != "--only_test"] + ["--device", "cpu"]
    if only_test:
        return flags + ["--only_test"]
    return flags + ["--max_epochs", "1", "--batch_size", "4", "--lr", "1e-3"]


@pytest.mark.parametrize("extra", [
    ["--tp", "2"], ["--dp", "2"], ["--dp", "2", "--tp", "2"],
])
def test_cli_refuses_what_later_slices_bring(dataset, tmp_path, single_process_metrics,
                                             capsys, extra):
    """--dp/--tp, once refused, now run: under --device cpu the CLI spawns
    one gloo process a rank and prints and returns the single-process test
    metrics, with --only_test and after a one-epoch fit (the same ranks,
    so the same metrics, to 1e-6)."""
    for only_test in (True, False):
        out = tmp_path / f"mesh_{only_test}"
        got = port_cli.main(_mesh_cli_flags(dataset, out, only_test) + extra)
        want = single_process_metrics[only_test]
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (only_test, k, got[k], want[k])
        assert str(got) in capsys.readouterr().out
        assert (out / "out" / "test_ranks.npz").exists()


def test_cli_dp1_tp1_is_the_single_device_run(dataset, tmp_path, single_process_metrics):
    """``--dp 1 --tp 1`` is the run without the flags: no process group, no
    collective, the same test metrics exactly, with --only_test and after a
    fit."""
    for only_test in (True, False):
        got = port_cli.main(_mesh_cli_flags(dataset, tmp_path / f"dp1_{only_test}", only_test)
                            + ["--dp", "1", "--tp", "1"])
        assert got == single_process_metrics[only_test]


def test_cli_cuda_mesh_needs_as_many_gpus(dataset, tmp_path, monkeypatch):
    """Under --device cuda dp * tp must equal the visible GPU count, as in
    the JAX CLI: on one card --dp 2 raises (the card is faked here; the mesh
    is refused before anything touches it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"dp\(2\) \* tp\(1\) != devices\(1\)"):
        port_cli.main(cli_flags(dataset, tmp_path) + ["--device", "cuda", "--dp", "2"])


@pytest.mark.parametrize("name", ["VisualBertKGC", "ViltKGC", "FlavaKGC", "VilBertKGC"])
def test_other_families_name_their_slice(name):
    """Every family beside MKGformer is constructed, the region-feature ones
    (VisualBERT, ViLBERT) as well as the pixel ones, each with its image
    input kind and ``logits``."""
    kind = registry.IMAGE_INPUT[name][0]
    assert kind == ("regions" if name in ("VisualBertKGC", "VilBertKGC") else "pixels")
    with torch.device("meta"):
        assert hasattr(registry.create_model(name, vocab_size=256), "logits")


def test_cli_export_torch_round_trips(dataset, tmp_path):
    """``--export_torch`` after a fit writes the best MKGformer weights as a
    reference-format checkpoint that ``torch.load`` reads and that
    ``import_torch.unimo_params_from_reference`` maps back onto the
    checkpoint the fit kept, exactly (the vocabulary's alignment rows, which
    the export strips, come back as zeros); another family refuses the flag
    before any work."""
    from mkg_analogy_tpu_torch.models.import_torch import unimo_params_from_reference
    from mkg_analogy_tpu_torch.train import checkpoint

    path = tmp_path / "export.pt"
    flags = [f for f in cli_flags(dataset, tmp_path) if f != "--only_test"]
    flags += ["--device", "cpu", "--max_epochs", "1", "--batch_size", "8",
              "--export_torch", str(path)]
    port_cli.main(flags)
    sd = torch.load(path)["state_dict"]
    assert all(v.dtype == torch.float32 for v in sd.values())
    want = checkpoint.load(str(tmp_path / "out" / "ckpt"))  # the fit's best, as the CLI tests
    rows = sd["unimo.text_embeddings.word_embeddings.weight"].shape[0]
    got = unimo_params_from_reference(sd, num_layers=2, vocab_rows=want["mlm_bias"].shape[0],
                                      fusion_start=0)
    assert set(got) == set(want) and rows < want["mlm_bias"].shape[0]
    for key, value in want.items():
        if key in ("word_embeddings", "mlm_bias"):
            assert torch.equal(got[key][:rows], value[:rows]) and not got[key][rows:].any()
        else:
            assert torch.equal(got[key], value), key
    with pytest.raises(ValueError, match="MKGformerKGC"):
        port_cli.main(flags + ["--model_class", "ViltKGC"])


def test_synthetic_image_table():
    """Seeded, bf16, zero pad row last; "synthetic" is constant over each
    size/7-wide block of pixels (size // 32 blocks a side)."""
    dev = torch.device("cpu")
    tab = port_cli.synthetic_image_table("synthetic", 5, 64, dev)
    assert tab.shape == (6, 3, 64, 64) and tab.dtype == torch.bfloat16
    assert not tab[-1].any()
    assert torch.equal(tab, port_cli.synthetic_image_table("synthetic", 5, 64, dev))
    block = tab[0, 0, :32, :32]
    assert (block == block[0, 0]).all() and not torch.equal(tab[0], tab[1])
    noise = port_cli.synthetic_image_table("synthetic_noise", 5, 64, dev)
    assert noise.shape == tab.shape and noise[0, 0].unique().numel() > 100
