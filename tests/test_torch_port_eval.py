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
    assert set(got) == set(want)
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
    assert set(got) == set(want)
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


@pytest.mark.parametrize("extra", [
    ["--export_torch", "model.pt"], ["--tp", "2"], ["--model_class", "ViltKGC"],
    ["--dp", "2"], ["--qk_bf16_grad", "1", "--fused_attention", "0"],
])
def test_cli_refuses_what_later_slices_bring(dataset, tmp_path, extra):
    """Training, --checkpoint, --pretrain and --fused_attention flash are
    ported (tests/test_torch_port_train.py, tests/test_torch_port_pretrain.py);
    these raise, with or without --only_test."""
    for flags in (cli_flags(dataset, tmp_path),
                  [f for f in cli_flags(dataset, tmp_path) if f != "--only_test"]):
        with pytest.raises(NotImplementedError):
            port_cli.main(flags + ["--device", "cpu"] + extra)


@pytest.mark.parametrize("name", ["VisualBertKGC", "ViltKGC", "FlavaKGC", "VilBertKGC"])
def test_other_families_name_their_slice(name):
    assert name in registry.IMAGE_INPUT
    with pytest.raises(NotImplementedError, match="later|training slice"):
        registry.create_model(name, vocab_size=256)


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
