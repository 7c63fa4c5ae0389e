"""``cli.rsme --eval_only --ckpt ... --device cpu`` on converted JAX CLI
checkpoints (a ComplEx pre-train and an Analogy fine-tune) gives the JAX
run's ranks exactly and its metrics (fp32 means of equal ranks), as
tests/test_torch_port_kge_cli.py holds ``cli.ikrl``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.cli import rsme as prsme_cli
from tests.test_torch_port_kge import assert_metrics_equal
from tests.test_torch_port_kge_cli import (N_ENT, N_REL, _port_checkpoint, _restore_jax,
                                           dataset)  # noqa: F401  (dataset: a fixture)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rsme_runs(dataset):
    """The JAX RSME CLI: a ComplEx pre-train and an Analogy fine-tune (rank
    dump); each checkpoint converted with the frozen tables the JAX CLI
    builds (a zero ViT table, the forget gate of build_gates)."""
    from mkg_analogy_tpu.cli.rsme import main as jmain
    from mkg_analogy_tpu.data.gates import build_gates
    from mkg_analogy_tpu.data.readers import MarKG
    from mkg_analogy_tpu.kge.rsme import RSMEConfig, RSMEModel

    root, markg_dir, mars_dir = dataset
    common = ["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--rank", "8",
              "--log_dir", str(root / "jlogs")]
    pre = jmain(common + ["--model", "ComplEx", "--max_epochs", "2", "--valid", "2",
                          "--batch_size", "64", "--learning_rate", "0.1",
                          "--output_dir", str(root / "j_rsme")])
    ft = jmain(common + ["--model", "Analogy", "--max_epochs", "2", "--batch_size", "8",
                         "--learning_rate", "0.1", "--finetune",
                         "--output_dir", str(root / "j_rsme_ft"),
                         "--dump_ranks", str(root / "j_rsme_ranks.npz")])
    markg = MarKG(markg_dir)
    triples = np.asarray(markg.triples_as_ids(), np.int64)
    img = np.zeros((N_ENT, 1000), np.float32)
    _, _, pd = build_gates(triples, img, N_REL, 100)
    out = {}
    for name, run, model, src in (("pre", pre, "complex", "j_rsme"),
                                  ("ft", ft, "analogy", "j_rsme_ft")):
        jm = RSMEModel(RSMEConfig(N_ENT, N_REL, rank=8, img_dim=1000, model=model),
                       img_vec=img, rel_pd=np.vstack([pd, pd]))
        cols = 6 if name == "ft" else 4
        v = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, cols), jnp.int32))
        params, step = _restore_jax(root / src / "ckpt", v["params"])
        out[name] = (run, _port_checkpoint(root / f"p_rsme_{name}", params,
                                           v["frozen"], step))
    return common, out


def test_rsme_eval_only_reproduces_the_jax_cli(dataset, rsme_runs):
    root, markg_dir, mars_dir = dataset
    common, runs = rsme_runs
    want, ckpt = runs["pre"]
    got = prsme_cli.main(common + ["--model", "ComplEx", "--eval_only", "--ckpt", ckpt,
                                   "--device", "cpu", "--output_dir", str(root / "p_r")])
    assert_metrics_equal(got, want)
    want, ckpt = runs["ft"]
    dump = root / "p_rsme_ranks.npz"
    got = prsme_cli.main(common + ["--model", "Analogy", "--finetune", "--eval_only",
                                   "--ckpt", ckpt, "--device", "cpu",
                                   "--dump_ranks", str(dump),
                                   "--output_dir", str(root / "p_r_ft")])
    assert_metrics_equal(got, want)
    j, p = np.load(root / "j_rsme_ranks.npz"), np.load(dump)
    np.testing.assert_array_equal(p["ranks"], j["ranks"])
    assert (j["tie"] == 1).all() and (p["tie"] >= 1).all()
    assert 1 < p["ranks"].max() <= N_ENT and 0 < runs["pre"][0]["mrr"] < 1
