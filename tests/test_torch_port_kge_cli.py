"""The port's KGE CLIs against the JAX CLIs on tests/util.make_tiny_dataset:
the JAX CLI fits and writes an orbax checkpoint; the test restores it with
the JAX Checkpointer, converts it (params and the frozen tables the JAX CLI
built) and saves it in the port's format; the port's ``--eval_only --ckpt
... --device cpu`` must then give the JAX run's ranks exactly and its
metrics (fp32 means of equal ranks). Here ``cli.ikrl``, real tie counts in
the rank dumps, the native sampler's fit and the refusals; ``cli.rsme``'s
parity is in tests/test_torch_port_rsme_cli.py, the fits from scratch in
tests/test_torch_port_kge_fit.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.cli import ikrl as pikrl_cli
from mkg_analogy_tpu_torch.cli import rsme as prsme_cli
from mkg_analogy_tpu_torch.models.convert import params_from_jax
from mkg_analogy_tpu_torch.train import checkpoint
from tests.test_torch_port_kge import assert_metrics_equal
from tests.util import make_tiny_dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ENT, N_REL = 48, 6


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("kge_cli")
    # 400 triples: RSME's 1% test split holds 4 (8 ranks on both sides)
    markg_dir, mars_dir = make_tiny_dataset(str(root), n_ent=N_ENT, n_rel=N_REL,
                                            n_triples=400, n_analogy=48)
    return root, markg_dir, mars_dir


def _port_checkpoint(path, params, frozen, step):
    """A JAX checkpoint's params plus the JAX run's frozen tables, saved in
    the port's format."""
    ckpt = checkpoint.Checkpointer(str(path))
    ckpt.save(step, params_from_jax({"params": jax.device_get(params),
                                     "frozen": jax.device_get(frozen)}))
    ckpt.close()
    return str(path)


def _restore_jax(ckpt_dir, like):
    from mkg_analogy_tpu.train.checkpoint import Checkpointer

    c = Checkpointer(str(ckpt_dir))
    return c.restore(like=like), c.latest_step()


def _ikrl_variables(dim, scorer):
    """What the JAX CLI's init_state builds (same seed, no visual store)."""
    from mkg_analogy_tpu.kge.ikrl import IKRLConfig, create_ikrl

    model = create_ikrl(IKRLConfig(N_ENT, N_REL, dim=dim, scorer=scorer))
    z = jnp.zeros((4,), jnp.int32)
    return model.init(jax.random.PRNGKey(0), z, z, z, z)


@pytest.fixture(scope="module")
def ikrl_runs(dataset):
    """The JAX IKRL CLI: a TransE pre-train (the reference recipe: margin
    loss, SGD at lr 1), then a fine-tune from it (rank dump); each run's
    metrics and checkpoint converted for the port. (The ANALOGY recipe's lr
    1 diverges to NaN energies at this size, and NaN energies rank 1
    everywhere: no test of anything.)"""
    from mkg_analogy_tpu.cli.ikrl import main as jmain

    root, markg_dir, mars_dir = dataset
    common = ["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--model",
              "transe", "--dim", "16", "--nbatches", "4", "--neg_ent", "5",
              "--neg_rel", "5", "--log_dir",
              str(root / "jlogs")]
    pre = jmain(common + ["--train_times", "3", "--output_dir", str(root / "j_ikrl")])
    ft = jmain(common + ["--finetune", "--finetune_epochs", "2", "--finetune_bsz", "8",
                         "--ckpt", str(root / "j_ikrl" / "ckpt"),
                         "--output_dir", str(root / "j_ikrl_ft"),
                         "--dump_ranks", str(root / "j_ikrl_ranks.npz")])
    assert 0 < pre["mrr"] < 1 and 0 < ft["mrr"] < 1, (pre, ft)
    v = _ikrl_variables(16, "transe")
    out = {}
    for name, run in (("pre", pre), ("ft", ft)):
        src = root / ("j_ikrl" if name == "pre" else "j_ikrl_ft") / "ckpt"
        params, step = _restore_jax(src, v["params"])
        out[name] = (run, _port_checkpoint(root / f"p_ikrl_{name}", params,
                                           v["frozen"], step))
    return common, out


def test_ikrl_eval_only_reproduces_the_jax_cli(dataset, ikrl_runs):
    root, markg_dir, mars_dir = dataset
    common, runs = ikrl_runs
    want, ckpt = runs["pre"]
    got = pikrl_cli.main(common + ["--eval_only", "--ckpt", ckpt, "--device", "cpu",
                                   "--output_dir", str(root / "p_eval")])
    assert_metrics_equal(got, want)
    want, ckpt = runs["ft"]
    dump = root / "p_ikrl_ranks.npz"
    got = pikrl_cli.main(common + ["--finetune", "--eval_only", "--ckpt", ckpt,
                                   "--device", "cpu", "--dump_ranks", str(dump),
                                   "--output_dir", str(root / "p_eval_ft")])
    assert_metrics_equal(got, want)
    j, p = np.load(root / "j_ikrl_ranks.npz"), np.load(dump)
    np.testing.assert_array_equal(p["ranks"], j["ranks"])
    np.testing.assert_array_equal(p["mode"], j["mode"])
    assert (j["tie"] == 1).all() and (p["tie"] >= 1).all()
    assert 1 < p["ranks"].max() <= N_ENT


def test_rank_dumps_hold_real_tie_counts(dataset, tmp_path):
    """With every weight 0, all entities tie: the JAX CLIs write tie 1, the
    port writes the tie group's size (all entities), and the rank of each
    answer is its stable-sort position (``ranks_from_scores``)."""
    root, markg_dir, mars_dir = dataset
    from mkg_analogy_tpu_torch.kge.rsme import RSMEConfig, RSMEModel

    model = RSMEModel(RSMEConfig(N_ENT, N_REL, rank=8, model="analogy"))
    zeros = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    ckpt = checkpoint.Checkpointer(str(tmp_path / "zero"))
    ckpt.save(1, zeros)
    ckpt.close()
    dump = tmp_path / "ranks.npz"
    prsme_cli.main(["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--rank", "8",
                    "--model", "Analogy", "--finetune", "--eval_only", "--ckpt",
                    str(tmp_path / "zero"), "--device", "cpu", "--dump_ranks", str(dump),
                    "--output_dir", str(tmp_path / "o"), "--log_dir", str(tmp_path / "l")])
    d = np.load(dump)
    assert (d["tie"] == N_ENT).all()
    from mkg_analogy_tpu_torch.data.readers import MARS, MarKG
    from mkg_analogy_tpu_torch.kge.trainer import mars_finetune_tuples

    markg = MarKG(markg_dir)
    answers = mars_finetune_tuples(MARS(mars_dir, markg), markg)["test"][:, 3]
    np.testing.assert_array_equal(d["ranks"], answers + 1)


def test_native_sampler_fit_and_the_refusals(dataset, tmp_path):
    """--use_native_sampler builds the port's sampler and fits; the CLIs
    refuse --device cuda without a GPU, --holdout_frac with the native
    sampler (it would train on the held-out triples) and CP fine-tuning."""
    from mkg_analogy_tpu_torch.data.openke_tools import write_id_files
    from mkg_analogy_tpu_torch.data.readers import MarKG

    root, markg_dir, mars_dir = dataset
    in_path = str(tmp_path / "openke")
    write_id_files(in_path, MarKG(markg_dir))
    base = ["--data_dir", mars_dir, "--pretrain_path", markg_dir,
            "--log_dir", str(tmp_path / "logs"), "--output_dir", str(tmp_path / "o")]
    m = pikrl_cli.main(base + ["--dim", "16", "--nbatches", "4", "--train_times", "2",
                               "--use_native_sampler", "--in_path", in_path,
                               "--device", "cpu"])
    assert 0 < m["mrr"] <= 1
    with pytest.raises(ValueError, match="holdout_frac"):
        pikrl_cli.main(base + ["--use_native_sampler", "--in_path", in_path,
                               "--holdout_frac", "0.1", "--device", "cpu"])
    with pytest.raises(ValueError, match="CPModel"):
        prsme_cli.main(base + ["--model", "CP", "--finetune", "--device", "cpu"])
    if not torch.cuda.is_available():
        for cli in (pikrl_cli, prsme_cli):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(base)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(base + ["--device", "cuda"])
