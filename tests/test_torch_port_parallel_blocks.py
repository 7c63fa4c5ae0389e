"""The tensor-parallel blocks across the five families, and the multi-process
dry run, on the CPU (gloo processes, one thread each, file rendezvous under
``tmp_path``):

- ``shard_params_spec`` splits the dims JAX's splits, leaf for leaf, in the
  five families, on tiny configs;
- the four families beside MKGformer (tests/test_torch_port_parallel.py)
  run under tp=2 through the shared blocks: their forward and the ranks of
  their split decoder are the single process's; so does MKGformer with the
  fused Q/K/V projection, its ``qkv`` leaf whole on each rank;
- ``dryrun_multichip`` at 4 and 8 processes, as tests/test_graft_entry.py
  runs JAX's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.core.mesh import make_mesh
from mkg_analogy_tpu_torch.ops.ranking import ranks_from_scores
from mkg_analogy_tpu_torch.parallel.launch import spawn
from mkg_analogy_tpu_torch.parallel.shardings import (
    _params_and_owners, jax_path, shard_module, shard_params_spec)

# JAX is imported inside the tests: the ranks' processes import this module
# to find their function, and need no JAX.

torch.set_num_threads(1)

FAMILIES = ["unimo", "visualbert", "vilt", "flava", "vilbert"]
OTHERS = FAMILIES[1:]


@pytest.mark.parametrize("name", FAMILIES)
def test_shard_params_spec_matches_jax(name):
    """Leaf by leaf, the JAX path of each port parameter exists in the Flax
    tree, and its spec is JAX's in the port's layout (a Dense kernel
    transposed): the same leaves split on the same dims."""
    import jax
    from mkg_analogy_tpu.parallel.shardings import shard_params_spec as jax_spec
    from tests.test_torch_port_converters import _batch, _families

    flax_model, port_cls, port_cfg, img, regions, *_ = _families(False)[name]
    shapes = jax.eval_shape(lambda r: flax_model.init(r, **_batch(img, regions),
                                                      deterministic=True),
                            jax.random.PRNGKey(0))
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jax_spec(shapes), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        want["/".join(str(getattr(p, "key", p)) for p in path)] = tuple(spec)
    with torch.device("meta"):
        model = port_cls(port_cfg)
    got = shard_params_spec(model)
    paths = {n: jax_path(n, module) for n, _, module in _params_and_owners(model)}
    assert set(paths.values()) == set(want)
    n_split = 0
    for n, param, _ in _params_and_owners(model):
        spec = want[paths[n]]
        if spec and param.dim() == 2 and n.endswith(".weight"):
            spec = tuple(reversed(spec + (None,) * (2 - len(spec))))
        assert got[n] == spec, (n, got[n], spec)
        n_split += bool(spec)
    assert n_split > 0


def _family_rank(rank, work):
    """Each family's forward and decoder ranks under tp=2; rank 0 saves
    them."""
    mesh = make_mesh(dp=1, tp=2, devices=["cpu", "cpu"])
    out = {}
    for name in OTHERS:
        inputs = torch.load(os.path.join(work, f"family_{name}.pt"), weights_only=False)
        model = inputs["cls"](inputs["cfg"])
        model.load_state_dict(inputs["state"])
        shard_module(model, mesh)
        out[name] = _forward(model, inputs["batch"])
    # the one projection of fused_qkv, which the rules keep whole
    inputs = torch.load(os.path.join(work, "fused_qkv.pt"), weights_only=False)
    fused = _fused_model()
    fused.load_state_dict(inputs["state"])
    shard_module(fused, mesh)
    names = {n: getattr(p, "tp_shard", None) is not None for n, p in fused.named_parameters()}
    out["fused_qkv"] = (_forward(fused, inputs["batch"]), names)
    if rank == 0:
        torch.save(out, os.path.join(work, "families_out.pt"))


def _fused_model():
    """A tiny MKGformer with the fused Q/K/V projection (JAX's
    USE_FUSED_QKV), fp32, 2 heads of 16."""
    from mkg_analogy_tpu_torch.models.unimo import (
        TextConfig, UnimoConfig, UnimoForMaskedLM, VisionConfig)

    small = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    return UnimoForMaskedLM(UnimoConfig(text=TextConfig(vocab_size=64, **small),
                                        vision=VisionConfig(**small, image_size=32, patch_size=16),
                                        fusion_start=1,
                                        dtype="float32", fused_qkv=True))


def _forward(model, batch):
    with torch.no_grad():
        trans = model(**batch)
        logits = model.logits(trans[:, 0], vocab_start=0, vocab_end=64)
    return trans, ranks_from_scores(logits, torch.zeros(trans.shape[0], dtype=torch.long))


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """(single-process, tp=2) forward outputs of the four families, at the
    converter tests' tiny configs in fp32, random weights; the ranks of the
    mesh in one spawn."""
    from tests.test_torch_port_converters import _families

    work = tmp_path_factory.mktemp("port_parallel_blocks")
    want = {}
    for name in OTHERS:
        _, port_cls, port_cfg, img, regions, *_ = _families(False)[name]
        port_cfg = dataclasses.replace(port_cfg, dtype="float32")
        model = port_cls(port_cfg)
        model.init_params(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(1)
        b, length = img[0], 16
        batch = dict(
            input_ids=torch.from_numpy(rng.integers(0, 128, (b, length))),
            attention_mask=torch.ones(b, length, dtype=torch.long),
            token_type_ids=torch.zeros(b, length, dtype=torch.long),
            pixel_values=torch.from_numpy(rng.standard_normal(img).astype(np.float32)),
            positions=torch.from_numpy(rng.integers(0, length, (b, 5))),
            boundary=torch.full((b,), 6))
        if regions:
            batch["visual_attention_mask"] = torch.ones(img[:2])
        want[name] = _forward(model, batch)
        torch.save({"cls": port_cls, "cfg": port_cfg, "state": model.state_dict(),
                    "batch": batch}, work / f"family_{name}.pt")
    fused = _fused_model()
    fused.init_params(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    b, length = 2, 16
    batch = dict(
        input_ids=torch.from_numpy(rng.integers(0, 64, (b, length))),
        attention_mask=torch.ones(b, length, dtype=torch.long),
        token_type_ids=torch.zeros(b, length, dtype=torch.long),
        pixel_values=torch.from_numpy(rng.standard_normal((b, 2, 3, 32, 32)).astype(np.float32)),
        positions=torch.from_numpy(rng.integers(0, length, (b, 5))),
        boundary=torch.full((b,), 6))
    want["fused_qkv"] = _forward(fused, batch)
    torch.save({"state": fused.state_dict(), "batch": batch}, work / "fused_qkv.pt")
    spawn(_family_rank, ["cpu", "cpu"], str(work), args=(str(work),), threads=1)
    return want, torch.load(work / "families_out.pt", weights_only=False)


@pytest.mark.parametrize("name", OTHERS)
def test_other_families_run_under_tp(families, name):
    """The shared blocks (column- and row-parallel Dense, the rank's heads,
    the vocab-parallel table) carry the family under tp=2: its MLM states
    within the model bar (2e-4, fp32: the row-parallel sums run in another
    order) and the ranks of the split decoder's logits equal."""
    want, got = families
    torch.testing.assert_close(got[name][0], want[name][0], atol=2e-4, rtol=0)
    assert torch.equal(got[name][1], want[name][1])


def test_fused_qkv_runs_under_tp(families):
    """A model with the fused Q/K/V projection (JAX's USE_FUSED_QKV) under
    tp=2: its one ``qkv`` leaf stays whole on each rank, as JAX keeps it,
    beside the split out projection, and its forward and ranks are the
    single process's at the bar of the other families."""
    want, got = families
    (trans, ranks), split = got["fused_qkv"]
    qkv = [n for n in split if ".attn.qkv." in n]
    out = [n for n in split if ".attn.out.weight" in n]
    assert qkv and out and not any(split[n] for n in qkv) and all(split[n] for n in out)
    torch.testing.assert_close(trans, want["fused_qkv"][0], atol=2e-4, rtol=0)
    assert torch.equal(ranks, want["fused_qkv"][1])


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n, capsys):
    """As tests/test_graft_entry.py runs JAX's: a train step, the eval loop
    and a checkpoint round trip on n gloo processes (dp x 2 where n >= 4)."""
    from mkg_analogy_tpu_torch.parallel.dryrun import dryrun_multichip

    result = dryrun_multichip(n, device="cpu")
    assert (result["dp"], result["tp"]) == (n // 2, 2)
    assert np.isfinite(result["loss"]) and 0.0 < result["eval_mrr"] <= 1.0
    assert f"dryrun_multichip OK: {n} devices (dp={n // 2}, tp=2)" in capsys.readouterr().out


def test_dryrun_multichip_runs_on_the_card_unless_asked(monkeypatch):
    """The dry run's default device is the card: with no GPU visible it
    raises before it starts a process, and names the CPU's switch."""
    from mkg_analogy_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "spawn", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(4)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        dryrun.dryrun_multichip(4, device="tpu")
