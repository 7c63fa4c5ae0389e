"""The small pieces of the single-device path against the JAX package, on
the CPU: the ranking of rows whose gold score is not finite (a deliberate
deviation), the CLI's rank dumps, ``core/cache.py``, ``_qk_scores_bf16grad``,
the fused Q/K/V projection and its conversion, ``Checkpointer.latest_step``,
``KGCDataModule.get_config``, ``Policy.cast_to_compute`` and
``fused_adamw``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.kge import eval as jeval
from mkg_analogy_tpu.kge import sampling as jsampling
from mkg_analogy_tpu.ops import ranking as jranking
from mkg_analogy_tpu_torch.cli import main as port_cli
from mkg_analogy_tpu_torch.kge import eval as peval
from mkg_analogy_tpu_torch.kge import sampling as psampling
from mkg_analogy_tpu_torch.ops import ranking
from tests.util import make_tiny_dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_tiny_dataset(str(tmp_path_factory.mktemp("port_leftovers_kg")))


def cli_flags(dataset, tmp_path, tag, extra=()):
    markg_dir, mars_dir = dataset
    return ["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--device", "cpu",
            "--max_epochs", "1", "--batch_size", "8", "--eval_batch_size", "8",
            "--max_seq_length", "48", "--text_vocab_size", "256", "--hidden_size", "32",
            "--num_layers", "2", "--num_heads", "2", "--intermediate_size", "64",
            "--dtype", "float32", "--lr", "1e-3",
            "--output_dir", str(tmp_path / f"out_{tag}"),
            "--log_dir", str(tmp_path / f"logs_{tag}"),
            "--cache_dir", str(tmp_path / "cache"), *extra]


# ------------------------------------------------------------------ ranking
def _scores_with_bad_gold(value, seed=0):
    """(16, 40) random fp32 scores, some rounded into ties; rows 3, 7 and 11
    get ``value`` at their gold column."""
    rng = np.random.default_rng(seed)
    scores = np.round(rng.standard_normal((16, 40)), 1).astype(np.float32)
    labels = rng.integers(0, 40, 16).astype(np.int32)
    bad = np.zeros(16, bool)
    bad[[3, 7, 11]] = True
    scores[bad, labels[bad]] = value
    return scores, labels, bad


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_nonfinite_gold_ranks_last_where_jax_does_not(value):
    """A non-finite gold score ranks last (40 of 40) in a tie group of one
    in the port; JAX ranks a NaN or +inf gold 1, the deliberate deviation.
    Every other row gets JAX's rank and tie count exactly."""
    scores, labels, bad = _scores_with_bad_gold(value)
    s, lab = torch.from_numpy(scores), torch.from_numpy(labels)
    ranks = ranking.ranks_from_scores(s, lab).numpy()
    ties = ranking.tie_counts(s, lab).numpy()
    want_ranks = np.asarray(jranking.ranks_from_scores(jnp.asarray(scores), jnp.asarray(labels)))
    want_ties = np.asarray(jranking.tie_counts(jnp.asarray(scores), jnp.asarray(labels)))
    np.testing.assert_array_equal(ranks[~bad], want_ranks[~bad])
    np.testing.assert_array_equal(ties[~bad], want_ties[~bad])
    assert (ranks[bad] == 40).all() and (ties[bad] == 1).all()
    np.testing.assert_array_equal(ranking.nonfinite_gold(s, lab).numpy(), bad)
    if not value < 0:  # NaN and +inf: JAX's count ranks them first
        assert (want_ranks[bad] == 1).all()
    # in bf16 too (the card's eval logits are fp32, but the helper takes any float)
    assert (ranking.ranks_from_scores(s.bfloat16(), lab).numpy()[bad] == 40).all()


def test_link_prediction_ranks_a_nonfinite_gold_energy_last():
    """Energies (lower is better) with NaN at some gold entries, both sides:
    the port's raw and filtered ranks of those rows are the candidate count
    (64) and ``nonfinite_gold`` counts them; JAX ranks them 1, so its Hits@1
    is higher by exactly their share. The finite rows keep JAX's numpy
    formula, 1 + #{strictly lower}."""
    n_ent, n_rel = 64, 6
    rng = np.random.default_rng(2)
    rows = np.stack([rng.integers(0, n_ent, 150), rng.integers(0, n_rel, 150),
                     rng.integers(0, n_ent, 150)], axis=1)  # (h, r, t)
    table = np.round(rng.standard_normal((n_ent, n_rel, n_ent)), 1).astype(np.float32)
    test_rows = rows[:40]
    for h, r, t in test_rows[::5]:  # every fifth test triple diverged on both sides
        table[h, r, t] = np.nan

    def energies(anchor, r, tm, corrupt):
        anchor, r = np.asarray(anchor), np.asarray(r)
        return table[anchor, r] if corrupt == "tail" else table[:, r, anchor].T

    want = jeval.link_prediction(
        energies, jsampling.TripleStore.from_arrays(test_rows, n_ent, n_rel),
        jeval.build_filters(jsampling.TripleStore.from_arrays(rows, n_ent, n_rel)), n_ent,
        batch_size=16)
    test = psampling.TripleStore.from_arrays(test_rows, n_ent, n_rel)
    got, ranks = peval.link_prediction(
        lambda *a: torch.from_numpy(energies(*a)), test,
        peval.build_filters(psampling.TripleStore.from_arrays(rows, n_ent, n_rel)), n_ent,
        batch_size=16, return_ranks=True)
    # the finite rows: JAX's formula on the same energies; order (batch,
    # tail then head side, row), each side's gold energy table[h, r, t]
    bad, want_raw = [], []
    for b in range(0, len(test_rows), 16):
        h, t, r = (x[b:b + 16] for x in (test.heads, test.tails, test.rels))
        for gold, e in ((t, table[h, r]), (h, table[:, r, t].T)):
            bad.append(np.isnan(table[h, r, t]))
            want_raw.append(1 + (e < e[np.arange(len(gold)), gold][:, None]).sum(axis=1))
    bad, want_raw = np.concatenate(bad), np.concatenate(want_raw)
    n_bad, n_rows = int(bad.sum()), len(bad)
    assert n_bad >= 16 and got["nonfinite_gold"] == float(n_bad)
    np.testing.assert_array_equal(ranks["raw"][~bad], want_raw[~bad])
    for kind in ("raw", "filter"):
        assert (ranks[kind][bad] == n_ent).all() and (ranks[kind][~bad] < n_ent).all()
        np.testing.assert_allclose(want[f"{kind}/hits1"] * n_rows,
                                   got[f"{kind}/hits1"] * n_rows + n_bad, atol=1e-4)


def test_diverged_model_reports_hits1_zero_and_counts_its_rows(dataset, tmp_path):
    """A fine-tune evaluation whose weights are all NaN (a fit that
    diverged): every logit is NaN, so every example ranks last, Hits@1 is
    0, and ``Eval_entity/nonfinite_gold`` is the example count.
    The JAX package would report Hits@1 = 1 here."""
    from mkg_analogy_tpu_torch.data.module import KGCDataModule
    from mkg_analogy_tpu_torch.models.registry import create_model
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    markg_dir, mars_dir = dataset
    data = KGCDataModule(data_dir=mars_dir, pretrain_path=markg_dir, max_seq_length=48,
                         text_vocab_size=256, image_size=16)
    model = create_model("MKGformerKGC", vocab_size=data.vocab.padded_vocab_size,
                         dtype="float32", attention="plain", hidden_size=32, num_layers=2,
                         num_heads=2, intermediate_size=64)
    trainer = MarTTrainer(model, data.vocab, TrainConfig(eval_batch_size=4), device="cpu")
    trainer.init_params(0)
    trainer.set_image_table(np.zeros((data.markg.num_entities + 1, 3, 224, 224), np.float32))
    feats = data.features("test")
    healthy = trainer.evaluate(feats)
    assert healthy["Eval_entity/nonfinite_gold"] == 0.0
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    dump = tmp_path / "ranks.npz"
    metrics = trainer.evaluate(feats, dump_path=str(dump))
    n = len(feats["label"])
    n_entities = len(data.vocab.analogy_entity_ids)
    assert metrics["Eval_entity/nonfinite_gold"] == float(n)
    assert metrics["Eval_entity/hits1"] == 0.0
    assert metrics["Eval_entity/mean_rank"] == float(n_entities)  # last of the 8
    assert abs(metrics["Eval_entity/mrr"] - 1.0 / n_entities) <= 1e-7
    d = np.load(dump)
    assert (d["ranks"] == n_entities).all() and (d["tie"] == 1).all()


def test_pretrain_cli_dumps_its_ranks_under_their_own_name(dataset, tmp_path):
    """Under ``--pretrain`` the evaluation's ranks mix entity and relation
    rows: they go to ``test_ranks_pretrain.npz`` (ranks, is_rel), and no
    ``test_ranks.npz`` is written, so that name always holds a MARS split.
    The triple format reports its relation rows' non-finite count too."""
    metrics = port_cli.main(cli_flags(dataset, tmp_path, "pre", ["--pretrain", "1"]))
    out = tmp_path / "out_pre"
    assert not (out / "test_ranks.npz").exists()
    d = np.load(out / "test_ranks_pretrain.npz")
    assert {"ranks", "is_rel"} <= set(d.files) and d["is_rel"].any()
    assert metrics["Eval_entity/nonfinite_gold"] == 0.0
    assert metrics["Eval_relation/nonfinite_gold"] == 0.0


def test_finetune_cli_dump_reads_in_analyze_ranks(dataset, tmp_path):
    """The fine-tune CLI's ``test_ranks.npz`` holds one rank, tie count and
    mode per MARS test example, which ``tools/analyze_ranks.py`` reads."""
    _, mars_dir = dataset
    port_cli.main(cli_flags(dataset, tmp_path, "ft"))
    dump = tmp_path / "out_ft" / "test_ranks.npz"
    assert {"ranks", "tie", "mode", "is_rel"} <= set(np.load(dump).files)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "analyze_ranks.py"),
                          str(dump), "--mars_dir", mars_dir],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "n=6" in out.stdout and "per mode:" in out.stdout


# ------------------------------------------------------------- core/cache
def test_enable_compilation_cache_builds_only_on_cuda(monkeypatch):
    """The kernels are built for a CUDA device only (all of them, none
    with ``kernels=False``), the native sampler only when asked; nothing
    reaches nvcc or g++ for the CPU."""
    from mkg_analogy_tpu_torch.core import cache
    from mkg_analogy_tpu_torch.kernels import build
    from mkg_analogy_tpu_torch.native import build as native_build

    calls = []
    monkeypatch.setattr(build, "build", lambda names=(): calls.append(("nvcc", tuple(names))))
    monkeypatch.setattr(native_build, "build", lambda: calls.append(("g++",)))
    cache.enable_compilation_cache("cpu")
    cache.enable_compilation_cache(torch.device("cpu"), native_sampler=False)
    assert calls == []
    cache.enable_compilation_cache("cuda")
    cache.enable_compilation_cache("cuda", kernels=False)
    cache.enable_compilation_cache("cpu", kernels=False, native_sampler=True)
    assert calls == [("nvcc", ()), ("g++",)]


def test_cli_with_device_cpu_builds_no_kernel(dataset, tmp_path, monkeypatch):
    """``cli.main --device cpu`` fits and tests without building a kernel."""
    from mkg_analogy_tpu_torch.kernels import build

    def refuse(names=()):
        raise AssertionError("a --device cpu run asked for an nvcc build")

    monkeypatch.setattr(build, "build", refuse)
    metrics = port_cli.main(cli_flags(dataset, tmp_path, "cpu_build"))
    assert all(np.isfinite(v) for v in metrics.values())


# --------------------------------------------------------- QK_BF16_GRAD
def _qk_inputs(seed=0, b=2, lq=12, lk=20, heads=4, d=8):
    """bf16 q (B, Lq, heads, d), k (B, Lk, heads, d) and an fp32 score
    cotangent (B, heads, Lq, Lk), from numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, heads, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, heads, d)).astype(np.float32)
    g = rng.standard_normal((b, heads, lq, lk)).astype(np.float32)
    to_bf16 = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    return to_bf16(q), to_bf16(k), torch.from_numpy(g)


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(t.dtype == torch.bfloat16 and jnp.bfloat16
                                                 or jnp.float32)


def test_qk_scores_bf16grad_matches_jax():
    """``_qk_scores_bf16grad`` on the port's (B, heads, L, d) heads against
    JAX's on its (B, L, heads, d) layout, the same bf16 q and k and fp32
    cotangent. The forward: fp32 sums of exact bf16 products, equal to the
    port's plain product bit for bit and to JAX's within 1e-6 of their
    scale (the two libraries add the 8 products in other orders). dq and dk
    are bf16 products of the bf16-rounded cotangent: within one bf16 ulp of
    each result's largest value (2^-7 of it), the rounding of two sums of
    exact products taken in other orders. Against the default backward
    (autograd through the fp32 products) they differ, by the cotangent's
    rounding."""
    from mkg_analogy_tpu.models.common import _qk_scores_bf16grad as jax_qk
    from mkg_analogy_tpu_torch.kernels.attention import _qk_products
    from mkg_analogy_tpu_torch.models.common import _qk_scores_bf16grad

    q, k, g = _qk_inputs()
    qh = q.transpose(1, 2).clone().requires_grad_(True)
    kh = k.transpose(1, 2).clone().requires_grad_(True)
    out = _qk_scores_bf16grad(qh, kh)
    assert out.dtype == torch.float32
    assert torch.equal(out, _qk_products(qh.detach(), kh.detach()))
    want, vjp = jax.vjp(jax_qk, _to_jax(q), _to_jax(k))
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    out.backward(g)
    jdq, jdk = (np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g.numpy())))
    for name, got, ref in (("dq", qh.grad, jdq), ("dk", kh.grad, jdk)):
        assert got.dtype == torch.bfloat16, name
        got = got.float().transpose(1, 2).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 ** -7 * np.abs(ref).max(),
                                   err_msg=name)
    # the default backward keeps the cotangent in fp32: another result
    qd, kd = (x.detach().clone().requires_grad_(True) for x in (qh, kh))
    _qk_products(qd, kd).backward(g)
    assert not torch.equal(qd.grad, qh.grad)


def _attention_core_pair(dtype, flag, seed=0, fused_qkv=False):
    """(JAX loss, JAX grads as a port state dict, port loss, port grads) of
    sum(out^2) through one AttentionCore (4 heads of 8, B=2, L=16) on the
    same converted weights and input, JAX's switches (``QK_BF16_GRAD``,
    ``USE_FUSED_QKV``) set for the call and restored after it."""
    from mkg_analogy_tpu.models import common as jcommon
    from mkg_analogy_tpu_torch.models import common
    from mkg_analogy_tpu_torch.models.convert import params_from_jax

    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = np.random.default_rng(seed).standard_normal((2, 16, 32)).astype(np.float32)
    saved = jcommon.QK_BF16_GRAD, jcommon.USE_FUSED_QKV
    jcommon.set_qk_bf16_grad(flag)
    jcommon.USE_FUSED_QKV = fused_qkv
    try:
        mod = jcommon.AttentionCore(num_heads=4, head_dim=8, dtype=jdtype, dropout_rate=0.0)
        jx = jnp.asarray(x).astype(jdtype)
        params = mod.init(jax.random.PRNGKey(1), jx)

        def loss(p):
            out, _ = mod.apply(p, jx, deterministic=True)
            return jnp.sum(out.astype(jnp.float32) ** 2)

        jval, jgrads = jax.value_and_grad(loss)(params)
    finally:
        jcommon.QK_BF16_GRAD, jcommon.USE_FUSED_QKV = saved
    core = common.AttentionCore(32, 4, 8, dtype=dtype, backend="plain",
                                qk_bf16_grad=flag, fused_qkv=fused_qkv)
    core.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    out, _ = core(torch.from_numpy(x).to(dtype))
    val = torch.sum(out.float() ** 2)
    val.backward()
    return (float(jval), params_from_jax(jax.device_get(jgrads)), val.item(),
            {n: p.grad for n, p in core.named_parameters()})


def _leaves_close(got, want, rel=1e-5):
    """Each gradient leaf within ``rel`` of its largest |value| plus 1e-7
    of the largest of all (fp32 summed in other orders; the floor covers
    the key bias, whose exact gradient is 0 and which carries round-off
    only)."""
    top = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        err = float((got[n].float() - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-7 * top, (n, err)


def _rel_l2(got, want):
    num = sum(float(((got[n].float() - want[n]) ** 2).sum()) for n in want)
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def test_attention_core_qk_bf16_grad_matches_jax():
    """The switch on an AttentionCore against JAX's under
    ``set_qk_bf16_grad(True)`` (restored after). fp32 ignores it on both
    sides: the gradients with it equal those without, bit for bit, and JAX's
    at the bar of ``_leaves_close``. bf16: the loss with it equals the
    loss without, bit for bit (the forward is untouched), and the gradients
    stay as close to JAX's as without it: their relative L2 distance is
    within 2e-2 (bf16 activations, summed in other orders) and within 1.5x
    of the distance without the switch."""
    _, _, v32, g32 = _attention_core_pair(torch.float32, False)
    jv, jg, v32_on, g32_on = _attention_core_pair(torch.float32, True)
    assert v32 == v32_on and all(torch.equal(g32[n], g32_on[n]) for n in g32)
    assert abs(v32_on - jv) <= 1e-5 * abs(jv)
    _leaves_close(g32_on, jg)
    jv0, jg0, v0, g0 = _attention_core_pair(torch.bfloat16, False)
    jv1, jg1, v1, g1 = _attention_core_pair(torch.bfloat16, True)
    assert v0 == v1 and jv0 == jv1
    off, on = _rel_l2(g0, jg0), _rel_l2(g1, jg1)
    assert on <= 2e-2 and on <= 1.5 * off + 1e-6, (on, off)
    assert any(not torch.equal(g0[n], g1[n]) for n in g0)  # the backward did change


def test_cli_fits_with_qk_bf16_grad_on_the_plain_route(dataset, tmp_path, monkeypatch):
    """``--qk_bf16_grad 1 --fused_attention 0`` in bf16 fits and tests, and
    every attention call of the fit's steps takes ``_qk_scores_bf16grad``."""
    from mkg_analogy_tpu_torch.models import common

    calls = []
    real = common._qk_scores_bf16grad

    def spy(q, k):
        calls.append(torch.is_grad_enabled())
        return real(q, k)

    monkeypatch.setattr(common, "_qk_scores_bf16grad", spy)
    flags = cli_flags(dataset, tmp_path, "qk", ["--qk_bf16_grad", "1",
                                                 "--fused_attention", "0"])
    flags[flags.index("float32")] = "bfloat16"
    metrics = port_cli.main(flags)
    assert all(np.isfinite(v) for v in metrics.values())
    # 3 steps x (2 text + 2 vision + ... ) calls with a graph, the evaluations without
    assert sum(calls) and not all(calls)


# ---------------------------------------------------------- fused Q/K/V
def test_attention_core_fused_qkv_matches_jax():
    """A fused-QKV AttentionCore against JAX's under ``USE_FUSED_QKV``
    (restored after) on the same converted ``qkv`` weights, fp32: the loss
    within 1e-5 relative, the gradient leaves at the bar of
    ``_leaves_close``."""
    jv, jg, v, g = _attention_core_pair(torch.float32, False, fused_qkv=True)
    assert set(g) == set(jg) and "qkv.weight" in g
    assert abs(v - jv) <= 1e-5 * abs(jv)
    _leaves_close(g, jg)


def test_fused_model_matches_the_unfused_one():
    """The tiny MKGformer fused and unfused, both from one Flax tree: the
    fused weights from ``fuse_qkv`` of the Flax tree and of the unfused
    port state dict agree exactly; JAX's fused model on ``fuse_qkv`` of its
    own tree gives its unfused output (so the concatenation order is the
    one ``jnp.split`` reads); and the port's fused forward gives the
    unfused one within 2e-4 (fp32, the projections summed in other
    orders)."""
    from mkg_analogy_tpu.models import common as jcommon
    from mkg_analogy_tpu.models.unimo import UnimoForMaskedLM as FlaxUnimo
    from mkg_analogy_tpu_torch.models.convert import fuse_qkv, params_from_jax
    from mkg_analogy_tpu_torch.models.unimo import UnimoForMaskedLM
    from tests.test_torch_port_unimo import port_config
    from tests.util import tiny_unimo_config

    import dataclasses

    cfg = tiny_unimo_config(vocab_size=256)
    rng = np.random.default_rng(0)
    batch = dict(
        input_ids=rng.integers(0, 256, (3, 16)).astype(np.int32),
        attention_mask=np.ones((3, 16), np.int32),
        token_type_ids=np.zeros((3, 16), np.int32),
        pixel_values=rng.standard_normal((3, 2, 3, 16, 16)).astype(np.float32),
        positions=rng.integers(0, 9, (3, 5)).astype(np.int32),
        boundary=np.array([4, 6, 8], np.int32),
    )
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    flax_model = FlaxUnimo(cfg)
    tree = jax.device_get(flax_model.init(jax.random.PRNGKey(0), **jbatch,
                                          deterministic=True))
    saved = jcommon.USE_FUSED_QKV
    jcommon.USE_FUSED_QKV = True
    try:
        jfused = np.asarray(flax_model.apply(fuse_qkv(tree), **jbatch, deterministic=True))
    finally:
        jcommon.USE_FUSED_QKV = saved
    junfused = np.asarray(flax_model.apply(tree, **jbatch, deterministic=True))
    np.testing.assert_allclose(jfused, junfused, rtol=0, atol=2e-4)

    unfused = UnimoForMaskedLM(port_config(cfg))
    unfused.load_state_dict(params_from_jax(tree), strict=True)
    fused = UnimoForMaskedLM(dataclasses.replace(port_config(cfg), fused_qkv=True))
    from_tree = params_from_jax(fuse_qkv(tree))
    from_sd = fuse_qkv(unfused.state_dict())
    assert set(from_tree) == set(from_sd) == set(fused.state_dict())
    assert all(torch.equal(from_tree[k], from_sd[k]) for k in from_sd)
    fused.load_state_dict(from_sd, strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = unfused(**tb).detach().numpy()
    got = fused(**tb).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got, jfused, rtol=0, atol=2e-4)


# ----------------------------------------------------------- small names
def test_latest_step_flushes_a_pending_save(tmp_path, monkeypatch):
    """``latest_step`` waits for the save in flight (JAX flushes first,
    train/checkpoint.py:127): with the write slowed down, a save followed at
    once by ``latest_step`` reports that save's step; an empty directory
    reports None."""
    import time

    from mkg_analogy_tpu_torch.train.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "ckpt"))
    try:
        assert ck.latest_step() is None
        real = ck._write

        def slow(*args):
            time.sleep(0.3)
            real(*args)

        monkeypatch.setattr(ck, "_write", slow)
        state = {"w": torch.arange(4.0)}
        ck.save(3, state)
        assert ck._pending.unfinished_tasks == 1  # still in flight
        assert ck.latest_step() == 3
        ck.save(7, state)
        assert ck.latest_step() == 7
    finally:
        ck.close()


def test_get_config_matches_jax(dataset):
    from mkg_analogy_tpu.data.module import KGCDataModule as JaxDataModule
    from mkg_analogy_tpu_torch.data.module import KGCDataModule

    markg_dir, mars_dir = dataset
    kw = dict(data_dir=mars_dir, pretrain_path=markg_dir, max_seq_length=48,
              text_vocab_size=256, image_size=16)
    want, got = JaxDataModule(**kw).get_config(), KGCDataModule(**kw).get_config()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)


def test_cast_to_compute_matches_jax():
    """A nest of dicts, lists and tuples: the floating leaves cast to bf16
    (the same round-to-nearest-even as JAX's), integer and bool leaves and
    non-tensors as they were, the containers' types kept."""
    from mkg_analogy_tpu.core.precision import Policy as JaxPolicy
    from mkg_analogy_tpu_torch.core.precision import Policy

    rng = np.random.default_rng(0)
    leaves = dict(w=rng.standard_normal((3, 5)).astype(np.float32),
                  b=rng.standard_normal(7).astype(np.float64),
                  ids=rng.integers(0, 9, 4).astype(np.int32), flag=np.array([True, False]))

    def nest(leaf):
        return {"a": [leaf("w"), (leaf("ids"), leaf("b"))], "b": {"c": leaf("flag")},
                "n": 3}

    got = Policy().cast_to_compute(nest(lambda k: torch.from_numpy(leaves[k])))
    want = JaxPolicy().cast_to_compute(nest(lambda k: jnp.asarray(leaves[k])))
    assert isinstance(got["a"], list) and isinstance(got["a"][1], tuple) and got["n"] == 3
    for g, w in ((got["a"][0], want["a"][0]), (got["a"][1][0], want["a"][1][0]),
                 (got["a"][1][1], want["a"][1][1]), (got["b"]["c"], want["b"]["c"])):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.float().numpy() if g.is_floating_point() else g.numpy(),
                                      np.asarray(w.astype(jnp.float32)
                                                 if jnp.issubdtype(w.dtype, jnp.floating)
                                                 else w))
    f32 = __import__("mkg_analogy_tpu_torch.core.precision", fromlist=["FP32_POLICY"])
    assert f32.FP32_POLICY.cast_to_compute(torch.ones(2, dtype=torch.float64)).dtype \
        == torch.float32


def test_fused_adamw_gives_make_optimizers_update():
    """Three AdamW steps (warm-up and decay, weight decay on the decay group,
    grad clipping) through ``fused_adamw``, through ``make_optimizer(...,
    fused=True)`` and through the default ``make_optimizer``: every
    parameter equal bit for bit after each step."""
    from mkg_analogy_tpu_torch.train.optim import (fused_adamw, linear_warmup_linear_decay,
                                                   make_optimizer)

    def model():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.LayerNorm(5),
                                   torch.nn.Linear(5, 3))

    models = [model() for _ in range(3)]
    opts = [make_optimizer(models[0], 1e-2, 10, warmup_ratio=0.2, max_grad_norm=1.0),
            make_optimizer(models[1], 1e-2, 10, warmup_ratio=0.2, max_grad_norm=1.0,
                           fused=True),
            fused_adamw(models[2], linear_warmup_linear_decay(1e-2, 10, 0.2),
                        max_grad_norm=1.0)]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32))
    for _ in range(3):
        for m, opt in zip(models, opts):
            (m(x) ** 2).sum().backward()
            opt.step()
        for m in models[1:]:
            for (n, p), q in zip(models[0].named_parameters(), m.parameters()):
                assert torch.equal(p, q), n
    assert not torch.equal(models[0][0].weight, model()[0].weight)
