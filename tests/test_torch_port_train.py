"""Port parity for the training slice, against the JAX package on the same
numpy inputs: ``gelu_poly``'s backward and the clip tie; the losses; the LR
schedule, the no-decay mask and the optimizer against optax; one fp32
fine-tune step of MKGformer (loss and every gradient leaf) against
``jax.grad`` of the JAX trainer's ``_finetune_loss`` on converted weights;
and the CLI's fine-tune, checkpoint and ``--only_test --checkpoint`` on the
CPU."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.cli import main as port_cli
from mkg_analogy_tpu_torch.models import common
from mkg_analogy_tpu_torch.ops import losses
from mkg_analogy_tpu_torch.train import checkpoint, optim
from tests.util import make_tiny_dataset, tiny_unimo_config

torch.set_num_threads(1)

XS = np.concatenate([np.linspace(-9, 9, 4001),
                     np.random.default_rng(4).standard_normal(2000) * 3]).astype(np.float32)


def test_gelu_poly_backward_matches_jax():
    """The fitted derivative series on both sides, evaluated in fp32 by the
    same Clenshaw steps: the gradients agree to fp32 round-off (1e-6 on
    values <= 1.13); and the series is within 5e-6 of the exact erf-gelu
    derivative (its fit error is 4.3e-6, models/common.py:126-135 of the JAX
    package)."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.models.common import gelu_poly as jax_gelu_poly

    cot = np.random.default_rng(5).standard_normal(XS.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jax_gelu_poly(x) * cot))(jnp.asarray(XS)))
    x = torch.from_numpy(XS).requires_grad_(True)
    (common.gelu_poly(x) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-6)

    x = torch.from_numpy(XS).requires_grad_(True)
    common.gelu_poly(x).sum().backward()
    xd = XS.astype(np.float64)
    exact = (0.5 * (1.0 + np.vectorize(math.erf)(xd / math.sqrt(2.0)))
             + xd * np.exp(-0.5 * xd * xd) / math.sqrt(2.0 * math.pi))
    np.testing.assert_allclose(x.grad.numpy(), exact, atol=5e-6)


def test_gelu_poly_backward_bf16():
    """bf16 input and cotangent: d * g in fp32, rounded to bf16 on both
    sides, so equal up to one bf16 ulp where d differs in its last fp32
    bits."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.models.common import gelu_poly as jax_gelu_poly

    cot = np.random.default_rng(6).standard_normal(XS.shape).astype(np.float32)
    xj, cj = jnp.asarray(XS, jnp.bfloat16), jnp.asarray(cot, jnp.bfloat16)
    _, vjp = jax.vjp(jax_gelu_poly, xj)
    want = np.asarray(vjp(cj)[0], np.float32)
    x = torch.from_numpy(XS).bfloat16().requires_grad_(True)
    common.gelu_poly(x).backward(torch.from_numpy(cot).bfloat16())
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(), want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("w,lo,hi", [(0.5, 0.5, 1.0), (0.0, 0.0, 0.5), (0.5, 0.0, 0.5),
                                     (0.7, 0.5, 1.0), (1.3, 0.5, 1.0)])
def test_clip_gradient_matches_jnp_clip(w, lo, hi):
    """jnp.clip splits the gradient at a tie with a bound (half of the
    slope); so does the port's clip. adaptive_w1 starts at 0.5, its lower
    bound, so a .clamp (whole slope) would double its first gradient."""
    import jax
    import jax.numpy as jnp

    want = float(jax.grad(lambda x: 3.0 * jnp.clip(x, lo, hi)[0])(jnp.asarray([w]))[0])
    x = torch.tensor([w], requires_grad=True)
    (3.0 * common.clip(x, lo, hi)).sum().backward()
    assert float(x.grad) == want
    if w in (lo, hi):
        assert want == 1.5


def _loss_inputs(seed=0, b=6, c=20):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, c)) * 3).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[2] = -100
    return logits, labels


@pytest.mark.parametrize("all_ignored", [False, True])
def test_label_smoothing_ce_matches_jax(all_ignored):
    """Value and gradient in fp32 (a mean of log-softmax sums over 20
    classes: 1e-6); rows at ignore_index drop out, and an all-ignored batch
    gives 0 with zero gradient."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.ops.losses import label_smoothing_cross_entropy as jax_ce

    logits, labels = _loss_inputs()
    if all_ignored:
        labels[:] = -100
    want, want_g = jax.value_and_grad(lambda x: jax_ce(x, jnp.asarray(labels), 0.1))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = losses.label_smoothing_cross_entropy(x, torch.from_numpy(labels), 0.1)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-6)
    assert not x.grad[2].any()
    if all_ignored:
        assert got.item() == 0.0 and not x.grad.any()


def test_label_smoothing_replaces_the_label_cell():
    """The smoothed target puts 1-s on the label (not 1-s+s/C, which
    F.cross_entropy(label_smoothing=s) gives)."""
    logits, labels = _loss_inputs(seed=1)
    labels[2] = 0
    x, y = torch.from_numpy(logits), torch.from_numpy(labels).long()
    got = losses.label_smoothing_cross_entropy(x, y, 0.1)
    logp = torch.log_softmax(x, -1)
    target = torch.full_like(logp, 0.1 / 20).scatter(1, y[:, None], 0.9)
    torch.testing.assert_close(got, -(target * logp).sum(-1).mean())
    assert abs(float(got - torch.nn.functional.cross_entropy(x, y, label_smoothing=0.1))) > 1e-4


def test_relaxation_loss_matches_jax():
    """Value and the gradients of all four inputs in fp32 (1e-6), with a
    row whose question/answer cosine is negative (the relu clamps it)."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.ops.losses import relaxation_loss as jax_relax

    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal((5, 16)).astype(np.float32) for _ in range(4)]
    arrs[1][0] = -arrs[0][0]
    want, want_g = jax.value_and_grad(lambda *a: jax_relax(*a), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    got = losses.relaxation_loss(*ts)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6)


@pytest.mark.parametrize("total,ratio", [(100, 0.1), (7, 0.3), (1, 0.1), (50, 0.0)])
def test_schedule_matches_optax(total, ratio):
    """Value by value over the whole horizon and past it, and exactly 0 at
    count 0 on both sides. The JAX schedule runs in fp32, where 1 -
    count/steps carries an absolute error of a few 2^-24, so the bar is
    1e-6 of the peak rate."""
    from mkg_analogy_tpu.train.optim import linear_warmup_linear_decay as jax_sched

    want = jax_sched(1e-3, total, ratio)
    got = optim.linear_warmup_linear_decay(1e-3, total, ratio)
    assert got(0) == 0.0 == float(want(0))
    for count in range(total + 3):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=0,
                                   atol=1e-6 * 1e-3, err_msg=str(count))


@pytest.fixture(scope="module")
def tiny_pair():
    """A Flax and a port UnimoForMaskedLM on the same converted weights
    (tests/util.tiny_unimo_config: fp32, 2 layers, fusion_start 1)."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.models.unimo import UnimoForMaskedLM as FlaxUnimo
    from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax
    from mkg_analogy_tpu_torch.models.unimo import UnimoForMaskedLM
    from tests.test_torch_port_unimo import port_config

    cfg = tiny_unimo_config(vocab_size=256)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, hidden_dropout=0.0, attention_dropout=0.0))
    b, length = 2, 16
    rng = np.random.default_rng(0)
    sample = dict(
        input_ids=rng.integers(0, 256, (b, length)).astype(np.int32),
        attention_mask=np.ones((b, length), np.int32),
        token_type_ids=np.zeros((b, length), np.int32),
        pixel_values=rng.standard_normal((b, 2, 3, 16, 16)).astype(np.float32),
        positions=rng.integers(0, 9, (b, 5)).astype(np.int32),
        boundary=np.array([4, 6], np.int32),
    )
    flax_model = FlaxUnimo(cfg)
    params = jax.device_get(jax.jit(lambda key, batch: flax_model.init(
        key, **batch, deterministic=True))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in sample.items()}))
    model = UnimoForMaskedLM(port_config(cfg))
    model.load_state_dict(unimo_params_from_jax(params), strict=True)
    return cfg, flax_model, params, model


def test_no_decay_mask_matches_jax(tiny_pair):
    """Leaf by leaf through the converter's name map: biases and LayerNorm
    scales do not decay; kernels, embeddings, mlm_bias and the adaptive
    scalars do."""
    from mkg_analogy_tpu.train.optim import no_decay_mask as jax_mask
    from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax
    import jax

    _, _, params, model = tiny_pair
    flags = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m)),
                                   jax_mask(params), params)
    want = {k: bool(v.reshape(-1)[0]) for k, v in unimo_params_from_jax(flags).items()}
    got = optim.no_decay_mask(model)
    assert got == want
    assert got["mlm_bias"] and got["encoder.text_0.adaptive_w1"]
    assert not got["encoder.text_0.attn_ln.weight"] and not got["vision_pre_ln.weight"]
    assert got["encoder.text_0.attn.query.weight"]


@pytest.mark.parametrize("fused", [False, True])
def test_optimizer_matches_optax(fused):
    """make_optimizer with max_grad_norm and accumulate 2 against the JAX
    make_optimizer (optax adamw + clip_by_global_norm + MultiSteps) over 5
    micro-steps fed identical numpy gradients: parameters within 1e-6 (the
    two compute the same fp32 update in another order). ``fused`` is
    --fused_adamw: the JAX package's vector-fused AdamW, and the same
    numbers on the port's side."""
    import jax
    import jax.numpy as jnp
    import optax
    from mkg_analogy_tpu.train.optim import make_optimizer as jax_make

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = torch.nn.Linear(3, 4)
            self.ln = torch.nn.LayerNorm(4)
            self.emb = torch.nn.Parameter(torch.zeros(5, 4))

    rng = np.random.default_rng(3)
    init = dict(kernel=rng.standard_normal((3, 4)), bias=rng.standard_normal(4),
                scale=1.0 + 0.1 * rng.standard_normal(4), ln_bias=rng.standard_normal(4),
                emb=rng.standard_normal((5, 4)))
    init = {k: v.astype(np.float32) for k, v in init.items()}

    def jax_tree(d):
        return {"dense": {"kernel": d["kernel"], "bias": d["bias"]},
                "ln": {"scale": d["scale"], "bias": d["ln_bias"]}, "emb": d["emb"]}

    model = Tiny()
    with torch.no_grad():
        model.dense.weight.copy_(torch.from_numpy(init["kernel"].T))
        model.dense.bias.copy_(torch.from_numpy(init["bias"]))
        model.ln.weight.copy_(torch.from_numpy(init["scale"]))
        model.ln.bias.copy_(torch.from_numpy(init["ln_bias"]))
        model.emb.copy_(torch.from_numpy(init["emb"]))
    kw = dict(lr=1e-2, total_steps=10, warmup_ratio=0.2, weight_decay=0.1,
              grad_accum_steps=2, max_grad_norm=0.5, fused=fused)
    opt = optim.make_optimizer(model, **kw)
    tx = jax_make(**kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_tree(init))
    state = tx.init(jparams)
    updated = []
    for _ in range(5):
        g = {k: (rng.standard_normal(v.shape) * 2).astype(np.float32) for k, v in init.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, jax_tree(g)), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        model.dense.weight.grad = torch.from_numpy(g["kernel"].T.copy())
        model.dense.bias.grad = torch.from_numpy(g["bias"])
        model.ln.weight.grad = torch.from_numpy(g["scale"])
        model.ln.bias.grad = torch.from_numpy(g["ln_bias"])
        model.emb.grad = torch.from_numpy(g["emb"])
        updated.append(opt.step())
    assert updated == [False, True, False, True, False]
    got = {"kernel": model.dense.weight.detach().numpy().T, "bias": model.dense.bias,
           "scale": model.ln.weight, "ln_bias": model.ln.bias, "emb": model.emb}
    want = dict(kernel=jparams["dense"]["kernel"], bias=jparams["dense"]["bias"],
                scale=jparams["ln"]["scale"], ln_bias=jparams["ln"]["bias"], emb=jparams["emb"])
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k].detach() if torch.is_tensor(got[k])
                                              else got[k]), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)
        assert not np.allclose(np.asarray(want[k]), init[k]), k  # the params moved


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_tiny_dataset(str(tmp_path_factory.mktemp("port_train_kg")))


def test_finetune_step_matches_jax(tiny_pair, dataset):
    """One fp32 fine-tune step on the same converted weights and batch:
    the JAX trainer's _finetune_loss through the Pallas kernels in
    interpret mode, differentiated by jax.grad, against the port's through
    its autograd.Function (plain forward and backward on the CPU), dropout
    rates 0. The loss within 1e-5 relative; each gradient leaf within 1e-4
    of that leaf's largest |gradient| (fp32 on both sides: two towers of
    matmuls and their backward, summed in different orders), plus 1e-7 of
    the largest gradient of the model, for leaves whose exact gradient is 0
    (the key biases: softmax ignores a per-row constant) and which carry
    round-off only."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.core.mesh import make_mesh
    from mkg_analogy_tpu.data.module import KGCDataModule as JaxDataModule
    from mkg_analogy_tpu.models import common as jcommon
    from mkg_analogy_tpu.train import trainer as jtrainer
    from mkg_analogy_tpu_torch.data.module import KGCDataModule
    from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax
    from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

    cfg, flax_model, params, model = tiny_pair
    markg_dir, mars_dir = dataset
    kw = dict(data_dir=mars_dir, pretrain_path=markg_dir, max_seq_length=48,
              text_vocab_size=200, image_size=16)
    jdata, pdata = JaxDataModule(**kw), KGCDataModule(**kw)
    assert jdata.vocab.padded_vocab_size <= 256
    feats = jdata.features("train")
    batch = {k: v[:4] for k, v in feats.items()}
    batch["pixel_values"] = np.random.default_rng(7).standard_normal(
        (4, 2, 3, 16, 16)).astype(np.float32)

    jt = jtrainer.MarTTrainer(flax_model, jdata.vocab, jtrainer.TrainConfig(alpha=0.43),
                              mesh=make_mesh(dp=1, tp=1, devices=jax.devices()[:1]))
    saved = (jcommon.USE_FUSED_ATTENTION, jcommon.FUSED_INTERPRET, jcommon.FUSED_BACKEND)
    try:
        jcommon.set_fused_attention(True, interpret=True)
        (want_loss, want_aux), want_g = jax.jit(jax.value_and_grad(
            lambda p, b: jt._finetune_loss(p, b, jax.random.PRNGKey(1)), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        (jcommon.USE_FUSED_ATTENTION, jcommon.FUSED_INTERPRET,
         jcommon.FUSED_BACKEND) = saved

    pt = MarTTrainer(model, pdata.vocab, TrainConfig(alpha=0.43), device="cpu")
    model.zero_grad(set_to_none=True)
    loss, aux = pt._finetune_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                                  common.DropoutRNG.from_seed(1, "cpu"))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for k in ("ce", "sim"):
        assert abs(aux[k].item() - float(want_aux[k])) <= 1e-5 * abs(float(want_aux[k]))
    want = unimo_params_from_jax(jax.device_get(want_g))
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        bound = 1e-4 * float(w.abs().max()) + 1e-7 * top
        err = float((g - w).abs().max())
        assert err <= bound, (name, err, bound)
    # the adaptive scalars start at a clip bound (w1 = 0.5): half the slope
    assert float(got["encoder.text_0.adaptive_w1"].grad) != 0.0


def train_flags(dataset, tmp_path, tag, extra=()):
    markg_dir, mars_dir = dataset
    return ["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--device", "cpu",
            "--max_epochs", "1", "--batch_size", "8", "--eval_batch_size", "8",
            "--max_seq_length", "48", "--text_vocab_size", "256", "--hidden_size", "32",
            "--num_layers", "2", "--num_heads", "2", "--intermediate_size", "64",
            "--dtype", "float32", "--lr", "1e-3",
            "--output_dir", str(tmp_path / f"out_{tag}"),
            "--log_dir", str(tmp_path / f"logs_{tag}"),
            "--cache_dir", str(tmp_path / "cache"), *extra]


def _last_losses(log_dir):
    rows = [json.loads(line) for line in open(log_dir / "train_metrics.jsonl")]
    return [r["train/last_loss"] for r in rows if "train/last_loss" in r]


def test_cli_finetune_checkpoint_and_retest(dataset, tmp_path):
    """One epoch on the CPU: a checkpoint of the best dev Hits@10; the test
    ranks of the fit reproduced exactly by --only_test --checkpoint; a
    second run with the same seed gives the same losses and ranks."""
    got = port_cli.main(train_flags(dataset, tmp_path, "a"))
    assert all(np.isfinite(v) for v in got.values())
    assert 0.0 < got["Eval_entity/mrr"] <= 1.0
    ckpt = tmp_path / "out_a" / "ckpt"
    steps = checkpoint.list_steps(str(ckpt))
    assert steps == [3]  # 24 examples / 8 a batch
    assert (ckpt / "metrics_3.json").exists()
    ranks = np.load(tmp_path / "out_a" / "test_ranks.npz")["ranks"]

    retest = port_cli.main(train_flags(dataset, tmp_path, "b") + [
        "--only_test", "--checkpoint", str(ckpt)])
    np.testing.assert_array_equal(np.load(tmp_path / "out_b" / "test_ranks.npz")["ranks"],
                                  ranks)
    assert retest == got

    again = port_cli.main(train_flags(dataset, tmp_path, "c"))
    assert again == got
    losses_a = _last_losses(tmp_path / "logs_a")
    assert losses_a and losses_a == _last_losses(tmp_path / "logs_c")
    np.testing.assert_array_equal(np.load(tmp_path / "out_c" / "test_ranks.npz")["ranks"],
                                  ranks)


@pytest.mark.parametrize("extra,steps", [
    (["--limit_train_batches", "2"], 2),      # an int is a batch count
    (["--limit_train_batches", "0.4"], 1),    # a float in (0, 1] an epoch share
    (["--accumulate_grad_batches", "2", "--track_grad_norm", "2"], 3),
])
def test_cli_trainer_flags(dataset, tmp_path, extra, steps):
    """pl.Trainer's limit_train_batches rule (24 examples / 8 = 3 batches an
    epoch) and gradient accumulation: the checkpoint carries the step count."""
    got = port_cli.main(train_flags(dataset, tmp_path, "f", extra))
    assert all(np.isfinite(v) for v in got.values())
    assert checkpoint.list_steps(str(tmp_path / "out_f" / "ckpt")) == [steps]


def test_cli_profile_writes_a_trace(dataset, tmp_path):
    """--profile traces steps 5..10 with torch.profiler (2 epochs of 3 steps
    here: the trace covers step 6 and closes when the fit ends)."""
    port_cli.main(train_flags(dataset, tmp_path, "p", ["--profile", "--max_epochs", "2"]))
    assert (tmp_path / "logs_p" / "profile" / "trace.json").stat().st_size > 0


def test_cli_train_on_cuda_without_gpu_raises(dataset, tmp_path):
    """Training, like evaluation, runs on CUDA by default and never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    flags = train_flags(dataset, tmp_path, "cuda")
    i = flags.index("--device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(flags[:i] + flags[i + 2:])


def test_checkpointer_keeps_two_and_replaces_stale_steps(tmp_path):
    """max_to_keep=2 keeps the newest; a save at a step <= one already on
    disk (a reused directory) deletes the stale ones first; the snapshot is
    taken at save time, not when the worker writes."""
    ck = checkpoint.Checkpointer(str(tmp_path))
    try:
        w = torch.zeros(3)
        ck.save(9, {"w": w})  # a later step of an earlier run, stale for 4
        ck.save(4, {"w": w + 4})
        w += 1  # after save: not in the snapshot
        ck.save(5, {"w": w})
        ck.save(6, {"w": w + 5}, metrics={"Eval_entity/hits10": 0.5})
        assert ck.restore()["w"].equal(w + 5)  # the latest step
        assert checkpoint.list_steps(str(tmp_path)) == [5, 6]
        assert torch.equal(ck.restore(5)["w"], torch.ones(3))
        assert json.load(open(tmp_path / "metrics_6.json")) == {"Eval_entity/hits10": 0.5}
        assert ck.saved_steps == [9, 4, 5, 6]
        state = {"w": torch.zeros(3), "v": torch.zeros(2)}
        merged = checkpoint.partial_restore(state, {"w": torch.ones(3), "v": torch.ones(5)})
        assert torch.equal(merged["w"], torch.ones(3)) and not merged["v"].any()
    finally:
        ck.close()
