"""``UnimoConfig.remat``: every vision and text layer of the encoder's loop
run under ``torch.utils.checkpoint`` (non-reentrant) and again in the
backward, as the JAX model's ``remat`` wraps each layer in ``nn.remat``
(mkg_analogy_tpu/models/unimo.py:317-319).

At the tiny config of tests/util.tiny_unimo_config (fp32, 2 layers, width
32, fusion_start=1): remat on and off give the same loss and gradients bit
for bit with dropout on, and leave the dropout generators in the same
state (the recomputed layer draws its masks and attention seeds again from
the states the forward started from); each layer starts twice in a training
step and once without gradients; the port with remat against JAX with
``remat=True`` on the same converted weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkg_analogy_tpu.models.unimo import UnimoForMaskedLM as FlaxUnimo
from mkg_analogy_tpu_torch.models import common, unimo
from mkg_analogy_tpu_torch.models.convert import unimo_params_from_jax
from tests.util import tiny_unimo_config

torch.set_num_threads(1)

VOCAB = 256
# the full-model bar of tests/test_torch_port_unimo.py: fp32 on both sides,
# two towers of matmuls and their backward summed in different orders
MODEL_ATOL = 2e-4


def port_config(cfg, **changes):
    return unimo.UnimoConfig(
        text=unimo.TextConfig(**{f: getattr(cfg.text, f)
                                 for f in cfg.text.__dataclass_fields__}),
        vision=unimo.VisionConfig(**{f: getattr(cfg.vision, f)
                                     for f in cfg.vision.__dataclass_fields__}),
        fusion_start=cfg.fusion_start, dtype=cfg.dtype, **changes)


def make_batch(b=3, length=16):
    rng = np.random.default_rng(0)
    mask = np.ones((b, length), np.int32)
    mask[1, 12:] = 0
    return dict(
        input_ids=rng.integers(0, VOCAB, (b, length)).astype(np.int32),
        attention_mask=mask,
        token_type_ids=(np.arange(length)[None] >= 7).astype(np.int32).repeat(b, 0),
        pixel_values=rng.standard_normal((b, 2, 3, 16, 16)).astype(np.float32),
        positions=rng.integers(0, 9, (b, 5)).astype(np.int32),
        boundary=np.array([4, 6, 8][:b], np.int32),
    )


def weights(shape):
    """Fixed cotangents of the transformed hidden states."""
    return np.random.default_rng(1).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def flax_pair():
    cfg = dataclasses.replace(tiny_unimo_config(vocab_size=VOCAB), remat=True)
    flax_model = FlaxUnimo(cfg)
    params = jax.device_get(flax_model.init(
        jax.random.PRNGKey(0), **{k: jnp.asarray(v) for k, v in make_batch().items()},
        deterministic=True))
    return cfg, flax_model, params


def port_step(cfg, params, remat, attention="single", rng_seed=3):
    """(loss, gradients, the generators' states after the step) of one
    training forward with dropout and its backward."""
    model = unimo.UnimoForMaskedLM(port_config(cfg, remat=remat, attention=attention))
    model.load_state_dict(unimo_params_from_jax(params), strict=True)
    rng = common.DropoutRNG.from_seed(rng_seed, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    trans = model(**batch, deterministic=False, rng=rng)
    loss = (trans * torch.from_numpy(weights(tuple(trans.shape)))).sum()
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.detach(), grads, rng.get_state()


@pytest.mark.parametrize("attention", ["single", "flash"])
def test_remat_on_and_off_agree_bit_for_bit_with_dropout(flax_pair, attention):
    """The same loss and every gradient bit for bit, and both dropout
    generators (the masks' and the attention seeds') in the same state
    after the step, with hidden and attention dropout at 0.1: the
    recomputed layers draw what the forward drew. Without the generators'
    states restored they would draw other masks (checked: the states move
    in a step)."""
    cfg, _, params = flax_pair
    assert cfg.text.hidden_dropout > 0.0 and cfg.text.attention_dropout > 0.0
    off = port_step(cfg, params, remat=False, attention=attention)
    on = port_step(cfg, params, remat=True, attention=attention)
    assert torch.equal(off[0], on[0])
    assert set(off[1]) == set(on[1])
    for name, g in off[1].items():
        if name == "mlm_bias":  # the tied decoder's, which the forward does not reach
            assert g is None and on[1][name] is None
            continue
        assert g is not None and torch.equal(g, on[1][name]), name
    fresh = common.DropoutRNG.from_seed(3, "cpu").get_state()
    for a, b, start in zip(off[2], on[2], fresh):
        assert torch.equal(a, b) and not torch.equal(a, start)


def test_remat_runs_each_layer_again_in_the_backward(flax_pair):
    """With remat each of the 2 + 2 layers starts twice in a training step
    (the forward, then again in the backward, where the recomputation may
    stop once it has rebuilt what the backward needs) and once in a forward
    without gradients (evaluation keeps nothing for a backward); without,
    once."""
    cfg, _, params = flax_pair
    for remat, per_step in ((False, 1), (True, 2)):
        model = unimo.UnimoForMaskedLM(port_config(cfg, remat=remat))
        model.load_state_dict(unimo_params_from_jax(params), strict=True)
        runs = []
        layers = [m for n, m in model.encoder.named_children()]
        for layer in layers:
            layer.register_forward_pre_hook(lambda m, a: runs.append(m))
        batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
        trans = model(**batch, deterministic=False, rng=common.DropoutRNG.from_seed(3, "cpu"))
        trans.sum().backward()
        assert len(layers) == 4 and len(runs) == 4 * per_step
        runs.clear()
        with torch.no_grad():
            model(**batch)
        assert len(runs) == 4


def test_remat_matches_jax_remat(flax_pair):
    """The port with remat against JAX's model with remat=True, both
    differentiated (deterministic, so both draw nothing): the transformed
    hidden states and the scalar sum(trans * W) within 2e-4, each gradient
    leaf within 2e-4 of its largest |value| plus 1e-7 of the model's
    largest (for leaves whose exact gradient is 0, the key biases)."""
    cfg, flax_model, params = flax_pair
    batch = make_batch()
    w = weights((3, 5, 32))

    def f(p):
        trans = flax_model.apply(p, **{k: jnp.asarray(v) for k, v in batch.items()},
                                 deterministic=True)
        return (trans * jnp.asarray(w)).sum(), trans

    (want_loss, want_trans), want_g = jax.value_and_grad(f, has_aux=True)(params)
    model = unimo.UnimoForMaskedLM(port_config(cfg, remat=True))
    model.load_state_dict(unimo_params_from_jax(params), strict=True)
    trans = model(**{k: torch.from_numpy(v) for k, v in batch.items()})
    loss = (trans * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(trans.detach().numpy(), np.asarray(want_trans),
                               atol=MODEL_ATOL, rtol=0)
    assert abs(loss.item() - float(want_loss)) <= MODEL_ATOL * abs(float(want_loss))
    want = unimo_params_from_jax(jax.device_get(want_g))
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        if name == "mlm_bias":  # the tied decoder's, which the forward does not reach
            assert got[name].grad is None and not g.any()
            continue
        assert got[name].grad is not None, name
        err = float((got[name].grad - g).abs().max())
        assert err <= MODEL_ATOL * float(g.abs().max()) + 1e-7 * top, (name, err)
