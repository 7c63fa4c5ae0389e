"""Port parity of rows 1-5 (the single-block and the flash attention) at head
widths above 128: 136 (ragged in the library of 192), 192, 195 (unaligned:
its rows are not 16-byte aligned in either dtype) and 256, the widths of
heads such as MKGformer's 768 over 3 heads, or 512 over 2.

The plain PyTorch forward and backward (mkg_analogy_tpu_torch/kernels/
attention.py, flash_attention.py) against the JAX kernels in interpret mode
(``fused_attention``, ``flash_attention`` and ``jax.vjp`` of them) on the
same numpy inputs, B=1, 2 heads, 40 x 56 with the text geometry, dropout 0
and 0.1; the flash ones in ragged small logical tiles. A two-layer
MKGformerKGC of two heads of 256 (``--hidden_size 512 --num_heads 2``) on
the Flax model's weights (models/convert.params_from_jax): transformed
states, logits and loss through both kernel routes' plain versions against
JAX's. Then the width logic above 128, and the CUDA kernels of every route
and dtype at 136, 192, 200, 250 and 256 against their plain versions (need
a card)."""

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as single
from mkg_analogy_tpu_torch.kernels import build
from mkg_analogy_tpu_torch.kernels import flash_attention as flash
from test_torch_port_attention import cuda  # noqa: F401

# JAX is imported where it is used: the card's machine runs the `cuda`
# tests of this file without it.

torch.set_num_threads(1)

H, LQ, LK = 2, 40, 56
ATOL = 1e-5  # the per-op bar (tests/test_fused_attention.py:74)
SEED = 2 ** 31 - 9
WIDTHS = (136, 192, 195, 256)
GEOMETRY = dict(boundary=(12,), row_start=1, text_len=LQ)  # the text tower's
BLOCKS = (16, 24)  # ragged logical flash tiles: Q 16 + 16 + 8, K 24 + 24 + 8


def make_inputs(d, seed=0):
    """q, k, v and the cotangent g (B=1, 2 heads of d) and the mask: the
    last 6 keys padded."""
    rng = np.random.default_rng(seed + d)
    q, k, v, g = (rng.standard_normal((1, n, H * d)).astype(np.float32)
                  for n in (LQ, LK, LK, LQ))
    mask = np.ones((1, LK), np.float32)
    mask[:, LK - 6:] = 0.0
    return q, k, v, g, mask


def jax_results(q, k, v, g, mask, rate, blocks=None):
    """(out, dq, dk, dv, dw0, dw1) of the JAX kernel (the flash kernels with
    ``blocks``) in interpret mode, fp32, with the text geometry."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.attention import fused_attention as jax_fused
    from mkg_analogy_tpu.kernels.flash_attention import flash_attention as jax_flash

    kw = dict(GEOMETRY, boundary=jnp.asarray(GEOMETRY["boundary"]))
    if blocks is not None:
        kw.update(block_q=blocks[0], block_k=blocks[1])
    fn = jax_fused if blocks is None else jax_flash

    def f(q, k, v, w0, w1):
        return fn(q, k, v, jnp.asarray(mask), H, compute_dtype=jnp.float32, interpret=True,
                  dropout_rate=rate, deterministic=rate == 0.0,
                  dropout_seed=jnp.asarray(SEED, jnp.int32), w0=w0, w1=w1, **kw)

    args = [jnp.asarray(x) for x in (q, k, v)] + [jnp.asarray([0.3]), jnp.asarray([0.7])]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g))
    return [np.asarray(out)] + [np.asarray(x) for x in grads[:3]] + [
        float(grads[3][0]), float(grads[4][0])]


def port_kwargs(device="cpu", geometry=GEOMETRY):
    return dict(geometry, boundary=torch.tensor(geometry["boundary"], device=device),
                w0=torch.tensor([0.3], device=device), w1=torch.tensor([0.7], device=device))


def port_results(q, k, v, g, mask, rate, blocks=None):
    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    kw = dict(port_kwargs(), compute_dtype=torch.float32, dropout_rate=rate,
              deterministic=rate == 0.0, dropout_seed=SEED)
    if blocks is None:
        out = single.fused_attention_reference(*t[:4], H, **kw)
        grads = single.fused_attention_bwd_reference(*t, H, **kw)
    else:
        kw.update(block_q=blocks[0], block_k=blocks[1])
        out = flash.flash_attention_reference(*t[:4], H, **kw)
        grads = flash.flash_attention_bwd_reference(*t, H, **kw)
    dq, dk, dv, dw = grads
    return [out.numpy(), dq.numpy(), dk.numpy(), dv.numpy(), float(dw[0]), float(dw[1])]


@pytest.mark.parametrize("route", ["single", "flash"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_versions_match_jax_kernels_at_wide_heads(d, rate, route):
    """Rows 1-2 (``single``) and 3-5 (``flash``, ragged tiles): the plain
    forward and backward at head width ``d`` against the JAX kernels, out,
    dq, dk, dv within 1e-5, dw0 and dw1 within 1e-5 for each of the Lk keys
    they sum over (test_torch_port_head_widths.py); with dropout the keep
    masks must agree bit for bit, or the bars break."""
    blocks = BLOCKS if route == "flash" else None
    q, k, v, g, mask = make_inputs(d, seed=int(route == "flash"))
    got = port_results(q, k, v, g, mask, rate, blocks)
    want = jax_results(q, k, v, g, mask, rate, blocks)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[:4], want[:4]):
        assert a.shape == b.shape == (1, LQ if name in ("out", "dq") else LK, H * d)
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)
    for name, a, b in zip(("dw0", "dw1"), got[4:], want[4:]):
        np.testing.assert_allclose(a, b, atol=ATOL * LK, rtol=0, err_msg=name)


# ------------------------------------------- the model at two heads of 256

MODEL_ATOL = 2e-4  # full-model activations (COMPONENTS.md M5)
B, L, V = 3, 16, 128


@pytest.fixture(scope="module")
def wide_pair():
    """(flax model, its variables, the batch, the port's model on the
    converted weights): MKGformerKGC at width 512 with 2 heads (head_dim
    256 in both towers), 2 layers, fp32, dropout off."""
    import jax
    import jax.numpy as jnp
    from mkg_analogy_tpu.models.registry import create_model as jax_create
    from mkg_analogy_tpu_torch.models.convert import params_from_jax
    from mkg_analogy_tpu_torch.models.registry import create_model

    sizes = dict(hidden_size=512, num_layers=2, num_heads=2, intermediate_size=64)
    flax_model = jax_create("MKGformerKGC", vocab_size=V, dtype="float32", **sizes)
    assert flax_model.cfg.text.head_dim == flax_model.cfg.vision.head_dim == 256
    rng = np.random.default_rng(0)
    mask = np.ones((B, L), np.int32)
    mask[1, 12:] = 0
    mask[2, 9:] = 0
    batch = dict(
        input_ids=rng.integers(5, V, (B, L)).astype(np.int32),
        attention_mask=mask,
        token_type_ids=(np.arange(L)[None] >= 7).astype(np.int32).repeat(B, 0),
        pixel_values=rng.standard_normal((B, 2, 3, 224, 224)).astype(np.float32),
        positions=rng.integers(0, 9, (B, 5)).astype(np.int32),
        boundary=np.array([4, 6, 8], np.int32),
    )
    params = jax.device_get(jax.jit(lambda key, b: flax_model.init(key, **b, deterministic=True))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    model = create_model("MKGformerKGC", vocab_size=V, dtype="float32", **sizes)
    model.load_state_dict(params_from_jax(params), strict=True)
    return flax_model, params, batch, model


@pytest.mark.parametrize("backend", ["single", "flash"])
def test_two_heads_of_256_match_jax(wide_pair, backend):
    """The transformed states, the tied logits over 128 ids and the
    label-smoothed loss of the wide model through each kernel route (on the
    CPU its plain versions) against the Flax model, within 2e-4."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.ops.losses import label_smoothing_cross_entropy as jax_ce
    from mkg_analogy_tpu_torch.models import common
    from mkg_analogy_tpu_torch.ops.losses import label_smoothing_cross_entropy

    flax_model, params, batch, model = wide_pair
    for m in model.modules():
        if isinstance(m, common.AttentionCore):
            assert m.head_dim == 256
            m.backend = backend
    want = np.asarray(flax_model.apply(params, **{k: jnp.asarray(v) for k, v in batch.items()},
                                       deterministic=True))
    with torch.inference_mode():
        got = model(**{k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert got.shape == want.shape == (B, 5, 512)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)
    want_logits = np.asarray(flax_model.apply(params, jnp.asarray(want[:, 0]),
                                              method=type(flax_model).logits))
    with torch.inference_mode():
        got_logits = model.logits(torch.from_numpy(got[:, 0])).numpy()
    np.testing.assert_allclose(got_logits, want_logits, atol=MODEL_ATOL)
    labels = np.array([7, 100, 42], np.int64)
    want_loss = float(jax_ce(jnp.asarray(want_logits), jnp.asarray(labels), 0.1))
    got_loss = float(label_smoothing_cross_entropy(torch.from_numpy(got_logits),
                                                   torch.from_numpy(labels), 0.1))
    np.testing.assert_allclose(got_loss, want_loss, atol=MODEL_ATOL)


# ------------------------------------------------------- the width logic


def test_widths_above_128_pad_to_192_or_256():
    """From 129 on a width runs the instance of its multiple of 64 (every
    block there owns 64 result columns): 129-192 the library of 192,
    193-256 that of 256; the CLI's cache builds both sets of eight."""
    for d in range(129, 257):
        assert build.padded_width(d) == (192 if d <= 192 else 256)
        assert build.library_width(d) == build.padded_width(d)
    jobs = []
    real = build.build_jobs
    try:
        build.build_jobs = lambda js: jobs.append(sorted(js, key=str))
        build.build_widths([136, 192, 200, 256, 64])
    finally:
        build.build_jobs = real
    assert jobs == [sorted([(n, w) for w in (192, 256) for n in build.ATTENTION_SOURCES],
                           key=str)]
    assert single.MAX_HEAD_DIM == build.MAX_HEAD_DIM == 256


def test_call_arguments_carry_the_real_width_and_its_scale(monkeypatch):
    """Above 128 the launchers pass the call's own width and d^-1/2 of it,
    never the padded width's."""
    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    for d in WIDTHS + (129, 200, 250):
        q = torch.zeros(1, 8, H * d)
        args = flash._call_args(q, q, H, None, 0.0, 0, 256, 512)
        assert args[3:7] == (H, d, 0, float(d) ** -0.5), args
        assert single._call_tail(q, d, None, 0.0, 0, None, 1.0)[0] == float(d) ** -0.5


# ---------------------------------------------------------------- on the card

# 136 ragged and 192 exact in the library of 192; 200 aligned, 250 not
# 16-byte aligned (element-wise staging) and 256 exact in the library of 256
KERNEL_WIDTHS = (136, 192, 200, 250, 256)
KB = 2  # batch rows of the card's cases


def kernel_inputs(d, dtype, device, lq, lk, seed=0):
    gen = torch.Generator().manual_seed(seed + d)
    q, g = (torch.randn(KB, lq, H * d, generator=gen).to(device, dtype) for _ in range(2))
    k, v = (torch.randn(KB, lk, H * d, generator=gen).to(device, dtype) for _ in range(2))
    mask = torch.ones(KB, lk)
    mask[1, lk - 40:] = 0.0
    return q, k, v, g, mask.to(device)


def assert_close_to(got, want, rel):
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=rel * b.float().abs().max().item() + 1e-30, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", KERNEL_WIDTHS)
def test_single_block_kernels_at_wide_heads(cuda, d, dtype, rate):  # noqa: F811
    """Rows 1-2 at head width ``d`` on the card, at MKGformer's vision over
    text K/V (99 x 227) with a geometry: the forward within 2e-5 fp32 /
    2e-2 bf16 of the plain version, the backward within 2e-5 / 2^-7 of each
    result's largest; each launch counted under its width."""
    q, k, v, g, mask = kernel_inputs(d, dtype, cuda, 99, 227)
    geometry = dict(boundary=(10, 20), row_start=1, text_len=None)
    kw = dict(port_kwargs(cuda, geometry), compute_dtype=dtype, dropout_rate=rate,
              deterministic=rate == 0.0, dropout_seed=5)
    before = (single.WIDTH_LAUNCHES["fwd", d], single.WIDTH_LAUNCHES["bwd", d])
    got = single.fused_attention(q, k, v, mask, H, **kw)
    want = single.fused_attention_reference(q, k, v, mask, H, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=2e-5 if dtype == torch.float32 else 2e-2, rtol=0)
    bnd, w, geo, rate, seed = single._resolve(q, kw["boundary"], kw["w0"], kw["w1"], None,
                                              kw["row_start"], 0, rate, rate == 0.0, 5)
    grads = single._launch_bwd(q, k, v, mask, g, H, bnd, w, geo, rate, seed)
    torch.cuda.synchronize()
    assert (single.WIDTH_LAUNCHES["fwd", d], single.WIDTH_LAUNCHES["bwd", d]) == (
        before[0] + 1, before[1] + 1)
    want = single.fused_attention_bwd_reference(q, k, v, mask, g, H, **kw)
    assert_close_to(grads[:3], want[:3], 2e-5 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", KERNEL_WIDTHS)
def test_flash_kernels_at_wide_heads(cuda, d, dtype, rate):  # noqa: F811
    """Rows 3-5 at head width ``d`` on the card, at the triple pre-train's
    96 x 96 in ragged small tiles with a geometry: out within 2e-5 / 2e-2
    and lse within 1e-5 of the plain forward; dq, dk, dv from the kernels'
    out and lse within 2e-5 / 2^-7 of each result's largest."""
    q, k, v, g, mask = kernel_inputs(d, dtype, cuda, 96, 96, seed=1)
    kw = port_kwargs(cuda, dict(boundary=(10, 20), row_start=1, text_len=None))
    bnd, w, geo, rate, seed = single._resolve(q, kw["boundary"], kw["w0"], kw["w1"], None,
                                              kw["row_start"], 0, rate, rate == 0.0, 6)
    args = (H, bnd, w, geo, rate, seed, 48, 80)
    before = flash.WIDTH_LAUNCHES_FLASH["", d]
    out, lse = flash._launch_fwd(q, k, v, mask, *args)
    want_out, want_lse = flash._plain_fwd(q, k, v, mask, *args[:6], dtype, *args[6:])
    torch.cuda.synchronize()
    assert flash.WIDTH_LAUNCHES_FLASH["", d] == before + 1
    torch.testing.assert_close(out.float(), want_out.float(),
                               atol=2e-5 if dtype == torch.float32 else 2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    delta = flash._delta(g, out, H)
    grads = flash._launch_bwd(q, k, v, mask, g, lse, delta, *args)
    want = flash._plain_bwd(q, k, v, mask, g, lse, delta, *args[:6], dtype, *args[6:])
    torch.cuda.synchronize()
    assert_close_to(grads[:3], want[:3], 2e-5 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.cuda
def test_width_257_raises(cuda):  # noqa: F811
    """Above 256 neither route has an instance: a ValueError naming the
    limit, and nothing falls back."""
    q = torch.zeros(1, 8, 257, device=cuda, dtype=torch.bfloat16)
    mask = torch.ones(1, 8, device=cuda)
    for attention in (single.fused_attention, flash.flash_attention):
        with pytest.raises(ValueError, match="head_dim 1 to 256"):
            attention(q, q, q, mask, 1)
