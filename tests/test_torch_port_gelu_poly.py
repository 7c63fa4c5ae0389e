"""``gelu_poly``'s CUDA kernels (``csrc/gelu_poly.cu``) and their wrapper
(``kernels/gelu_poly.py``).

On the CPU: the kernel source spells the two series' coefficients as the
plain version holds them (which tests/test_torch_port_unimo.py and
tests/test_torch_port_train.py hold to JAX), a CPU tensor takes the plain
version and launches nothing, the autograd function saves only x, and the
launchers refuse what the kernels do not take. The ``cuda``-marked tests
(they skip without a card) hold both kernels to the plain chain bit for bit
on the card: at the cells' FFN shapes, at a ragged size, on unaligned
storage, at every bf16 value and at the special values, and count one
launch each way a call in a bf16 UniMo training step. No JAX here, so that
the file runs on the card with ``--noconftest``."""

import pathlib
import re

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import gelu_poly as gp
from mkg_analogy_tpu_torch.models import common, unimo

CU = pathlib.Path(gp.__file__).resolve().parent.parent / "csrc" / "gelu_poly.cu"
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
# the FFN activations of the cells: MKGformer's text layers (B=32, L=128);
# FLAVA's multimodal, image and text layers (B=24)
CELL_SHAPES = [(32, 128, 3072), (24, 522, 3072), (24, 393, 3072), (24, 128, 3072)]


def _cu_coefficients(name):
    body = re.search(rf"{name}\[15\] = \{{(.*?)\}};", CU.read_text(), flags=re.S).group(1)
    return [tok.strip() for tok in body.split(",") if tok.strip()]


@pytest.mark.parametrize("name,coeffs", [("kGeluCheb", gp._GELU_POLY_CHEB),
                                         ("kGeluDerivCheb", gp._GELU_POLY_DERIV_CHEB)])
def test_kernel_coefficients_are_the_plain_series(name, coeffs):
    """Digit for digit the Python doubles, so the kernel rounds each to fp32
    as PyTorch rounds the plain chain's scalars."""
    assert _cu_coefficients(name) == [repr(c) for c in coeffs]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_takes_the_plain_version(dtype, monkeypatch):
    monkeypatch.setattr(gp, "LAUNCHES_GELU_FWD", 0)
    monkeypatch.setattr(gp, "LAUNCHES_GELU_BWD", 0)
    xs = torch.linspace(-9, 9, 4001).to(dtype)
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(0)).to(dtype)
    x = xs.clone().requires_grad_(True)
    y = common.gelu_poly(x)
    y.backward(g)
    assert torch.equal(y.detach(), gp.gelu_poly_reference(xs))
    assert torch.equal(x.grad, gp.gelu_poly_grad_reference(xs, g))
    assert y.dtype == x.grad.dtype == dtype
    assert gp.LAUNCHES_GELU_FWD == 0 and gp.LAUNCHES_GELU_BWD == 0


def test_autograd_saves_only_x():
    saved = []
    x = torch.randn(4, 8, dtype=torch.bfloat16, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        common.gelu_poly(x)
    assert len(saved) == 1 and saved[0].data_ptr() == x.data_ptr()


def test_launchers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="gelu_poly_reference"):
        gp._launch_fwd(torch.zeros(8))
    with pytest.raises(ValueError, match="gelu_poly_reference"):
        gp._launch_bwd(torch.zeros(8), torch.zeros(8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gelu_poly kernels have no CPU mode")
    return torch.device("cuda")


def assert_same_bits(got, want, what=""):
    """Bit for bit, NaN for NaN (a NaN's payload aside)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    assert torch.equal(nan_got, nan_want), what
    bits = BITS[got.dtype]
    differ = got.view(bits)[~nan_got] != want.view(bits)[~nan_want]
    assert not differ.any(), f"{what}: {int(differ.sum())} of {got.numel()} elements differ"


def check_both_ways(x, g):
    """One launch each way, each bit for bit the plain chain on the card."""
    fwd, bwd = gp.LAUNCHES_GELU_FWD, gp.LAUNCHES_GELU_BWD
    y = gp._launch_fwd(x)
    dx = gp._launch_bwd(x, g)
    want_y, want_dx = gp.gelu_poly_reference(x), gp.gelu_poly_grad_reference(x, g)
    torch.cuda.synchronize()
    assert (gp.LAUNCHES_GELU_FWD, gp.LAUNCHES_GELU_BWD) == (fwd + 1, bwd + 1)
    assert_same_bits(y, want_y)
    assert_same_bits(dx, want_dx)


def special_values(dtype):
    """±0, ±inf, NaN, the subnormals' ends, the normals' ends, |x| around 6
    (where s and the derivative's clamp saturate) and -9 to 9."""
    info = torch.finfo(dtype)
    sub = info.smallest_normal
    # 6 and its three neighbours each way, by their bits
    around6 = (torch.tensor([6.0]).to(dtype).view(BITS[dtype])
               + torch.arange(-3, 4).to(BITS[dtype])).view(dtype)
    edges = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                          sub, -sub, sub / 2, -sub / 2, info.tiny * info.eps, info.max,
                          -info.max, 1e19, -1e19, 4.2426, -4.2426]).to(dtype)
    return torch.cat([edges, around6, -around6, torch.linspace(-9, 9, 4001).to(dtype)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_kernels_match_plain_chain_at_the_cells_shapes(cuda, shape, dtype):
    gen = torch.Generator(cuda).manual_seed(sum(shape))
    x = (3 * torch.randn(shape, device=cuda, generator=gen)).to(dtype)
    g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    check_both_ways(x, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_at_a_ragged_size_and_on_unaligned_storage(cuda, dtype):
    gen = torch.Generator(cuda).manual_seed(7)
    for shape in [(7, 13, 3), (1,), (8,), (9,), (2047,)]:
        x = (3 * torch.randn(shape, device=cuda, generator=gen)).to(dtype)
        check_both_ways(x, torch.randn(shape, device=cuda, generator=gen).to(dtype))
    for offset, n in [(1, 273), (1, 8 * 256 * 3 + 5), (3, 4096)]:
        buf = (3 * torch.randn(n + offset, device=cuda, generator=gen)).to(dtype)
        gbuf = torch.randn(n + offset, device=cuda, generator=gen).to(dtype)
        x, g = buf[offset:], gbuf[:n]
        assert x.data_ptr() % 16 and x.is_contiguous()
        check_both_ways(x, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_at_the_special_values(cuda, dtype):
    x = special_values(dtype).to(cuda)
    gen = torch.Generator(cuda).manual_seed(11)
    g = torch.randn(x.shape, device=cuda, generator=gen).to(dtype)
    g[:5] = torch.tensor([0.0, -0.0, float("inf"), float("nan"), 1.0]).to(dtype)
    check_both_ways(x, g)


@pytest.mark.cuda
def test_kernels_at_every_bf16_value(cuda):
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = x.to(cuda)
    g = torch.randn(x.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    check_both_ways(x, g.to(torch.bfloat16))


@pytest.mark.cuda
def test_random_fp32_bit_patterns(cuda):
    bits = np.random.default_rng(5).integers(-2 ** 31, 2 ** 31, 1 << 20, dtype=np.int64)
    x = torch.from_numpy(bits.astype(np.int32)).view(torch.float32).to(cuda)
    g = torch.randn(x.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    check_both_ways(x, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_raise_on_the_card(cuda, dtype):
    x = torch.randn(16, device=cuda).to(dtype)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        common.gelu_poly(x)


@pytest.mark.cuda
def test_a_bf16_unimo_training_step_launches_once_a_call_each_way(cuda, monkeypatch):
    """Each text layer's FFN and the MLM transform call gelu_poly once (the
    vision tower takes quick_gelu); the step's output and every gradient
    leaf are the plain chain's bit for bit."""
    layers = 2
    text = unimo.TextConfig(vocab_size=256, hidden_size=128, num_layers=layers, num_heads=2,
                            intermediate_size=256, max_position_embeddings=64)
    vision = unimo.VisionConfig(hidden_size=128, num_layers=2, num_heads=2,
                                intermediate_size=256, image_size=16, patch_size=8)
    cfg = unimo.UnimoConfig(text=text, vision=vision, fusion_start=1, dtype="bfloat16",
                            attention="plain")
    model = unimo.UnimoForMaskedLM(cfg)
    model.init_params(torch.Generator().manual_seed(0))
    model = model.to(cuda)
    rng = np.random.default_rng(0)
    b, length = 3, 16
    mask = np.ones((b, length), np.int32)
    mask[1, 12:] = 0
    batch = dict(
        input_ids=rng.integers(0, 256, (b, length)).astype(np.int32),
        attention_mask=mask,
        token_type_ids=(np.arange(length)[None] >= 7).astype(np.int32).repeat(b, 0),
        pixel_values=rng.standard_normal((b, 2, 3, 16, 16)).astype(np.float32),
        positions=rng.integers(0, 9, (b, 5)).astype(np.int32),
        boundary=np.array([4, 6, 8], np.int32),
    )
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}

    def step():
        model.zero_grad(set_to_none=True)
        trans = model(**batch, deterministic=False, rng=common.DropoutRNG.from_seed(3, cuda))
        trans.float().square().sum().backward()
        torch.cuda.synchronize()
        return trans.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                                if p.grad is not None}

    fwd, bwd = gp.LAUNCHES_GELU_FWD, gp.LAUNCHES_GELU_BWD
    got, grads = step()
    assert gp.LAUNCHES_GELU_FWD - fwd == layers + 1
    assert gp.LAUNCHES_GELU_BWD - bwd == layers + 1
    assert grads and all(torch.isfinite(g).all() for g in grads.values())
    monkeypatch.setattr(gp, "_launch_fwd", gp.gelu_poly_reference)
    monkeypatch.setattr(gp, "_launch_bwd", gp.gelu_poly_grad_reference)
    want, want_grads = step()
    assert_same_bits(got, want)
    assert grads.keys() == want_grads.keys()
    for name, g in grads.items():
        assert_same_bits(g, want_grads[name], name)
