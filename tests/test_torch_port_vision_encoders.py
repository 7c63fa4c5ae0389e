"""Port parity for models/vision_encoders.py: VGG16Features, ViTClassifier
and ResNet50Features against the Flax modules on the same weights (a Flax
init carried over by models/convert.params_from_jax) and the same numpy
pixels, in fp32 on the CPU. Bar: 2e-4 of the output's largest value
(COMPONENTS.md M5's model bar; stacks of fp32 convolutions and matrix
products summed in other orders). The two layout traps each have a test that
the naive version fails: Flax's one-sided ``SAME`` padding at stride 2, and
the (h, w, c) order of VGG16's flatten ahead of fc6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from mkg_analogy_tpu.models import vision_encoders as jve
from mkg_analogy_tpu_torch.models import vision_encoders as ve
from mkg_analogy_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

RTOL_OF_MAX = 2e-4


def assert_close(got, want, what=""):
    want = np.asarray(want)
    top = float(np.abs(want).max())
    assert top > 0.0, what
    np.testing.assert_allclose(np.asarray(got), want, atol=RTOL_OF_MAX * top, rtol=0,
                               err_msg=what)


def pixels(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def flax_init(model, shape, seed=0, **kw):
    return jax.device_get(jax.jit(lambda key, x: model.init(key, x, **kw))(
        jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32)))


@pytest.fixture(scope="module")
def vgg_pair():
    """VGG16 at 64 px: 2 x 2 x 512 ahead of fc6, so the flatten order
    shows (at 32 px it is 1 x 1 and cannot)."""
    flax_model = jve.VGG16Features()
    params = flax_init(flax_model, (1, 3, 64, 64))
    model = ve.VGG16Features(image_size=64).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return flax_model, params, model


def test_vgg16_matches_flax(vgg_pair):
    flax_model, params, model = vgg_pair
    px = pixels((3, 3, 64, 64), 1)
    want = np.asarray(flax_model.apply(params, jnp.asarray(px)))
    with torch.inference_mode():
        got = model(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (3, 4096)
    assert_close(got, want)
    sd = params_from_jax(params)
    assert sd["conv_0.weight"].shape == (64, 3, 3, 3)
    assert sd["fc6.weight"].shape == (4096, 2 * 2 * 512)


def test_vgg16_flatten_order_is_h_w_c(vgg_pair):
    """The naive NCHW flatten (c, h, w) on the same converted weights is far
    off: fc6's input axis is in the Flax module's (h, w, c) order."""
    flax_model, params, model = vgg_pair
    px = pixels((2, 3, 64, 64), 2)
    want = np.asarray(flax_model.apply(params, jnp.asarray(px)))
    with torch.inference_mode():
        x = torch.from_numpy(px)
        conv_i = 0
        for spec in ve.VGG16_CONV_PLAN:
            if spec == "M":
                x = F.max_pool2d(x, 2, stride=2)
            else:
                x = F.relu(getattr(model, f"conv_{conv_i}")(x))
                conv_i += 1
        naive = F.relu(model.fc7(F.relu(model.fc6(x.reshape(2, -1))))).numpy()
    assert np.abs(naive - want).max() > 0.05 * np.abs(want).max()


def test_vgg16_torchvision_state_dict_gives_torchvision_features():
    """A state dict in torchvision's vgg16 layout (features.N conv weights,
    classifier.0 over a (c, h, w) flatten, classifier.3), random values, at
    64 px: ``state_dict_from_torchvision`` loads it so that the port computes
    what torchvision's own forward computes (written out here with
    torch.nn.functional). The JAX package's
    ``VGG16Features.params_from_torch_state_dict`` gives fc6 the plain
    transpose, which pairs (c, h, w) weights with an (h, w, c) flatten: its
    output is far from torchvision's."""
    rng = np.random.default_rng(3)
    sd, channels = {}, 3
    idx, conv_names = 0, []
    for spec in ve.VGG16_CONV_PLAN:
        if spec == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal((spec, channels, 3, 3)) * (2.0 / (9 * channels)) ** 0.5
             ).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.standard_normal(spec) * 0.1).astype(np.float32))
        conv_names.append(idx)
        channels, idx = spec, idx + 2
    for name, (o, i) in (("classifier.0", (4096, 2 * 2 * 512)), ("classifier.3", (4096, 4096))):
        sd[f"{name}.weight"] = torch.from_numpy(
            (rng.standard_normal((o, i)) * (2.0 / i) ** 0.5).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy((rng.standard_normal(o) * 0.1).astype(np.float32))
    px = pixels((2, 3, 64, 64), 4)

    with torch.inference_mode():
        x = torch.from_numpy(px)
        convs = iter(conv_names)
        for spec in ve.VGG16_CONV_PLAN:
            if spec == "M":
                x = F.max_pool2d(x, 2, stride=2)
            else:
                n = next(convs)
                x = F.relu(F.conv2d(x, sd[f"features.{n}.weight"], sd[f"features.{n}.bias"],
                                    padding=1))
        x = torch.flatten(x, 1)  # torchvision: (c, h, w)
        x = F.relu(F.linear(x, sd["classifier.0.weight"], sd["classifier.0.bias"]))
        want = F.relu(F.linear(x, sd["classifier.3.weight"], sd["classifier.3.bias"])).numpy()

        model = ve.VGG16Features(image_size=64).eval()
        model.load_state_dict(ve.VGG16Features.state_dict_from_torchvision(sd), strict=True)
        got = model(torch.from_numpy(px)).numpy()
    assert_close(got, want)

    jparams = {"params": jve.VGG16Features.params_from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})}
    jax_out = np.asarray(jve.VGG16Features().apply(jparams, jnp.asarray(px)))
    assert np.abs(jax_out - want).max() > 0.05 * np.abs(want).max()


def test_vit_classifier_matches_flax():
    """The small config of tests/test_image_pipeline.py:157, a non-zero CLS
    token, pre-LN layers with eps 1e-6."""
    kw = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=2,
              intermediate_size=64, num_classes=10)
    flax_model = jve.ViTClassifier(jve.ViTConfig(**kw))
    params = flax_init(flax_model, (2, 3, 32, 32))
    params["params"]["cls_token"] = pixels((1, 1, 32), 5)
    model = ve.ViTClassifier(ve.ViTConfig(**kw)).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    assert model.final_ln.eps == 1e-6 and model.layer_0.pre_norm
    px = pixels((2, 3, 32, 32), 6)
    want = np.asarray(flax_model.apply(params, jnp.asarray(px)))
    with torch.inference_mode():
        got = model(torch.from_numpy(px)).numpy()
    assert got.shape == (2, 10)
    assert_close(got, want)


def test_vit_full_width_names_and_shapes():
    """ViT-B/16 as the tool builds it: 197 tokens, the Flax tree's names."""
    with torch.device("meta"):
        model = ve.ViTClassifier()
    sd = model.state_dict()
    assert sd["position_embeddings"].shape == (197, 768)
    assert sd["patch_embedding.weight"].shape == (768, 3, 16, 16)
    assert sd["layer_11.attn.query.weight"].shape == (768, 768)
    assert sd["head.weight"].shape == (1000, 768)
    assert len([k for k in sd if k.startswith("layer_")]) == 12 * 16


def test_same_padding_at_stride_2_is_one_sided():
    """Flax ``padding="SAME"`` with a 3 x 3 kernel, stride 2, on an even
    extent pads (0, 1); ``nn.Conv2d(padding=1)`` pads (1, 1) and is far off.
    On an odd extent both pad (1, 1)."""
    conv = fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    for extent in (8, 9):
        x = pixels((2, 4, extent, extent), 7)
        params = jax.device_get(conv.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, extent, extent, 4))))
        want = np.asarray(conv.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)))
                          ).transpose(0, 3, 1, 2)
        port = ve.Conv(4, 5, 3, stride=2, bias=False)
        port.load_state_dict(params_from_jax(params), strict=True)
        with torch.inference_mode():
            got = port(torch.from_numpy(x)).numpy()
            naive = F.conv2d(torch.from_numpy(x), port.weight, stride=2, padding=1).numpy()
        assert got.shape == want.shape == (2, 5, (extent + 1) // 2, (extent + 1) // 2)
        np.testing.assert_allclose(got, want, atol=1e-5)
        if extent % 2 == 0:
            assert np.abs(naive - want).max() > 0.1
        else:
            np.testing.assert_allclose(naive, want, atol=1e-5)


@pytest.mark.parametrize("num_classes", [0, 7])
def test_resnet50_matches_flax(num_classes):
    """ResNet50 at 64 px in evaluation mode with non-trivial running
    statistics, BatchNorm scales and biases (every bn3 scale starts at zero,
    which would hide the blocks), drawn with numpy into the Flax tree."""
    flax_model = jve.ResNet50Features(num_classes=num_classes)
    variables = flax_init(flax_model, (1, 3, 64, 64))
    rng = np.random.default_rng(8)

    def redraw(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                redraw(value)
            elif key == "var":
                tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
            elif key == "scale":
                tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
            elif key in ("mean", "bias"):
                tree[key] = (rng.standard_normal(value.shape) * 0.1).astype(np.float32)

    redraw(variables["batch_stats"])
    redraw({k: v for k, v in variables["params"].items()})
    model = ve.ResNet50Features(num_classes=num_classes).eval()
    missing, unexpected = model.load_state_dict(params_from_jax(variables), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    assert model.stem_bn.eps == 1e-5
    px = pixels((2, 3, 64, 64), 9)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(px), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, num_classes or 2048)
    assert_close(got, want)


def test_encoder_init_params_follow_flax():
    """Seeded random weights: lecun-normal kernels (variance 1/fan_in), zero
    biases, the ViT's CLS token zero, each ResNet block's last BatchNorm
    scale zero, running statistics (0, 1)."""
    gen = torch.Generator().manual_seed(0)
    vit = ve.ViTClassifier(ve.ViTConfig(image_size=32, patch_size=16, hidden_size=64,
                                        num_layers=1, num_heads=2, intermediate_size=128,
                                        num_classes=10))
    vit.init_params(gen)
    assert not vit.cls_token.any() and vit.position_embeddings.std().item() < 0.03
    w = vit.layer_0.fc1.weight
    assert abs(w.var().item() * 64 - 1.0) < 0.1 and not vit.layer_0.fc1.bias.any()
    resnet = ve.ResNet50Features()
    resnet.init_params(gen)
    assert not resnet.stage0_block0.bn3.weight.any()
    assert (resnet.stage0_block0.bn1.weight == 1).all()
    assert (resnet.stem_bn.running_var == 1).all() and not resnet.stem_bn.running_mean.any()
    again = ve.ResNet50Features()
    again.init_params(torch.Generator().manual_seed(0))
    other = ve.ResNet50Features()
    other.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(again.stem.weight, other.stem.weight)
