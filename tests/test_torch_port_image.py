"""Port parity for the image path, against the JAX package on the same numpy
inputs: the plain version of the resize-and-normalise kernel against the XLA
twin, the Pallas kernel in interpret mode and ``F.interpolate``; the numpy
copies of data/phash, data/gates and data/openke_tools against the
originals; and the port's image tool against ``tools/encode_images.py`` on a
small tree of PNG files. The CUDA kernel itself is held to the plain version
by the ``cuda``-marked tests (they skip without a card) and by
``chip_smoke.py``."""

import importlib.util
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mkg_analogy_tpu.data import gates as jgates
from mkg_analogy_tpu.data import openke_tools as jopenke
from mkg_analogy_tpu.data import phash as jphash
from mkg_analogy_tpu.kernels import image_prep as jprep
from mkg_analogy_tpu_torch.data import gates, openke_tools, phash
from mkg_analogy_tpu_torch.kernels import image_prep
from mkg_analogy_tpu_torch.models import vision_encoders
from mkg_analogy_tpu_torch.models.convert import params_from_jax
from mkg_analogy_tpu_torch.tools import encode_images as tool

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# fp32 on both sides; a source coordinate within an ulp of an integer may
# floor to the neighbouring pixel, where the result is continuous: the bar
# of tests/test_image_pipeline.py:45,59
ATOL = 1e-5


def make_canvases(sizes, canvas=64, seed=0, outside=0):
    """uint8 canvases with random pixels inside each (h, w) extent and
    ``outside`` everywhere else."""
    rng = np.random.default_rng(seed)
    out = np.full((len(sizes), canvas, canvas, 3), outside, np.uint8)
    for i, (h, w) in enumerate(sizes):
        out[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return out, np.asarray(sizes, np.int32)


def exact_resize(canvas, sizes, out_size=224, mean=image_prep.CLIP_MEAN,
                 std=image_prep.CLIP_STD):
    """The same function in float64, pixel by pixel."""
    out = np.zeros((len(sizes), 3, out_size, out_size))

    def matrix(size):
        src = np.clip((np.arange(out_size) + 0.5) * (size / out_size) - 0.5, 0, size - 1)
        lo = np.floor(src).astype(int)
        w = np.zeros((out_size, canvas.shape[1]))
        for o, (l, f) in enumerate(zip(lo, src - lo)):
            w[o, l] = 1.0 if l + 1 >= size else 1.0 - f
            if l + 1 < size:
                w[o, l + 1] = f
        return w

    for b, (h, w) in enumerate(sizes):
        x = canvas[b].astype(np.float64) / 255.0
        r = np.einsum("pw,owk->opk", matrix(w), np.einsum("oc,cwk->owk", matrix(h), x))
        out[b] = ((r - np.asarray(mean)) / np.asarray(std)).transpose(2, 0, 1)
    return out


def port_resize(canvas, sizes, **kw):
    return image_prep.resize_normalize_reference(
        torch.from_numpy(canvas), torch.from_numpy(sizes), **kw).numpy()


# the shapes of tests/test_image_pipeline.py:29-59, then the edges: the
# full canvas, 1 x 1, one row, one column, smaller than the output
# (upscaling), non-square
CASES = {
    "pipeline_test": dict(sizes=[(64, 64), (20, 60), (33, 7)], out_size=32),
    "torch_bilinear": dict(sizes=[(40, 50)], out_size=32),
    "edges": dict(sizes=[(64, 64), (1, 1), (1, 64), (64, 1), (5, 9), (63, 2)], out_size=32),
    "upscale": dict(sizes=[(10, 12), (3, 40), (48, 48)], out_size=48),
    "vilt_stats": dict(sizes=[(64, 30), (17, 64)], out_size=24,
                       mean=image_prep.VILT_MEAN, std=image_prep.VILT_STD),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("outside", [0, 255])
def test_plain_resize_matches_jax_xla_and_pallas(case, outside):
    """The plain version against ``resize_normalize`` and against the Pallas
    kernel in interpret mode. With 255 outside the extent the result must
    not move: nothing outside (h, w) carries weight."""
    kw = dict(CASES[case])
    canvas, sizes = make_canvases(kw.pop("sizes"), outside=outside)
    got = port_resize(canvas, sizes, **kw)
    want = np.asarray(jprep.resize_normalize(jnp.asarray(canvas), jnp.asarray(sizes), **kw))
    assert got.shape == want.shape == (len(sizes), 3, kw["out_size"], kw["out_size"])
    np.testing.assert_allclose(got, want, atol=ATOL)
    pallas = np.asarray(jprep.resize_normalize_pallas(
        jnp.asarray(canvas), jnp.asarray(sizes), interpret=True, **kw))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, exact_resize(canvas, sizes, **kw), atol=ATOL)
    if outside:
        inside, _ = make_canvases(CASES[case]["sizes"], outside=0)
        np.testing.assert_array_equal(got, port_resize(inside, sizes, **kw))


@pytest.mark.parametrize("out_size", [224, 384])
def test_plain_resize_matches_jax_on_the_full_canvas(out_size):
    """At the tool's canvas of 512 px and extents at or near it, against
    ``resize_normalize`` as XLA compiles it: XLA multiplies by the fp32
    reciprocal of a constant divisor and fuses ``(dst + 0.5) * scale - 0.5``
    into one multiply-add, and at source coordinates near 511 one ulp of the
    coordinate moves a noisy image by more than the bar, so this holds the
    plain version to the same roundings."""
    canvas, sizes = make_canvases([(512, 512), (511, 509), (500, 3), (2, 512)],
                                  canvas=image_prep.CANVAS, seed=out_size, outside=255)
    got = port_resize(canvas, sizes, out_size=out_size)
    want = np.asarray(jprep.resize_normalize(jnp.asarray(canvas), jnp.asarray(sizes),
                                             out_size=out_size))
    assert got.shape == want.shape == (4, 3, out_size, out_size)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_resize_matches_torch_bilinear():
    """As tests/test_image_pipeline.py:29: an image of the whole extent
    against ``F.interpolate`` (bilinear, align_corners=False)."""
    canvas, sizes = make_canvases([(40, 50)])
    got = port_resize(canvas, sizes, out_size=32, mean=(0, 0, 0), std=(1, 1, 1))
    img = torch.from_numpy(canvas[0, :40, :50].transpose(2, 0, 1)[None].astype(np.float32))
    ref = F.interpolate(img / 255.0, size=(32, 32), mode="bilinear",
                        align_corners=False, antialias=False).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_resize_wrapper_routes_by_device():
    """A CPU tensor takes the plain version (uint8 or float canvases) and
    counts no launch; the constants are the JAX module's."""
    canvas, sizes = make_canvases([(20, 30), (64, 64)])
    before = image_prep.LAUNCHES_RESIZE
    got = image_prep.resize_normalize(torch.from_numpy(canvas), torch.from_numpy(sizes), 16)
    assert image_prep.LAUNCHES_RESIZE == before
    np.testing.assert_array_equal(got.numpy(), port_resize(canvas, sizes, out_size=16))
    as_float = image_prep.resize_normalize(torch.from_numpy(canvas).float(),
                                           torch.from_numpy(sizes), 16)
    np.testing.assert_array_equal(as_float.numpy(), got.numpy())
    for name in ("CLIP_MEAN", "CLIP_STD", "VILT_MEAN", "VILT_STD", "CANVAS"):
        assert getattr(image_prep, name) == getattr(jprep, name)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the resize kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,out_size,stats", [(64, 224, "clip"), (64, 384, "vilt"),
                                                  (1, 224, "clip"), (7, 32, "clip")])
def test_cuda_resize_kernel_matches_plain(batch, out_size, stats):
    """The kernel against the plain version on the card at the tool's
    shapes, mixed extents, 255 outside every second extent: 1e-5."""
    device = _card()
    rng = np.random.default_rng(batch + out_size)
    sizes = [(int(h), int(w)) for h, w in rng.integers(1, 513, (batch, 2))]
    sizes[0] = (512, 512)
    for i, s in enumerate([(1, 1), (1, 512), (512, 1), (100, 37), (300, 511)]):
        if i + 1 < batch:
            sizes[i + 1] = s
    canvas, sizes = make_canvases(sizes, canvas=512, outside=0)
    canvas[1::2][canvas[1::2] == 0] = 255
    mean, std = ((image_prep.CLIP_MEAN, image_prep.CLIP_STD) if stats == "clip"
                 else (image_prep.VILT_MEAN, image_prep.VILT_STD))
    c, s = torch.from_numpy(canvas).to(device), torch.from_numpy(sizes).to(device)
    before = image_prep.LAUNCHES_RESIZE
    got = image_prep.resize_normalize(c, s, out_size, mean, std)
    want = image_prep.resize_normalize_reference(c, s, out_size, mean, std)
    torch.cuda.synchronize()
    assert image_prep.LAUNCHES_RESIZE == before + 1
    assert got.shape == (batch, 3, out_size, out_size) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.cuda
def test_cuda_resize_kernel_refuses_what_it_does_not_take():
    device = _card()
    canvas, sizes = make_canvases([(20, 30)], canvas=512)
    c, s = torch.from_numpy(canvas).to(device), torch.from_numpy(sizes).to(device)
    with pytest.raises(ValueError, match="resize_normalize_reference"):
        image_prep.resize_normalize(c.float(), s)
    with pytest.raises(ValueError, match="int32"):
        image_prep.resize_normalize(c, s.long())
    with pytest.raises(ValueError, match="sizes"):
        image_prep.resize_normalize(c, s.cpu())


# ---------------------------------------------------------------- numpy copies
def test_phash_copy_matches_original():
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (40, 57, 3)).astype(np.uint8) for _ in range(5)]
    grays = [phash.to_gray32(im) for im in imgs]
    for g, im in zip(grays, imgs):
        np.testing.assert_array_equal(g, jphash.to_gray32(im))
        np.testing.assert_array_equal(phash.phash(g), jphash.phash(g))
    assert phash.hamming(phash.phash(grays[0]), phash.phash(grays[1])) == \
        jphash.hamming(jphash.phash(grays[0]), jphash.phash(grays[1]))
    assert phash.best_image_index(grays) == jphash.best_image_index(grays)
    per_entity = {"Q1": grays[:3], "Q2": grays[3:]}
    assert phash.select_best_images(per_entity) == jphash.select_best_images(per_entity)


def test_gates_copy_matches_original():
    rng = np.random.default_rng(5)
    n_ent, n_rel = 20, 4
    img = rng.standard_normal((n_ent, 8)).astype(np.float32)
    trips = np.stack([rng.integers(0, n_ent, 30), rng.integers(0, n_rel, 30),
                      rng.integers(0, n_ent, 30)], 1)
    np.testing.assert_array_equal(gates.image_only_ranks(trips, img),
                                  jgates.image_only_ranks(trips, img))
    for got, want in zip(gates.build_gates(trips, img, n_rel),
                         jgates.build_gates(trips, img, n_rel)):
        np.testing.assert_array_equal(got, want)
    mrp = gates.calculate_mrp(trips, img, n_rel)
    np.testing.assert_array_equal(gates.mrp_to_sigmoid_alpha(mrp),
                                  jgates.mrp_to_sigmoid_alpha(mrp))
    np.testing.assert_array_equal(gates.mrp_to_forget_gate(mrp, remember_rate=25),
                                  jgates.mrp_to_forget_gate(mrp, remember_rate=25))


def test_openke_copy_matches_original(tmp_path):
    from mkg_analogy_tpu_torch.data.readers import MARS, MarKG
    from tests.util import build_tiny

    jmarkg, jmars, _ = build_tiny(str(tmp_path / "kg"))
    markg = MarKG(str(tmp_path / "kg" / "MarKG"))
    mars = MARS(str(tmp_path / "kg" / "MARS"), markg)
    triples = jmarkg.triples_as_ids()
    n = len(triples)
    splits = {"train": triples[: n - 6], "valid": triples[n - 6: n - 3],
              "test": triples[n - 3:]}
    as_htr = [(h, t, r) for h, r, t in triples]
    for mod, kg, an, out in ((jopenke, jmarkg, jmars, tmp_path / "jax"),
                             (openke_tools, markg, mars, tmp_path / "port")):
        mod.write_id_files(str(out), kg, an, splits=splits)
        mod.write_type_constraints(str(out), as_htr)
        assert len(mod.write_category_splits(str(out), as_htr[: n - 3], as_htr[n - 3:])) == 4
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) >= 10
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert openke_tools.relation_categories(as_htr) == jopenke.relation_categories(as_htr)


# --------------------------------------------------------------------- the tool
def _jax_tool():
    """tools/encode_images.py of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location("jax_encode_images",
                                                  ROOT / "tools" / "encode_images.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """A MarKG of 16 entities, 11 of them with 1-4 PNG images of different
    sizes (one wider than the canvas, one a single pixel row)."""
    from PIL import Image

    from tests.util import make_tiny_dataset

    root = tmp_path_factory.mktemp("image_tree")
    markg_dir, _ = make_tiny_dataset(str(root))
    rng = np.random.default_rng(11)
    images = root / "images"
    for i in range(11):
        d = images / f"Q{i}"
        d.mkdir(parents=True)
        for j in range(1 + i % 4):
            h, w = (int(x) for x in rng.integers(8, 120, 2))
            if (i, j) == (3, 0):
                h, w = 90, 700   # wider than the canvas: downscaled on the host
            if (i, j) == (5, 1):
                h, w = 1, 33
            base = rng.integers(0, 256, (1, 1, 3)) if j else 128
            arr = np.clip(base + rng.integers(-60, 60, (h, w, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"img{j}.png")
        (d / "notes.txt").write_text("not an image")
    return str(images), markg_dir


def _run_tool(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["encode_images.py"] + argv)
    mod.main()


@pytest.mark.parametrize("size,stats", [(32, "clip"), (48, "vilt")])
def test_tool_pixels_store_matches_jax(image_tree, tmp_path, monkeypatch, size, stats):
    """``--mode pixels``: the same files chosen (numpy's default_rng(seed)),
    the store within 1e-5, zero rows for entities without images, and
    ``data/images.open_store`` reads it."""
    from mkg_analogy_tpu_torch.data.images import open_store

    images, markg_dir = image_tree
    argv = ["--images_dir", images, "--markg", markg_dir, "--mode", "pixels",
            "--size", str(size), "--stats", stats, "--seed", "3"]
    _run_tool(_jax_tool(), argv + ["--out", str(tmp_path / "jax.npy")], monkeypatch)
    store = tool.main(argv + ["--out", str(tmp_path / "port.npy"), "--device", "cpu"])
    want, got = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "port.npy")
    assert got.shape == want.shape == (16, 3, size, size) and got.dtype == np.float32
    np.testing.assert_array_equal(got, store)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert not got[11:].any() and all(got[i].any() for i in range(11))
    opened = open_store(str(tmp_path / "port.npy"), 16, size)
    np.testing.assert_array_equal(
        opened.gather(np.array([2, -1]), np.array([12, 0]))[0, 0], got[2])


def test_tool_choice_of_files_matches_jax(image_tree):
    """The listing (sorted, image extensions only) and the decode (RGB,
    downscaled only above the canvas) are the JAX tool's."""
    images, _ = image_tree
    jtool = _jax_tool()
    ents = [f"Q{i}" for i in range(16)]
    files = tool.list_entity_images(images, ents)
    assert files == jtool.list_entity_images(images, ents)
    assert len(files) == 11 and all(f.endswith(".png") for fs in files.values() for f in fs)
    for path in (files["Q3"][0], files["Q5"][1], files["Q0"][0]):
        (got, got_size), (want, want_size) = (tool.decode_to_canvas(path),
                                              jtool.decode_to_canvas(path))
        assert got_size == want_size
        np.testing.assert_array_equal(got, want)
    assert tool.decode_to_canvas(files["Q3"][0])[1] == (65, 512)
    assert tool.decode_to_canvas(files["Q5"][1])[1] == (1, 33)


def test_tool_cuda_without_gpu_raises(image_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    images, markg_dir = image_tree
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--images_dir", images, "--markg", markg_dir, "--out",
                   str(tmp_path / "x.npy")])


def _decoded_items(image_tree, first=None, entities=4):
    images, markg_dir = image_tree
    ents = [f"Q{i}" for i in range(entities)]
    files = tool.list_entity_images(images, ents)
    return [(int(e[1:]), [tool.decode_to_canvas(p) for p in fs[:first]])
            for e, fs in files.items()]


def test_tool_vgg_store_matches_jax(image_tree):
    """``--mode vgg`` below the decode, 4 entities (10 images): the Flax
    VGG16 (random init) and the port's on the converted tree, every image
    of an entity through the encoder and averaged, as the JAX tool does.
    Bar: 1e-4 of the store's largest value (13 fp32 convolutions and two
    4096-wide products, summed in other orders)."""
    from mkg_analogy_tpu.models.vision_encoders import VGG16Features as FlaxVGG

    items = _decoded_items(image_tree)
    flax_model = FlaxVGG()
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 224, 224), jnp.float32)))
    model = vision_encoders.VGG16Features().eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    got = tool.vgg_store(items, 16, model, device="cpu")

    apply = jax.jit(lambda px: flax_model.apply(params, px))
    want = np.zeros((17, 4096), np.float32)
    for eid, decoded in items:
        px = np.asarray(jprep.resize_normalize(
            jnp.asarray(np.stack([c for c, _ in decoded])),
            jnp.asarray(np.asarray([s for _, s in decoded], np.int32)),
            out_size=224, mean=tool.IMAGENET_MEAN, std=tool.IMAGENET_STD))
        want[eid] = np.asarray(apply(px)).mean(axis=0)
    assert got.shape == (17, 4096) and not got[4:].any() and got[:4].any(axis=1).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_tool_vit_store_matches_jax(image_tree):
    """``--mode vit`` below the decode at a small ViT (2 layers, width 32,
    224-px input, 10 classes padded into the 1000-wide store by the test):
    the same best image per entity (pHash), its logits within 1e-4 of the
    largest."""
    from mkg_analogy_tpu.models.vision_encoders import ViTClassifier as FlaxViT
    from mkg_analogy_tpu.models.vision_encoders import ViTConfig as FlaxViTConfig

    items = _decoded_items(image_tree, first=8, entities=8)
    kw = dict(image_size=224, patch_size=32, hidden_size=32, num_layers=2, num_heads=2,
              intermediate_size=64, num_classes=1000)
    flax_model = FlaxViT(FlaxViTConfig(**kw))
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 224, 224), jnp.float32)))
    # the Flax CLS token starts at zero: make it count
    params["params"]["cls_token"] = np.random.default_rng(0).standard_normal(
        (1, 1, 32)).astype(np.float32)
    model = vision_encoders.ViTClassifier(vision_encoders.ViTConfig(**kw)).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    got = tool.vit_store(items, 16, model, image_prep.CLIP_MEAN, image_prep.CLIP_STD,
                         device="cpu")

    apply = jax.jit(lambda px: flax_model.apply(params, px))
    want = np.zeros((16, 1000), np.float32)
    for eid, decoded in items:
        best = jphash.best_image_index([jphash.to_gray32(c[:h, :w]) for c, (h, w) in decoded])
        canvas, size = decoded[best]
        px = jprep.resize_normalize(jnp.asarray(canvas[None]),
                                    jnp.asarray(np.asarray([size], np.int32)), out_size=224)
        want[eid] = np.asarray(apply(px))[0]
    assert got.shape == (16, 1000) and not got[8:].any()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
