"""Offline image pre-encoding: entity image folders -> feature caches
(``tools/encode_images.py`` of the JAX package).

One device-batched tool replaces three reference pipelines (host decode ->
fixed canvas -> resize/normalise kernel -> encoder):

- ``--mode pixels``  one random image per entity -> (E, 3, S, S) pixel store
  (MarT tools/encode_images_data.py:15-43; S=224 CLIP stats, S=384 ViLT);
- ``--mode vgg``     all images per entity -> VGG16 fc7 -> mean ->
  (E + 1, 4096) store (IKRL/TransAE visual_embed.py:10-71);
- ``--mode vit``     pHash-selected best of the first 8 images -> ViT-B/16
  1000-d -> (E, 1000) store, which the MRP gates of data/gates.py read
  (RSME filter_gate.py / image_encoder.py / MRP.py / utils.py).

Usage:
  python -m mkg_analogy_tpu_torch.tools.encode_images \\
      --images_dir dataset/MARS/images --markg dataset/MarKG \\
      --out entity_pixels.npy --mode pixels

It runs on CUDA unless ``--device cpu`` is given, and raises with ``cuda``
and no GPU. On CUDA the resize and normalisation of every image goes through
the hand-written kernel of ``kernels/image_prep.py``, and the ViT's
attention through the single-block attention kernel; on the CPU through
their plain versions. The encoders start from seeded random weights unless a
checkpoint file is given (``--vgg_ckpt``: a torchvision vgg16 state dict);
nothing is downloaded. The stores are written once and read by every later
run, so fp32 convolutions and matrix products run in full fp32 here: the
tool sets ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False.

The choice of images follows ``numpy.random.default_rng(--seed)`` exactly as
in the JAX tool, so both pick the same files. Below ``decode_to_canvas``
(the only user of PIL) each mode is a function of decoded canvases:
``pixels_store``, ``vgg_store`` and ``vit_store``.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from ..data.phash import best_image_index, to_gray32
from ..data.readers import MarKG
from ..kernels.image_prep import (
    CANVAS,
    CLIP_MEAN,
    CLIP_STD,
    VILT_MEAN,
    VILT_STD,
    resize_normalize,
)

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
BATCH = 64  # images per resize launch and per encoder forward

Decoded = Tuple[np.ndarray, Tuple[int, int]]  # (canvas (C, C, 3) uint8, (h, w))


def list_entity_images(images_dir: str, entities):
    out = {}
    for e in entities:
        d = os.path.join(images_dir, e)
        if not os.path.isdir(d):
            continue
        files = [
            os.path.join(d, f)
            for f in sorted(os.listdir(d))
            if f.lower().endswith(IMG_EXTS)
        ]
        if files:
            out[e] = files
    return out


def decode_to_canvas(path: str, canvas_size: int = CANVAS) -> Decoded:
    """PIL decode -> RGB array cropped/fit onto a fixed canvas; returns
    (canvas (S, S, 3) uint8, (h, w))."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        # downscale on host only when larger than the canvas
        if max(w, h) > canvas_size:
            scale = canvas_size / max(w, h)
            im = im.resize((max(1, int(w * scale)), max(1, int(h * scale))))
            w, h = im.size
        arr = np.asarray(im, np.uint8)
    canvas = np.zeros((canvas_size, canvas_size, 3), np.uint8)
    canvas[:h, :w] = arr
    return canvas, (h, w)


def canvases_to_pixels(decoded: Sequence[Decoded], out_size, mean, std,
                       device="cuda", batch=BATCH) -> np.ndarray:
    """Device-resize decoded canvases -> (N, 3, S, S) float32, ``batch`` a
    launch: the canvases cross to the device as uint8, ``resize_normalize``
    runs there, the result comes back as numpy."""
    outs = []
    for start in range(0, len(decoded), batch):
        chunk = decoded[start: start + batch]
        canvases = torch.from_numpy(np.stack([c for c, _ in chunk])).to(device)
        sizes = torch.from_numpy(np.asarray([s for _, s in chunk], np.int32)).to(device)
        out = resize_normalize(canvases, sizes, out_size=out_size, mean=mean, std=std)
        outs.append(out.cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros((0, 3, out_size, out_size), np.float32)


def batch_pixels(paths, out_size, mean, std, batch=BATCH, device="cuda") -> np.ndarray:
    """Decode + device-resize a list of image paths -> (N, 3, S, S)."""
    outs = [canvases_to_pixels([decode_to_canvas(p) for p in paths[start: start + batch]],
                               out_size, mean, std, device=device, batch=batch)
            for start in range(0, len(paths), batch)]
    return np.concatenate(outs) if outs else np.zeros((0, 3, out_size, out_size), np.float32)


def encode(model, pixels: np.ndarray, device, batch=BATCH) -> np.ndarray:
    """``model`` over (N, 3, S, S) pixels, ``batch`` a forward -> numpy."""
    with torch.inference_mode():
        outs = [model(torch.from_numpy(pixels[start: start + batch]).to(device)).cpu()
                for start in range(0, len(pixels), batch)]
    return torch.cat(outs).numpy()


def pixels_store(items: Iterable[Tuple[int, Decoded]], num_entities: int, size: int,
                 mean, std, device="cuda") -> np.ndarray:
    """``--mode pixels`` below the decode: (entity id, decoded image) pairs
    -> the (E, 3, S, S) store, zeros for entities without an image."""
    store = np.zeros((num_entities, 3, size, size), np.float32)
    ids: List[int] = []
    pending: List[Decoded] = []

    def flush():
        if pending:
            store[ids[-len(pending):]] = canvases_to_pixels(pending, size, mean, std,
                                                            device=device)
            pending.clear()

    for eid, decoded in items:
        ids.append(eid)
        pending.append(decoded)
        if len(pending) == BATCH:
            flush()
    flush()
    return store


def vgg_store(items: Iterable[Tuple[int, Sequence[Decoded]]], num_entities: int, model,
              device="cuda") -> np.ndarray:
    """``--mode vgg`` below the decode: (entity id, all its decoded images)
    pairs -> the (E + 1, 4096) store of mean fc7 features (ImageNet
    statistics at 224 px; the last row is the zero pad row)."""
    store = np.zeros((num_entities + 1, 4096), np.float32)
    for eid, decoded in items:
        px = canvases_to_pixels(decoded, 224, IMAGENET_MEAN, IMAGENET_STD, device=device)
        store[eid] = encode(model, px, device).mean(axis=0)
    return store


def vit_store(items: Iterable[Tuple[int, Sequence[Decoded]]], num_entities: int, model,
              mean, std, device="cuda") -> np.ndarray:
    """``--mode vit`` below the decode: (entity id, its first decoded
    images) pairs -> the (E, 1000) store of the ViT logits of each entity's
    pHash-selected best image."""
    store = np.zeros((num_entities, 1000), np.float32)
    for eid, decoded in items:
        best = best_image_index([to_gray32(c[:h, :w]) for c, (h, w) in decoded])
        px = canvases_to_pixels([decoded[best]], 224, mean, std, device=device)
        store[eid] = encode(model, px, device)[0]
    return store


def make_encoder(mode: str, device, seed: int = 0, vgg_ckpt=None):
    """The ``vgg`` or ``vit`` mode's encoder at full width in fp32 on
    ``device``, in evaluation mode: seeded random weights, or for VGG16 a
    torchvision state dict file."""
    from ..models.vision_encoders import VGG16Features, ViTClassifier

    with torch.device(device):
        model = VGG16Features() if mode == "vgg" else ViTClassifier()
    model.init_params(torch.Generator(device=device).manual_seed(seed))
    if mode == "vgg" and vgg_ckpt:
        sd = torch.load(vgg_ckpt, map_location="cpu")
        model.load_state_dict(VGG16Features.state_dict_from_torchvision(sd))
    return model.eval()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--markg", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", choices=["pixels", "vgg", "vit"], default="pixels")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--stats", choices=["clip", "vilt"], default="clip")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--vgg_ckpt", default=None, help="torch vgg16 .pth (optional)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None):
    from ..cli.main import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # the stores are written once and read by every later run: full fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    markg = MarKG(args.markg)
    entity_files = list_entity_images(args.images_dir, markg.entities)
    print(f"{len(entity_files)}/{markg.num_entities} entities have images")
    mean, std = (CLIP_MEAN, CLIP_STD) if args.stats == "clip" else (VILT_MEAN, VILT_STD)
    rng = np.random.default_rng(args.seed)
    n = markg.num_entities

    if args.mode == "pixels":
        chosen = {
            e: files[rng.integers(len(files))] for e, files in entity_files.items()
        }
        store = pixels_store(((markg.ent2id[e], decode_to_canvas(p))
                              for e, p in chosen.items()), n, args.size, mean, std, device)
    elif args.mode == "vgg":
        model = make_encoder("vgg", device, vgg_ckpt=args.vgg_ckpt)
        store = vgg_store(((markg.ent2id[e], [decode_to_canvas(p) for p in files])
                           for e, files in entity_files.items()), n, model, device)
    else:  # vit
        model = make_encoder("vit", device)
        store = vit_store(((markg.ent2id[e], [decode_to_canvas(p) for p in files[:8]])
                           for e, files in entity_files.items()), n, model, mean, std,
                          device)
    np.save(args.out, store)
    print(f"wrote {args.out}")
    return store


if __name__ == "__main__":
    main()
