"""Standalone vision encoders for the offline feature pipelines
(``mkg_analogy_tpu/models/vision_encoders.py``).

- ``VGG16Features``    truncated VGG16 (fc7, 4096-d) for the IKRL/TransAE
  per-entity averaged image embeddings (visual_embed.py:10-71, K8);
- ``ViTClassifier``    ViT-B/16 with a 1000-d classifier head for the RSME
  image vectors (RSME/image_encoder.py:79, R6);
- ``ResNet50Features`` ResNet50 pooled features (2048-d), the RSME
  image-encoder variant.

Public functions keep the JAX layout: ``(B, 3, H, W)`` in. Parameters are
named after the Flax trees (``conv_3.weight`` for ``conv_3/kernel``,
``stage1_block0.bn2.running_mean`` for the ``batch_stats`` leaf), so
``models/convert.py`` maps them mechanically. Randomly initialised encoders
exercise the whole pipeline; ``VGG16Features.state_dict_from_torchvision``
reads a torchvision ``vgg16`` state dict when a checkpoint file is at hand
(nothing is downloaded).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dense, EncoderLayer, LayerNorm, init_flax_defaults

VGG16_CONV_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                   512, 512, 512, "M", 512, 512, 512, "M"]


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``dtype`` from fp32 parameters with
    Flax ``nn.Conv``'s ``padding="SAME"``: the total padding of each spatial
    axis is what keeps ``ceil(extent / stride)`` outputs, its smaller half
    in front. With stride 1 that is symmetric; with stride 2 on an even
    extent it pads (0, 1), where ``nn.Conv2d(padding=1)`` pads (1, 1) and
    samples other pixels. ``padding`` may instead be explicit (front, back)
    pairs, or "VALID"."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding="SAME", bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, bias=bias)
        self.compute_dtype = dtype
        self.flax_padding = padding

    def _pads(self, extent: int, k: int, s: int):
        if self.flax_padding == "VALID":
            return 0, 0
        total = max((-(-extent // s) - 1) * s + k - extent, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if isinstance(self.flax_padding, str):
            top, bottom = self._pads(x.shape[2], self.kernel_size[0], self.stride[0])
            left, right = self._pads(x.shape[3], self.kernel_size[1], self.stride[1])
        else:
            (top, bottom), (left, right) = self.flax_padding
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, stride=self.stride)


class VGG16Features(nn.Module):
    """VGG16 through fc7: (B, 3, 224, 224) -> (B, 4096).

    The JAX module runs in NHWC and flattens the last feature map in
    (h, w, c) order ahead of fc6; so does this one (a permute before the
    reshape), so a converted Flax tree gives the same numbers."""

    def __init__(self, dtype: torch.dtype = torch.float32, image_size: int = 224):
        super().__init__()
        self.dtype = dtype
        channels, conv_i = 3, 0
        for spec in VGG16_CONV_PLAN:
            if spec != "M":
                self.add_module(f"conv_{conv_i}", Conv(channels, spec, 3, dtype=dtype))
                channels, conv_i = spec, conv_i + 1
        side = image_size // 32
        self.fc6 = Dense(side * side * 512, 4096, dtype=dtype)
        self.fc7 = Dense(4096, 4096, dtype=dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = pixel_values.to(self.dtype)
        conv_i = 0
        for spec in VGG16_CONV_PLAN:
            if spec == "M":
                x = F.max_pool2d(x, 2, stride=2)
            else:
                x = F.relu(getattr(self, f"conv_{conv_i}")(x))
                conv_i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (B, 7*7*512), (h, w, c)
        x = F.relu(self.fc6(x))
        return F.relu(self.fc7(x))

    def init_params(self, generator: torch.Generator) -> None:
        init_flax_defaults(self, generator)

    @staticmethod
    def state_dict_from_torchvision(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A torchvision ``vgg16`` state dict -> this module's. torchvision
        flattens its last feature map in (c, h, w) order, so the input axis
        of ``classifier.0.weight`` is permuted to this module's (h, w, c)
        order: the features are then torchvision's own fc7 activations."""
        out: Dict[str, torch.Tensor] = {}
        conv_keys = sorted({k.rsplit(".", 1)[0] for k in sd if k.startswith("features")},
                           key=lambda s: int(s.split(".")[1]))
        for i, tk in enumerate(conv_keys):
            out[f"conv_{i}.weight"] = torch.as_tensor(sd[f"{tk}.weight"]).float()
            out[f"conv_{i}.bias"] = torch.as_tensor(sd[f"{tk}.bias"]).float()
        w6 = torch.as_tensor(sd["classifier.0.weight"]).float()  # (4096, 512*s*s)
        side = int(round((w6.shape[1] // 512) ** 0.5))
        out["fc6.weight"] = (w6.reshape(-1, 512, side, side).permute(0, 2, 3, 1)
                             .reshape(w6.shape[0], -1).contiguous())
        out["fc6.bias"] = torch.as_tensor(sd["classifier.0.bias"]).float()
        out["fc7.weight"] = torch.as_tensor(sd["classifier.3.weight"]).float()
        out["fc7.bias"] = torch.as_tensor(sd["classifier.3.bias"]).float()
        return out


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_classes: int = 1000
    layer_norm_eps: float = 1e-6


class ViTClassifier(nn.Module):
    """ViT-B/16 with classification head: (B, 3, 224, 224) -> (B, 1000).
    197 tokens an image through pre-LN ``EncoderLayer``s without dropout;
    ``attention`` picks their attention backend (models/common.py)."""

    def __init__(self, cfg: ViTConfig = ViTConfig(), dtype: torch.dtype = torch.float32,
                 attention: str = "single", gelu_impl: str = "poly"):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embedding = Conv(3, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(torch.empty(n + 1, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, hidden_act="gelu",
                layer_norm_eps=cfg.layer_norm_eps, dtype=dtype, pre_norm=True,
                hidden_dropout=0.0, attention_dropout=0.0, backend=attention,
                gelu_impl=gelu_impl))
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype)
        self.head = Dense(cfg.hidden_size, cfg.num_classes, dtype=dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(self.dtype).expand(b, 1, cfg.hidden_size)
        tokens = torch.cat([cls, patches], dim=1)
        tokens = tokens + self.position_embeddings[None].to(self.dtype)
        for i in range(cfg.num_layers):
            tokens = getattr(self, f"layer_{i}")(tokens)
        tokens = self.final_ln(tokens)
        return self.head(tokens[:, 0])

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Flax's initializers: the CLS token zero, positions normal(0.02)."""
        init_flax_defaults(self, generator)
        self.cls_token.zero_()
        self.position_embeddings.normal_(0.0, 0.02, generator=generator)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's defaults (epsilon 1e-5, momentum 0.99:
    PyTorch's 0.01), statistics and affine map in fp32, output in
    ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5, momentum=0.01)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.float32)).to(self.compute_dtype)


class _Bottleneck(nn.Module):
    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(in_features, features, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(features, dtype)
        self.conv2 = Conv(features, features, 3, stride=strides, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(features, dtype)
        self.conv3 = Conv(features, features * 4, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm(features * 4, dtype)
        # the JAX block projects the residual wherever its shape differs
        if strides != 1 or in_features != features * 4:
            self.downsample_conv = Conv(in_features, features * 4, 1, stride=strides,
                                        bias=False, dtype=dtype)
            self.downsample_bn = BatchNorm(features * 4, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + y)


class ResNet50Features(nn.Module):
    """ResNet50 pooled features (2048-d): the RSME image-encoder variant
    (RSME/image_encoder.py Resnet50 branch, R6). ``num_classes`` 0 gives
    the pooled features, else classifier logits. BatchNorm follows the
    module's mode: ``eval()`` uses the running statistics (the JAX
    ``train=False``)."""

    PLAN = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]

    def __init__(self, dtype: torch.dtype = torch.float32, num_classes: int = 0):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(3, 64, 7, stride=2, padding=((3, 3), (3, 3)), bias=False,
                         dtype=dtype)
        self.stem_bn = BatchNorm(64, dtype)
        channels = 64
        for si, (feats, blocks, stride) in enumerate(self.PLAN):
            for bi in range(blocks):
                self.add_module(f"stage{si}_block{bi}", _Bottleneck(
                    channels, feats, strides=stride if bi == 0 else 1, dtype=dtype))
                channels = feats * 4
        if num_classes:
            self.head = Dense(channels, num_classes, dtype=dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem(pixel_values.to(self.dtype))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for si, (_, blocks, _) in enumerate(self.PLAN):
            for bi in range(blocks):
                x = getattr(self, f"stage{si}_block{bi}")(x)
        x = x.mean(dim=(2, 3))  # global average pool -> (B, 2048)
        return self.head(x) if hasattr(self, "head") else x

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Flax's initializers; each block's last BatchNorm scale starts at
        zero, so a block starts as the identity on its residual."""
        init_flax_defaults(self, generator)
        for module in self.modules():
            if isinstance(module, _Bottleneck):
                module.bn3.weight.zero_()
