"""The benchmark's seeded weights and pixel table, made on the device.

One ``torch.randn`` over every leaf and one ``torch.rand`` for the uniform
ones, from a generator on the device seeded by the run's seed; then each
leaf takes the first rule of the configuration's ``init`` that its name
matches (a regular expression): ``{"normal": std}`` scales its slice of the
normal draw, ``"uniform_0_0.5"`` takes U(0, 0.5) (MarT's w0), a number fills
it. The same seed gives the same weights, so the reference makes them again
after the program's run.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch

PIXEL_SEED_OFFSET = 0x51F15EED  # the pixel table's stream, apart from the weights'


def _rule(init, name):
    for pattern, value in init:
        if re.search(pattern, name):
            return value
    raise ValueError(f"no init rule matches {name!r}")


def make_params(shapes: Dict[str, tuple], init, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    rules = {n: _rule(init, n) for n in shapes}
    uniform_names = [n for n, r in rules.items() if r == "uniform_0_0.5"]
    uniform = torch.rand(len(uniform_names), generator=gen, device=device) * 0.5
    params, off = {}, 0
    with torch.no_grad():
        for name, shape in shapes.items():
            t = flat[off:off + math.prod(shape)].view(shape)
            off += t.numel()
            rule = rules[name]
            if isinstance(rule, dict):
                t.mul_(rule["normal"])
            elif rule == "uniform_0_0.5":
                t.copy_(uniform[uniform_names.index(name)])
            else:
                t.fill_(float(rule))
            params[name] = t
    return params


def make_pixel_table(entities: int, size: int, seed: int, device) -> torch.Tensor:
    """(entities + 1, 3, size, size) bf16 normalised pixels, one image an
    entity, the last row the zero pad row of the missing image slots."""
    gen = torch.Generator(device=device).manual_seed(seed ^ PIXEL_SEED_OFFSET)
    table = torch.randn(entities + 1, 3, size, size, generator=gen, device=device,
                        dtype=torch.bfloat16)
    table[-1].zero_()
    return table
