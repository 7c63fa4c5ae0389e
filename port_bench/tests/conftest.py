"""Fixtures of the benchmark's CPU tests: a benchmark root at tiny widths.

Run them from the checkout's root: ``python -m pytest port_bench/tests``
(``-m cuda`` on a machine with a card for the tests marked so).
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_TEXT = dict(hidden_size=32, num_heads=2, intermediate_size=64, vocab_size=1024)
TINY_VOCAB = dict(entity_token_start=300, word_tokens=[10, 300], cls_id=1, sep_id=2,
                  mask_id=3, r_id=4)
TINY_ENTITIES = 600


def tiny_config(name: str) -> dict:
    cfg = json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())
    cfg.update(TINY_TEXT, analogy_entities=TINY_ENTITIES)
    cfg["vocab"] = {**cfg["vocab"], **TINY_VOCAB}
    if cfg["model_class"] == "MKGformerKGC":
        # the registry puts the fusion at the last four layers
        cfg.update(num_layers=5, fusion_start=1)
    return cfg


def tiny_traffic(name: str) -> dict:
    t = json.loads((ROOT / "port_bench" / "traffic" / f"{name}.json").read_text())
    t.update(examples=60, mode_counts=[20, 20, 20], max_seq_length=40, prompt_length=[20, 40],
             batch_size=4 if t["split"] == "train" else 16)
    return t


def make_root(path: Path, dtype=None) -> Path:
    """A benchmark root at ``path``: the manifest and the code of the real
    one, every configuration and traffic file at tiny sizes, and, with
    ``dtype``, every configuration in that dtype."""
    (path / "port_bench").mkdir(parents=True)
    for d in ("metrics", "flops", "workloads"):
        shutil.copytree(ROOT / "port_bench" / d, path / "port_bench" / d)
    shutil.copy(ROOT / "BENCHMARK.json", path / "BENCHMARK.json")
    for d, make in (("configs", tiny_config), ("traffic", tiny_traffic)):
        (path / "port_bench" / d).mkdir()
        for f in (ROOT / "port_bench" / d).glob("*.json"):
            spec = make(f.stem)
            if d == "configs" and dtype is not None:
                spec["dtype"] = dtype
            (path / "port_bench" / d / f.name).write_text(json.dumps(spec))
    return path


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path / "bench")


@pytest.fixture
def tiny_root_fp32(tmp_path):
    return make_root(tmp_path / "bench32", dtype="float32")
