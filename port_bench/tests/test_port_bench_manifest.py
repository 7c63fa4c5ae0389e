"""``BENCHMARK.json`` and the files it names: found by name, within the
contract's limits, free of JAX; a cell made of new files alone runs; the
traffic generator is a function of its seed."""

import ast
import json
import re

import numpy as np
import pytest

from conftest import ROOT, tiny_config
from port_bench import traffic
from port_bench.harness import Bench, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "mkg_analogy_tpu"}


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_every_file_is_found_by_name():
    bench = Bench(ROOT)
    m = manifest()
    for c in m["configs"]:
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"]
        bench.flops(cfg["flops"])
        bench.reference(cfg)
    for w in m["workloads"]:
        cell = bench.cell(w["name"])
        bench.traffic(cell["traffic"])
        assert cell["phase"] in ("finetune", "evaluate")
    for p in m["per_layer"]:
        reader = bench.metric_reader(p["name"])
        assert reader.LAYER == p["layer"] and reader.MOVES == p["moves"]


def test_names_units_and_sizes_keep_to_the_contract():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(m["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])


def test_each_cell_reports_what_its_per_layer_metrics_move():
    bench = Bench(ROOT)
    m = manifest()
    for w in m["workloads"]:
        e2e = {e["name"] for e in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.per_layer(w["name"])
    for p in m["per_layer"]:
        for cell in p["workloads"]:
            assert p["moves"] in {e["name"] for e in bench.end_to_end(cell)}


def test_a_cell_of_new_files_runs_through_discovery(tiny_root_fp32):
    """A configuration, a traffic mix and a cell added as files alone (and
    their manifest entries) run through the harness unchanged."""
    root = tiny_root_fp32
    cfg = dict(tiny_config("mkgformer"), name="tiny_new")
    (root / "port_bench" / "configs" / "tiny_new.json").write_text(json.dumps(cfg))
    mix = dict(split="train", examples=40, mode_counts=[10, 20, 10], batch_size=8,
               max_seq_length=32, prompt_length=[16, 32])
    (root / "port_bench" / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    spec = json.loads((root / "port_bench" / "workloads" / "mkgformer_finetune_bf16.json")
                      .read_text())
    (root / "port_bench" / "workloads" / "tiny_new_cell.json").write_text(json.dumps(spec))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny_new", "source": "test", "reduced": [], "why": "test",
                         "file": "port_bench/configs/tiny_new.json"})
    m["workloads"].append({"name": "tiny_new_cell", "config": "tiny_new", "traffic": "tiny_mix",
                           "chips": 1, "why": "test"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "mkgformer_finetune_bf16" in e.get("workloads", ()):
            e["workloads"].append("tiny_new_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    line = run_cell(Bench(root), "tiny_new_cell", 5, 0.2, False, device="cpu")
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_examples_per_s.bf16", "setup_s"}
    assert list(line)[-1] == "checks"


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "port_bench").rglob("*.py"))
    assert files
    for path in files:
        top = {name.partition(".")[0] for name in _imports(path)}
        assert not top & FORBIDDEN, (path, top & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "port_bench" / "reference").rglob("*.py")):
        top = {name.partition(".")[0] for name in _imports(path)}
        assert "mkg_analogy_tpu_torch" not in top, path


@pytest.mark.parametrize("name", ["mars_train_b32", "mars_dev_b128"])
def test_traffic_is_a_function_of_its_seed(name):
    cfg = json.loads((ROOT / "port_bench" / "configs" / "mkgformer.json").read_text())
    spec = traffic.load(ROOT, name)
    a = traffic.make_split(spec, cfg, 2 ** 31 + 3)
    b = traffic.make_split(spec, cfg, 2 ** 31 + 3)
    c = traffic.make_split(spec, cfg, 2 ** 31 + 4)
    assert np.bincount(a["mode"]).tolist() == spec["mode_counts"]
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["input_ids"], c["input_ids"])
    assert not np.array_equal(a["label"], c["label"])
    # every seed the same sizes: the padded length and the example count
    assert a["input_ids"].shape == c["input_ids"].shape == (spec["examples"],
                                                           spec["max_seq_length"])
    lo, hi = spec["prompt_length"]
    lengths = a["attention_mask"].sum(1)
    assert lengths.min() >= lo and lengths.max() <= hi
    assert (a["sep_idx"][:, -1] == lengths - 1).all()
    ids = a["input_ids"]
    rows = np.arange(len(ids))
    assert (ids[rows[:, None], a["sep_idx"]] == cfg["vocab"]["sep_id"]).all()
    assert (ids[rows[:, None], a["rel_idx"]] == cfg["vocab"]["r_id"]).all()
    assert (ids[rows, a["mask_idx"]] == cfg["vocab"]["mask_id"]).all()
    assert ((a["img1"] == -1) == (a["mode"] == 0)).all()
