"""Runs one cell of the port's benchmark and returns its result line.

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:

- ``port_bench/workloads/<cell>.json``: the cell's phase ("finetune" or
  "evaluate"), optimiser settings, warm-up and profiled slice, and the
  limits of its correctness checks;
- the configuration's ``file`` (``port_bench/configs/<config>.json``): the
  model's sizes, dtype and attention route, its plain reference
  (``port_bench/reference/<name>.py``), its FLOP count
  (``port_bench/flops/<name>.py``) and vocabulary layout;
- ``port_bench/traffic/<traffic>.json``: the split the generator draws;
- ``port_bench/metrics/<metric>.py``: each per-layer metric's reader.

A run: set-up (weights and pixel table made on the device from the seed,
the features drawn, the program's trainer built,
warm-up, whose first launches build the kernels the route loads), then the window, then the check against the reference. The
program (``mkg_analogy_tpu_torch``) is driven through its own entries:
``MarTTrainer.fit`` and ``MarTTrainer.evaluate``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from . import checks, traffic as traffic_mod, weights
from .trace import profile_slice

ROOT = Path(__file__).resolve().parent.parent
OPTIMIZER_BETA1 = 0.9  # AdamW's first-moment decay: exp_avg = 0.1 g after step one


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """The manifest at ``root`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, kind: str, name: str) -> dict:
        for e in self.manifest[kind]:
            if e["name"] == name:
                return e
        raise KeyError(f"{kind} has no entry {name!r}")

    def cell(self, name: str) -> dict:
        entry = self._entry("workloads", name)
        spec = json.loads((self.root / "port_bench" / "workloads" / f"{name}.json").read_text())
        return {**spec, **entry}

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return traffic_mod.load(self.root, name)

    def flops(self, config_name: str):
        return _load_module(self.root / "port_bench" / "flops" / f"{config_name}.py",
                            f"port_bench_flops_{config_name}")

    def reference(self, config: dict):
        return importlib.import_module(f"port_bench.reference.{config['reference']}")

    def metric_reader(self, name: str):
        return _load_module(self.root / "port_bench" / "metrics" / f"{name}.py",
                            f"port_bench_metric_{name}")

    def end_to_end(self, cell: str):
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str):
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.manifest["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


class Recorder:
    """A logger for ``MarTTrainer``: keeps every record it is given."""

    def __init__(self):
        self.records = []

    def log(self, step, metrics, prefix=""):
        self.records.append((step, {f"{prefix}{k}": float(v) for k, v in metrics.items()}))

    def values(self, key):
        return [r[key] for _, r in self.records if key in r]


class _Vocab:
    """What the trainer reads of a vocabulary in a fine-tune or an
    evaluation: the word-table rows of the analogy entities."""

    def __init__(self, config):
        start = config["vocab"]["entity_token_start"]
        self.analogy_entity_ids = np.arange(start, start + config["analogy_entities"])
        self.analogy_relation_ids = np.zeros(0, np.int64)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


class Run:
    """One run of a cell: what set-up built, what the window measured and
    what the checks read."""

    def __init__(self, bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool,
                 device, t_start: float, tmp: Path):
        self.bench, self.cell_name, self.seed = bench, cell_name, int(seed)
        self.seconds, self.trace, self.t_start = float(seconds), bool(trace), t_start
        self.device = torch.device(device)
        self.tmp = tmp
        self.cell = bench.cell(cell_name)
        self.config = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.flops = bench.flops(self.config["flops"])
        self.ref = bench.reference(self.config)
        self.phase = self.cell["phase"]
        self.dtype = self.config["dtype"]
        self.batch = self.traffic["batch_size"]
        self.seq_len = self.traffic["max_seq_length"]
        self.e2e: Dict[str, float] = {}
        self.window: Dict[str, float] = {}
        self.slice = None          # trace.Slice of the profiled work (--trace 1)
        self.readings: Dict[str, float] = {}
        self.memory_peak = 0
        self.window_peak = 0

    # ----------------------------------------------------------------- set-up
    def make_params(self):
        """The run's weights: the same on every call (the reference makes
        them again)."""
        return weights.make_params(self.shapes, self.config["init"], self.seed, self.device)

    def setup(self, size_window: bool = True):
        """Build everything the window needs; ``size_window`` False stops
        after the checked steps (the calibration's runs)."""
        cfg, dev = self.config, self.device
        self.shapes = self.ref.param_shapes(cfg)
        if self.dtype == "float32":
            # fp32 means fp32: no TF32 in the GEMMs or the convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        from mkg_analogy_tpu_torch.models.registry import create_model
        from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig

        params = self.make_params()
        with torch.device(dev):
            model = create_model(
                cfg["model_class"], vocab_size=cfg["vocab_size"], dtype=self.dtype,
                attention=cfg["attention"], hidden_size=cfg["hidden_size"],
                num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
                intermediate_size=cfg["intermediate_size"],
                max_position_embeddings=cfg["max_position_embeddings"])
        model.load_state_dict(params, strict=True)
        del params
        self.features = traffic_mod.make_split(self.traffic, cfg, self.seed)
        self.pixels = weights.make_pixel_table(cfg["analogy_entities"], cfg["image_size"],
                                               self.seed, dev)
        # one epoch a fit, no evaluation in it; the cell's optimiser settings
        self.train_config = TrainConfig(
            max_epochs=1, batch_size=self.batch, eval_batch_size=self.batch, seed=self.seed,
            check_val_every_n_epoch=2, log_every=10 ** 9, **self.cell.get("optimizer", {}))
        self.recorder = Recorder()
        self.trainer = MarTTrainer(model, _Vocab(cfg), self.train_config, device=dev,
                                   logger=self.recorder)
        self.trainer.set_image_table(self.pixels)
        if self.phase == "finetune":
            self._warm_finetune(size_window)
        else:
            self._warm_evaluate()
        _sync(dev)
        if dev.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(dev)
        self.e2e["setup_s"] = time.perf_counter() - self.t_start

    def _fit(self, steps: int, log_every: int = 10 ** 9):
        self.trainer.config = replace(self.train_config, limit_train_batches=int(steps),
                                      log_every=log_every)
        return self.trainer.fit(self.features, self.features)

    def _warm_finetune(self, size_window: bool = True):
        """The checked steps, then the rate: the first ``check_steps`` steps
        of a fit go through the window's own call and feed, their losses
        logged each step, the first forward's gathered states read by a
        forward hook and, through an optimizer hook, the first gradient as
        AdamW holds it and each leaf's change after the last;
        then a fit of ``warm_steps`` gives the step rate that sizes the
        window."""
        n = self.cell["check_steps"]
        names = {id(p): k for k, p in self.trainer.model.named_parameters()}
        state = {"calls": 0}

        def hook(optimizer, args, kwargs):
            state["calls"] += 1
            if state["calls"] == 1:
                self.readings["grad_norms"] = {
                    names[id(p)]: float(optimizer.state[p]["exp_avg"].norm()
                                        / (1.0 - OPTIMIZER_BETA1))
                    for g in optimizer.param_groups for p in g["params"]}
            if state["calls"] == n:
                init = self.make_params()
                self.readings["change_norms"] = {
                    names[id(p)]: float((p.detach() - init[names[id(p)]]).norm())
                    for g in optimizer.param_groups for p in g["params"]}
                del init

        def first_forward(module, args, output):
            if "states" not in self.readings:
                self.readings["states"] = output.detach().to(torch.float32).clone()

        handles = [register_optimizer_step_post_hook(hook),
                   self.trainer.model.register_forward_hook(first_forward)]
        try:
            self._fit(n, log_every=1)
        finally:
            for h in handles:
                h.remove()
        self.readings["losses"] = self.recorder.values("train/loss")[:n]
        self.recorder.records.clear()
        if not size_window:
            return
        self._fit(self.cell["warm_steps"])
        rate = self.recorder.values("train/examples_per_sec")[-1]
        self.window_steps = max(1, int(round(self.seconds * rate / self.batch)))

    def _warm_evaluate(self):
        for _ in range(self.cell["warm_passes"]):
            self.trainer.evaluate(self.features)

    # ----------------------------------------------------------------- window
    def measure(self):
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        if self.phase == "finetune":
            _sync(dev)
            t0 = time.perf_counter()
            self._fit(self.window_steps)
            _sync(dev)
            dt = time.perf_counter() - t0
            self.window = dict(seconds=dt, steps=self.window_steps,
                               examples=self.window_steps * self.batch,
                               last_loss=self.recorder.values("train/last_loss")[-1])
            self.e2e["train_examples_per_s"] = self.window["examples"] / dt
        else:
            self.pass_metrics = []
            t0 = time.perf_counter()
            while True:
                path = self.tmp / f"ranks_{len(self.pass_metrics)}.npz"
                self.pass_metrics.append(self.trainer.evaluate(self.features,
                                                               dump_path=str(path)))
                dt = time.perf_counter() - t0
                if dt >= self.seconds:
                    break
            n = self.traffic["examples"]
            self.window = dict(seconds=dt, passes=len(self.pass_metrics),
                               examples=n * len(self.pass_metrics))
            self.e2e["eval_examples_per_s"] = self.window["examples"] / dt
        if dev.type == "cuda":
            self.window_peak = torch.cuda.max_memory_allocated(dev)
            self.memory_peak = max(self.memory_peak, self.window_peak)
        if self.trace:
            self._profile()

    def _profile(self):
        """The profiled slice, after the unprofiled window: a fit of
        ``profile_steps`` steps or ``profile_passes`` evaluations."""
        if self.phase == "finetune":
            units = self.cell["profile_steps"]
            work = lambda: self._fit(units)  # noqa: E731
        else:
            units = self.cell["profile_passes"]

            def work():
                for _ in range(units):
                    self.trainer.evaluate(self.features)
        self.slice = profile_slice(work, units, self.device, self.tmp)

    # ----------------------------------------------------------------- checks
    def free_program(self):
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        if self.phase == "finetune":
            return checks.finetune(self)
        return checks.evaluate(self)


def per_layer_values(run: Run) -> Dict[str, dict]:
    out = {}
    for m in run.bench.per_layer(run.cell_name):
        value = run.bench.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None) -> dict:
    """Run one cell; return its result line (a dict) with the compared
    numbers last, after printing them to stderr."""
    t_start = time.perf_counter() if t_start is None else t_start
    tmp = Path(tempfile.mkdtemp(prefix="port_bench_"))
    try:
        run = Run(bench, cell, seed, seconds, trace, device, t_start, tmp)
        run.setup()
        run.measure()
        if trace:
            metrics = per_layer_values(run)
        else:
            # a metric's quantity is its name up to the first dot: cells whose
            # runs spread apart report one quantity under names of their own
            metrics = {m["name"]: {"value": run.e2e[m["name"].partition(".")[0]],
                                   "unit": m["unit"]}
                       for m in bench.end_to_end(cell)}
        attempted, failed = _counts(run)
        dev = run.device
        device_line = {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(run.memory_peak)}
        if dev.type == "cuda":
            device_line["power_limit"] = card_power_limit()
        breakdown = None
        if trace:
            device_line["busy_s"] = run.slice.busy_s
            device_line["window_s"] = run.slice.window_s
            breakdown = run.slice.breakdown
        run.free_program()
        results = run.check()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct = all(r["value"] <= r["limit"] for r in results.values()) and bool(results)
    for name, r in results.items():
        print(f"{name}: {r['value']!r} (limit {r['limit']!r})", file=sys.stderr)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_line}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = results
    return line


def _counts(run: Run):
    """(attempted, failed): examples trained in the window (failed: all of
    them where the window's last loss is not finite), or examples ranked
    (failed: those whose gold score is not finite)."""
    if run.phase == "finetune":
        n = run.window["examples"]
        return n, 0 if math.isfinite(run.window["last_loss"]) else n
    bad = sum(int(m.get("Eval_entity/nonfinite_gold", 0)) for m in run.pass_metrics)
    return run.window["examples"], bad
