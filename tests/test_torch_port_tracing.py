"""The port's spans (``utils/profiling.py``) on the CPU: nothing recorded
while off; nesting, parents, threads, step ids, the bound; the span tree of
a tiny ``fit`` and ``evaluate``; the attention spans of a step against the
calls ``port_bench/flops/`` counts; the benchmark's join of spans with a
device trace (``port_bench/spans.py``) on a synthetic Chrome trace, and the
clock offset from the anchors."""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.data.module import KGCDataModule
from mkg_analogy_tpu_torch.models.registry import create_model
from mkg_analogy_tpu_torch.train.trainer import MarTTrainer, TrainConfig
from mkg_analogy_tpu_torch.utils import profiling
from mkg_analogy_tpu_torch.utils.profiling import Offset, Recording, Span, recording, span

torch.set_num_threads(1)


def by_name(rec):
    out = collections.defaultdict(list)
    for s in rec.spans:
        out[s.name].append(s)
    return out


def test_off_records_nothing():
    assert span("a") is span("b", x=1)  # one shared no-op context
    with span("a"):
        profiling.set_step(4)
    with recording() as rec:
        pass
    with span("after"):
        pass
    assert rec.spans == [] and rec.dropped == 0 and len(rec.anchors) == 2


def test_nesting_parents_threads_and_steps():
    """Parents are the span open on the same thread; a span takes the step
    the loop set unless it names its own; every thread that recorded maps
    to its id in a device trace's runtime records."""
    worker = {}

    def work():
        worker["ids"] = threading.get_native_id(), profiling.cupti_thread_id()
        with span("w"):
            with span("w.inner", step=7):
                pass

    with recording() as rec:
        profiling.set_step(3)
        with span("a"):
            with span("b", route="plain", shape=(1, 2, 3, 4, 5)):
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=30)
        with span("c", step=9):
            pass
    assert not t.is_alive()
    spans = {s.name: s for s in rec.spans}
    me = threading.get_native_id()
    assert spans["a"].parent is None and spans["b"].parent == spans["a"].id
    assert spans["c"].parent is None
    assert spans["w"].parent is None and spans["w.inner"].parent == spans["w"].id
    assert {spans[k].tid for k in "abc"} == {me} == {rec.loop_tid}
    assert spans["w"].tid == worker["ids"][0] != me
    assert rec.threads == {me: profiling.cupti_thread_id(),
                           worker["ids"][0]: worker["ids"][1]}
    assert [spans[k].step for k in ("a", "b", "c", "w", "w.inner")] == [3, 3, 9, 3, 7]
    assert spans["b"].attrs == {"route": "plain", "shape": (1, 2, 3, 4, 5)}
    assert spans["a"].attrs is None
    for s in rec.spans:
        assert rec.anchors[0][-1][1] <= s.start <= s.end <= rec.anchors[1][0][0]


def test_bound_dropped_and_no_nesting():
    with recording(capacity=3) as rec:
        for i in range(5):
            with span(f"s{i}"):
                pass
        with pytest.raises(RuntimeError, match="already being recorded"):
            with recording():
                pass
    assert [s.name for s in rec.spans] == ["s0", "s1", "s2"] and rec.dropped == 2


def test_a_span_closed_after_its_recording_is_left_out():
    with recording() as rec:
        late = span("late")
        late.__enter__()
    late.__exit__(None, None, None)
    assert rec.spans == []


@pytest.fixture(scope="module")
def module(tmp_path_factory):
    from tests.util import make_tiny_dataset

    markg_dir, mars_dir = make_tiny_dataset(str(tmp_path_factory.mktemp("port_tracing_kg")))
    return KGCDataModule(data_dir=mars_dir, pretrain_path=markg_dir, max_seq_length=48,
                         text_vocab_size=256, image_size=16)


def make_trainer(module, **flags):
    """The tiny MKGformer on the kernels' route (their plain versions on the
    CPU), fp32, seed 0, with a zero image table."""
    model = create_model("MKGformerKGC", vocab_size=module.vocab.padded_vocab_size,
                         dtype="float32", attention="single", hidden_size=32, num_layers=2,
                         num_heads=2, intermediate_size=64)
    trainer = MarTTrainer(model, module.vocab, TrainConfig(**flags), device="cpu")
    trainer.init_params(0)
    trainer.set_image_table(np.zeros((module.markg.num_entities + 1, 3, 224, 224), np.float32))
    return trainer


def test_fit_and_evaluate_give_the_span_tree(module):
    """A fit of 3 steps with an evaluation at its end, then an evaluation:
    the spans, their parents, threads and step or batch ids."""
    trainer = make_trainer(module, max_epochs=1, batch_size=4, eval_batch_size=8,
                           limit_train_batches=3, lr=1e-3)
    with recording() as rec:
        trainer.fit(module.features("train"), module.features("dev"))
    n = by_name(rec)
    loop = rec.loop_tid
    ids = {s.id: s for s in rec.spans}
    (fit,) = n["fit"]
    assert fit.parent is None and fit.tid == loop
    assert [ids[s.parent].name for s in n["fit.setup"]] == ["fit"]
    assert [s.step for s in n["step"]] == [0, 1, 2]
    assert {ids[s.parent].name for s in n["step"]} == {"fit"}
    for name in ("step.forward", "step.backward", "step.optimizer"):
        assert [(ids[s.parent].name, ids[s.parent].step, s.step) for s in n[name]] == [
            ("step", i, i) for i in range(3)]
    for kind, parents in (("attention.fwd", {"step.forward", "eval.forward"}),
                          ("attention.bwd", {"step.backward"})):
        assert n[kind] and {ids[s.parent].name for s in n[kind]} == parents
        assert all(s.attrs["route"] == "plain" and len(s.attrs["shape"]) == 5 for s in n[kind])
    # the loop waits for the three steps' batches and the one past the limit
    assert [s.step for s in n["step.wait"]] == [0, 1, 2, 3]
    assert all(s.tid == loop and ids[s.parent].name == "fit" for s in n["step.wait"])
    assert {s.step for s in n["stage"]} >= {0, 1, 2, 3}
    assert all(s.tid != loop and s.tid in rec.threads for s in n["stage"])
    assert n["sync"] and all(s.tid == loop for s in n["sync"])
    (evaluation,) = n["evaluate"]
    assert ids[evaluation.parent].name == "fit"

    batches = -(-len(module.features("dev")["input_ids"]) // 8)
    with recording() as rec:
        trainer.evaluate(module.features("dev"))
    n = by_name(rec)
    ids = {s.id: s for s in rec.spans}
    (evaluation,) = n["evaluate"]
    assert evaluation.parent is None
    assert [s.step for s in n["eval.batch"]] == list(range(batches))
    assert [(ids[s.parent].name, s.step) for s in n["eval.forward"]] == [
        ("eval.batch", i) for i in range(batches)]
    assert [s.step for s in n["eval.wait"]] == list(range(batches + 1))  # and the end
    assert [ids[s.parent].name for s in n["eval.gather"]] == ["evaluate"]
    assert [s.step for s in n["stage"]] == list(range(batches))
    assert all(s.tid != rec.loop_tid for s in n["stage"])
    assert not n["attention.bwd"] and all(
        ids[s.parent].name == "eval.forward" for s in n["attention.fwd"])


@pytest.mark.parametrize("cell", ["mkgformer_finetune_bf16", "flava_finetune_fp32",
                                  "mkgformer_eval_bf16"])
def test_attention_spans_are_the_calls_the_benchmark_counts(cell, tmp_path):
    """At tiny widths, the attention spans of one training step (forward
    and backward) or one evaluation batch are the calls
    ``port_bench/flops/<config>.py:attention_calls`` counts, shape for
    shape."""
    from port_bench.harness import Bench, Run
    from port_bench.tests.conftest import make_root

    bench = Bench(make_root(tmp_path / "bench", dtype="float32"))
    run = Run(bench, cell, 2 ** 31 + 5, 0.1, False, "cpu", time.perf_counter(), tmp_path)
    run.setup(size_window=False)
    with recording() as rec:
        if run.phase == "finetune":
            run._fit(1)
        else:
            run.trainer.evaluate(run.features)
    want = collections.Counter()
    for c in run.flops.attention_calls(run.config, run.batch, run.seq_len):
        want[(c["b"], c["heads"], c["lq"], c["lk"], c["head_dim"])] += c["count"]
    got = collections.defaultdict(collections.Counter)
    for s in rec.spans:
        if s.name.startswith("attention.") and s.step == 0:
            got[s.name][s.attrs["shape"]] += 1
    assert got["attention.fwd"] == want
    assert got["attention.bwd"] == (want if run.phase == "finetune" else {})


# --- the join with a device trace: port_bench/spans.py -----------------------------

LOOP, WORKER, AUTOGRAD = 100, 200, 300
CUPTI = {LOOP: 0xAAAA0001, WORKER: 0xBBBB0002, AUTOGRAD: 0xCCCC0003}
OFFSET = 1_000_000  # trace ns - host ns


def synthetic():
    """A recording and a trace of one training step, the trace's clock
    1 ms ahead of the host's (times in host ns)."""
    rec = Recording()
    rec.loop_tid = LOOP
    rec.threads = dict(CUPTI)
    rec.anchors = [[(0, 10_000), (12_000, 20_000)], [(1_000_000, 1_010_000), (1_012_000, 1_020_000)]]
    rows = [("fit", 20_000, 900_000, LOOP, None), ("step", 100_000, 800_000, LOOP, 0),
            ("step.wait", 30_000, 90_000, LOOP, 0), ("step.forward", 110_000, 300_000, LOOP, 1),
            ("attention.fwd", 150_000, 200_000, LOOP, 3),
            ("step.backward", 300_000, 600_000, LOOP, 1),
            ("step.optimizer", 600_000, 700_000, LOOP, 1), ("stage", 40_000, 80_000, WORKER, None),
            ("attention.bwd", 400_000, 450_000, AUTOGRAD, None)]
    rec.spans = [Span(name, start, end, tid, i, parent, 0, None)
                 for i, (name, start, end, tid, parent) in enumerate(rows)]

    def us(host_ns):
        return (host_ns + OFFSET) / 1e3

    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
               "tid": CUPTI[LOOP], "ts": ts, "dur": 2.0, "args": {"correlation": c}}
              for ts, c in ((1004.0, 1), (1015.0, 2), (1500.0, 3), (2004.0, 4), (2015.0, 5))]
    # (launching thread or None, call at, op start, op end, category, name)
    ops = [(WORKER, 50_000, 85_000, 95_000, "gpu_memcpy", "Memcpy HtoD (Pinned -> Device)"),
           (LOOP, 160_000, 170_000, 190_000, "kernel", "void fwd_kernel<64>(Args)"),
           (AUTOGRAD, 420_000, 430_000, 440_000, "kernel", "void dkv_kernel<64>(Args)"),
           (AUTOGRAD, 500_000, 510_000, 520_000, "kernel", "void at::native::add_kernel"),
           (None, 0, 650_000, 660_000, "kernel", "void at::native::copy_kernel"),
           (LOOP, 850_000, 860_000, 870_000, "kernel", "void at::native::mul_kernel")]
    for corr, (thread, call, s, t, cat, name) in enumerate(ops, 10):
        if thread is not None:
            events.append({"ph": "X", "cat": "cuda_runtime", "tid": CUPTI[thread],
                           "name": "cudaMemcpyAsync" if cat == "gpu_memcpy" else
                           "cudaLaunchKernel", "ts": us(call), "dur": 1.0,
                           "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": cat, "name": name, "tid": 7, "ts": us(s),
                       "dur": (t - s) / 1e3, "args": {"correlation": corr}})
    return rec, {"baseTimeNanoseconds": 0, "traceEvents": events}


def test_clock_offset_from_the_anchors():
    """The runs of synchronisations that fit the anchors' brackets, not the
    one between them; each lies inside its bracket, so an anchor's bound is
    the intersection of its brackets' (here +-3 us, each alone +-4)."""
    rec, doc = synthetic()
    assert profiling.clock_offset(doc, rec.anchors) == Offset(OFFSET, 3_000, 0)
    shifted = [[(a + 3_000, b + 3_000) for a, b in rec.anchors[1]]]
    off = profiling.clock_offset(doc, rec.anchors[:1] + shifted)
    assert off == Offset(OFFSET - 1_500, 3_000 + 1_500, 3_000)
    assert profiling.clock_offset({"traceEvents": []}, rec.anchors) is None


def test_join_puts_gaps_and_operations_down_to_spans():
    """A gap goes to the span open at its middle on the thread that launched
    the operation ending it (the worker's ``stage``, not the loop's wait);
    the autograd thread outside its attention span falls back to the loop's
    ``step.backward``; an operation without a launch call is unattributed;
    each operation goes to the span open at its launch."""
    from port_bench.spans import Joined

    rec, doc = synthetic()
    j = Joined(doc, rec, profiling.clock_offset(doc, rec.anchors))
    ids = {s.name: s.id for s in rec.spans}
    assert dict(j.idle) == {ids["stage"]: 65_000, ids["step.forward"]: 75_000,
                            ids["step.backward"]: 240_000 + 70_000, None: 130_000,
                            ids["step"]: 200_000}
    assert j.idle_ns == 780_000 and j.loop_idle_ns() == 200_000
    assert dict(j.device) == {ids["stage"]: 10_000, ids["attention.fwd"]: 20_000,
                              ids["attention.bwd"]: 10_000, ids["step.backward"]: 10_000,
                              None: 10_000, ids["fit"]: 10_000}
    assert j.attention_ns() == 30_000 and j.attention_launches == (2, 2)
    assert dict(j.copies) == {("Memcpy HtoD (Pinned -> Device)", "stage"): 10_000}
