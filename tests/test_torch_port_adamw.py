"""AdamW's CUDA kernel (``csrc/adamw.cu``), the optimizer that launches it
(``kernels/adamw.py:AdamW``) and ``train/optim.py:Optimizer`` on top of it.

On the CPU: the plain version against ``optax.adamw`` and, bit for bit,
against ``torch.optim.AdamW`` (foreach and single-tensor) over 5 steps of
the schedule with both groups and a leaf without a gradient; the
``Optimizer`` against the update it made through ``torch.optim.AdamW``
before, with clipping and accumulation; the kernel's walk over the
parameters; the wrapper's refusals and its constants against the kernel's.
The ``cuda``-marked tests (they skip without a card) hold the kernel to the
plain version bit for bit on the card: tensors of 1, 3, 4,097 and 2^20 + 5
elements and unaligned ones, both groups, a null gradient, 5 steps of the
schedule, both branches of the lerp; ``state[p]["exp_avg"]`` as an optimizer
post hook reads it; ``LAUNCHES_ADAMW`` a step; the ``Optimizer`` against
``torch.optim.AdamW``'s foreach step. JAX only inside the optax test, so
that the file runs on the card with ``--noconftest``."""

import pathlib
import re

import numpy as np
import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from mkg_analogy_tpu_torch.kernels import adamw as aw
from mkg_analogy_tpu_torch.train import optim

CU = pathlib.Path(aw.__file__).resolve().parent.parent / "csrc" / "adamw.cu"
SCHEDULE = optim.linear_warmup_linear_decay(1e-2, 10, 0.2)
SIZES = (1, 3, 4097, 2 ** 20 + 5)


def make_leaves(sizes, device, seed=0, unaligned=False):
    """Parameters of ``sizes`` elements drawn from ``seed``; ``unaligned``
    puts each one element into a buffer of its own, off 16-byte alignment."""
    gen = torch.Generator().manual_seed(seed)
    leaves = []
    for n in sizes:
        values = torch.randn(n + unaligned, generator=gen)
        leaf = torch.nn.Parameter(values.to(device)[int(unaligned):])
        leaves.append(leaf)
    return leaves


def draw_grads(leaves, seed, none=()):
    gen = torch.Generator().manual_seed(seed)
    return [None if i in none else (torch.randn(p.shape, generator=gen) * 3).to(p.device)
            for i, p in enumerate(leaves)]


def two_groups(leaves, decayed):
    return [{"params": leaves[:decayed], "weight_decay": 0.1},
            {"params": leaves[decayed:], "weight_decay": 0.0}]


def plain_steps(leaves, decayed, grad_steps, betas=(0.9, 0.999)):
    """The plain version over ``grad_steps`` (a list of gradient lists),
    with the schedule's learning rate: the parameters and moments after
    each step."""
    groups = two_groups(leaves, decayed)
    ms = [torch.zeros_like(p) for p in leaves]
    vs = [torch.zeros_like(p) for p in leaves]
    out = []
    with torch.no_grad():
        for step, grads in enumerate(grad_steps, start=1):
            k = 0
            for group in groups:
                n = len(group["params"])
                aw.adamw_reference(group["params"], grads[k:k + n], ms[k:k + n], vs[k:k + n],
                                   step=float(step), lr=SCHEDULE(step - 1), betas=betas,
                                   eps=1e-8, weight_decay=group["weight_decay"])
                k += n
            out.append([t.clone() for t in leaves + ms + vs])
    return out


def kernel_steps(leaves, decayed, grad_steps, betas=(0.9, 0.999)):
    """``AdamW`` with ``LambdaLR`` on the schedule over ``grad_steps``: the
    parameters and moments after each step."""
    opt = aw.AdamW(two_groups(leaves, decayed), lr=1.0, betas=betas, eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, SCHEDULE)
    out = []
    for grads in grad_steps:
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
        out.append([t.detach().clone() for t in leaves]
                   + [opt.state[p]["exp_avg"].clone() for p in leaves]
                   + [opt.state[p]["exp_avg_sq"].clone() for p in leaves])
    return out


def ulp_gap(got, want) -> int:
    """The largest distance in units of the last place between two fp32
    tensors of finite values (0: bit for bit)."""
    def ordered(t):
        bits = t.view(torch.int32).to(torch.int64)
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    if got.numel() == 0:
        return 0
    return int((ordered(got) - ordered(want)).abs().max())


def assert_bit_for_bit(got_steps, want_steps):
    """Every tensor after every step the same bits; the failure states the
    largest gap in ulp of each step."""
    gaps = [max(ulp_gap(g, w) for g, w in zip(got, want))
            for got, want in zip(got_steps, want_steps)]
    assert gaps == [0] * len(gaps), f"largest gap in ulp by step: {gaps}"


# ----------------------------------------------------------------------- CPU
def test_kernel_constants_are_the_wrappers():
    src = CU.read_text()
    assert int(re.search(r"kMaxTensors = (\d+);", src).group(1)) == aw.MAX_TENSORS
    assert int(re.search(r"kMaxGroups = (\d+);", src).group(1)) == aw.MAX_GROUPS
    assert aw.CHUNK % 4 == 0


@pytest.mark.parametrize("max_tensors", [1, 3, aw.MAX_TENSORS])
def test_plan_walks_every_element_once(max_tensors):
    numels = [0, 1, 3, 4097, aw.CHUNK, aw.CHUNK + 1, 3 * aw.CHUNK - 1, 0, 2 ** 20 + 5]
    table, launches = aw.plan(numels, max_tensors=max_tensors)
    seen = [np.zeros(n, np.int64) for n in numels]
    for t, k in table:
        seen[t][k * aw.CHUNK:(k + 1) * aw.CHUNK] += 1
    assert all((s == 1).all() for s in seen)
    assert table.dtype == np.int32 and table.shape == (sum(-(-n // aw.CHUNK) for n in numels), 2)
    assert launches[0][0] == launches[0][2] == 0
    assert launches[-1][1] == len(numels) and launches[-1][3] == len(table)
    for (t0, t1, c0, c1), nxt in zip(launches, launches[1:] + [None]):
        assert 0 < t1 - t0 <= max_tensors
        assert all(t0 <= t < t1 for t, _ in table[c0:c1])
        if nxt is not None:
            assert (nxt[0], nxt[2]) == (t1, c1)


def test_plain_version_matches_optax_adamw():
    """Both groups (decay 0.1 and none), a decayed leaf without a gradient
    (zeros to optax), 5 steps of the schedule: within 1e-6 of optax.adamw, which
    computes the same fp32 update in another order."""
    import jax.numpy as jnp
    import optax

    leaves = make_leaves((5, 3, 7, 4), "cpu", seed=1)
    init = [p.detach().numpy().copy() for p in leaves]
    grad_steps = [draw_grads(leaves, seed=10 + s, none=(1,)) for s in range(5)]
    got = kernel_steps(leaves, 2, grad_steps)

    tx = optax.adamw(SCHEDULE, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1,
                     mask=[True, True, False, False])
    params = [jnp.asarray(x) for x in init]
    state = tx.init(params)
    for step, grads in enumerate(grad_steps):
        g = [jnp.zeros_like(p) if x is None else jnp.asarray(x.numpy()) for p, x in
             zip(params, grads)]
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in enumerate(params):
            np.testing.assert_allclose(got[step][k].numpy(), np.asarray(p), atol=1e-6,
                                       err_msg=f"leaf {k} after step {step + 1}")
    assert not np.allclose(np.asarray(params[1]), init[1])  # weight decay moves it


@pytest.mark.parametrize("foreach", [True, False])
def test_plain_version_is_torch_adamw_bit_for_bit(foreach):
    """``torch.optim.AdamW`` (foreach, and the single-tensor loop the CPU
    took by default) with the leaf's zeros made explicit, as the port's
    ``Optimizer`` gave them: the same bits after each of 5 steps."""
    leaves = make_leaves((5, 3, 7, 4), "cpu", seed=2)
    twins = [torch.nn.Parameter(p.detach().clone()) for p in leaves]
    grad_steps = [draw_grads(leaves, seed=20 + s, none=(3,)) for s in range(5)]
    got = kernel_steps(leaves, 2, grad_steps)
    opt = torch.optim.AdamW(two_groups(twins, 2), lr=1.0, eps=1e-8, foreach=foreach)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, SCHEDULE)
    want = []
    for grads in grad_steps:
        for p, g in zip(twins, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        opt.step()
        sched.step()
        want.append([t.detach().clone() for t in twins]
                    + [opt.state[p]["exp_avg"].clone() for p in twins]
                    + [opt.state[p]["exp_avg_sq"].clone() for p in twins])
    assert_bit_for_bit(got, want)


@pytest.mark.parametrize("accumulate,clip", [(1, None), (1, 0.5), (2, 0.5)])
def test_optimizer_gives_its_torch_adamw_numbers(accumulate, clip):
    """``train/optim.py:Optimizer`` with a leaf that never has a gradient,
    clipping and accumulation, against the same recipe through
    ``torch.optim.AdamW`` as the port ran it before (zeros for the leaf, the
    clip on every gradient, the running mean): bit for bit, and
    ``LAUNCHES_ADAMW`` unmoved on the CPU."""
    def model():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.LayerNorm(5),
                                torch.nn.Linear(5, 3))
        m.register_parameter("unused", torch.nn.Parameter(torch.ones(4)))
        return m

    mine, theirs = model(), model()
    opt = optim.make_optimizer(mine, 1e-2, 10, warmup_ratio=0.2, grad_accum_steps=accumulate,
                               max_grad_norm=clip)
    decay = optim.no_decay_mask(theirs)
    named = list(theirs.named_parameters())
    ref = torch.optim.AdamW([{"params": [p for n, p in named if decay[n]], "weight_decay": 0.01},
                             {"params": [p for n, p in named if not decay[n]],
                              "weight_decay": 0.0}], lr=1.0, eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(ref, optim.linear_warmup_linear_decay(
        1e-2, 10 // accumulate, 0.2))
    acc = [torch.zeros_like(p) for _, p in named]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32))
    launches = aw.LAUNCHES_ADAMW
    for micro in range(6):
        for m in (mine, theirs):
            (m(x * (micro + 1)) ** 2).sum().backward()
        opt.step()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in named]
        for a, g in zip(acc, grads):
            a.add_((g - a) / (micro % accumulate + 1))
        theirs.zero_grad(set_to_none=True)
        if (micro + 1) % accumulate:
            continue
        grads = [a.clone() for a in acc]
        for a in acc:
            a.zero_()
        if clip:
            norm = optim.global_norm(grads)
            grads = [torch.where(norm < clip, g, g / norm * clip) for g in grads]
        for (_, p), g in zip(named, grads):
            p.grad = g
        ref.step()
        sched.step()
        theirs.zero_grad(set_to_none=True)
        for (n, p), q in zip(mine.named_parameters(), theirs.parameters()):
            assert torch.equal(p, q), (micro, n)
    assert aw.LAUNCHES_ADAMW == launches
    assert not torch.equal(mine[0].weight, model()[0].weight)


def test_state_holds_every_leaf_for_a_post_hook():
    """After a step every leaf, the one without a gradient too, has
    ``exp_avg``, ``exp_avg_sq`` and ``step`` in ``state``, as the
    benchmark's optimizer post hook reads them."""
    leaves = make_leaves((5, 3, 7), "cpu", seed=3)
    opt = aw.AdamW(two_groups(leaves, 1), lr=1e-2)
    seen = {}

    def hook(optimizer, args, kwargs):
        seen.update({id(p): (float(optimizer.state[p]["exp_avg"].norm()),
                             float(optimizer.state[p]["step"]))
                     for g in optimizer.param_groups for p in g["params"]})

    handle = register_optimizer_step_post_hook(hook)
    try:
        for p, g in zip(leaves, draw_grads(leaves, seed=4, none=(1,))):
            p.grad = g
        opt.step()
    finally:
        handle.remove()
    assert set(seen) == {id(p) for p in leaves}
    assert seen[id(leaves[1])] == (0.0, 1.0)
    assert seen[id(leaves[0])][0] == pytest.approx(0.1 * float(leaves[0].grad.norm()))


def test_refuses_what_the_kernel_does_not_take():
    """The tables refuse parameters off the card's device, of another dtype
    or not contiguous, before anything reaches the card; more groups than
    the kernel takes raise."""
    cuda = torch.device("cuda")
    for leaf in (torch.nn.Parameter(torch.zeros(4)),
                 torch.nn.Parameter(torch.zeros(4, dtype=torch.bfloat16)),
                 torch.nn.Parameter(torch.zeros(4, 4).t())):
        state = {leaf: {"exp_avg": torch.zeros_like(leaf), "exp_avg_sq": torch.zeros_like(leaf)}}
        with pytest.raises(ValueError, match="adamw_reference"):
            aw._Tables([leaf], state, [0], cuda)
    leaves = make_leaves((1,) * (aw.MAX_GROUPS + 1), "cpu")
    opt = aw.AdamW([{"params": [p]} for p in leaves])
    with pytest.raises(ValueError, match="parameter groups"):
        opt.step()


def test_optimizer_roofline_reads_the_optimizer_spans():
    """``optimizer_roofline.*`` (``port_bench/bounds_adamw.py``) on the
    synthetic trace of tests/test_torch_port_tracing.py with one kernel
    launched inside ``step.optimizer``: 28 bytes a trainable parameter over
    the HBM rate against that kernel's 8 us; None without such a launch."""
    import types

    from port_bench import bounds_adamw
    from port_bench.spans import Joined
    from mkg_analogy_tpu_torch.utils import profiling
    from tests.test_torch_port_tracing import CUPTI, LOOP, OFFSET, synthetic

    model = torch.nn.Linear(10, 10)
    model.register_parameter("frozen", torch.nn.Parameter(torch.ones(5), requires_grad=False))
    rec, doc = synthetic()

    def read(doc):
        j = Joined(doc, rec, profiling.clock_offset(doc, rec.anchors))
        run = types.SimpleNamespace(slice=object(), phase="finetune", span_slice=j,
                                    trainer=types.SimpleNamespace(model=model))
        return bounds_adamw.optimizer_roofline(run)

    assert read(doc) is None  # the only operation in the span has no launch call
    doc["traceEvents"] += [
        {"ph": "X", "cat": "cuda_runtime", "tid": CUPTI[LOOP], "name": "cudaLaunchKernel",
         "ts": (620_000 + OFFSET) / 1e3, "dur": 1.0, "args": {"correlation": 99}},
        {"ph": "X", "cat": "kernel", "name": "adamw_kernel", "tid": 7,
         "ts": (640_000 + OFFSET) / 1e3, "dur": 8.0, "args": {"correlation": 99}}]
    assert read(doc) == pytest.approx(100 * 28 * 110 / 3.35e12 / 8e-6)


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the AdamW kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.3, 0.5)])
@pytest.mark.parametrize("unaligned", [False, True])
def test_kernel_is_the_plain_version_bit_for_bit(cuda, betas, unaligned):
    """Tensors of 1, 3, 4,097 and 2^20 + 5 elements in both groups (each
    twice: decayed, then not), one with a null gradient, 5 steps of the
    schedule: p, m and v the plain version's bits after every step. (0.3,
    0.5) takes the lerp's other branch (a weight of 0.7)."""
    sizes = SIZES + SIZES
    grad_steps = [draw_grads(make_leaves(sizes, cuda), seed=30 + s, none=(5,))
                  for s in range(5)]
    got = kernel_steps(make_leaves(sizes, cuda, seed=4, unaligned=unaligned), 4, grad_steps,
                       betas)
    want = plain_steps(make_leaves(sizes, cuda, seed=4, unaligned=unaligned), 4, grad_steps,
                       betas)
    torch.cuda.synchronize()
    assert_bit_for_bit(got, want)


@pytest.mark.cuda
def test_post_hook_reads_exp_avg_on_the_card(cuda):
    """The benchmark's hook pattern: every leaf's ``exp_avg`` read in a post
    hook after the first step is 0.1 g (a null gradient's 0), as the plain
    version holds it."""
    leaves = make_leaves(SIZES, cuda, seed=5)
    grads = draw_grads(leaves, seed=6, none=(1,))
    want = plain_steps(make_leaves(SIZES, cuda, seed=5), 2, [grads])[0][len(SIZES):2 * len(SIZES)]
    read = {}

    def hook(optimizer, args, kwargs):
        read.update({id(p): optimizer.state[p]["exp_avg"].clone()
                     for g in optimizer.param_groups for p in g["params"]})

    opt = aw.AdamW(two_groups(leaves, 2), lr=1.0)
    handle = register_optimizer_step_post_hook(hook)
    try:
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
    finally:
        handle.remove()
    assert [ulp_gap(read[id(p)], w) for p, w in zip(leaves, want)] == [0] * len(SIZES)
    assert float(read[id(leaves[1])].abs().max()) == 0.0


@pytest.mark.cuda
def test_launches_a_step(cuda, monkeypatch):
    """One launch a step up to MAX_TENSORS parameters, two past it, each
    step the plain version's bits; nothing launched for leaves of no
    elements."""
    monkeypatch.setattr(aw, "LAUNCHES_ADAMW", 0)
    for sizes, per_step in [(SIZES, 1), ((1,) * aw.MAX_TENSORS + (7,), 2), ((0, 0), 0)]:
        before = aw.LAUNCHES_ADAMW
        grad_steps = [draw_grads(make_leaves(sizes, cuda), seed=40 + s) for s in range(2)]
        got = kernel_steps(make_leaves(sizes, cuda, seed=7), 1, grad_steps)
        want = plain_steps(make_leaves(sizes, cuda, seed=7), 1, grad_steps)
        torch.cuda.synchronize()
        assert aw.LAUNCHES_ADAMW - before == 2 * per_step, sizes[:4]
        assert_bit_for_bit(got, want)


@pytest.mark.cuda
def test_optimizer_is_torch_adamws_foreach_step_on_the_card(cuda):
    """``train/optim.py:Optimizer`` (one launch a step) against the update
    it made through ``torch.optim.AdamW`` before (PyTorch's foreach
    kernels, zeros for a leaf without a gradient): the same bits after each
    of 4 steps of a small model, one launch a step."""
    def model():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(64, 48), torch.nn.LayerNorm(48),
                                torch.nn.Linear(48, 5)).to(cuda)
        m.register_parameter("unused", torch.nn.Parameter(torch.ones(33, device=cuda)))
        return m

    mine, theirs = model(), model()
    opt = optim.make_optimizer(mine, 1e-2, 10, warmup_ratio=0.2)
    decay = optim.no_decay_mask(theirs)
    named = list(theirs.named_parameters())
    ref = torch.optim.AdamW([{"params": [p for n, p in named if decay[n]], "weight_decay": 0.01},
                             {"params": [p for n, p in named if not decay[n]],
                              "weight_decay": 0.0}], lr=1.0, eps=1e-8, foreach=True)
    sched = torch.optim.lr_scheduler.LambdaLR(ref, optim.linear_warmup_linear_decay(1e-2, 10,
                                                                                     0.2))
    x = torch.randn(16, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = aw.LAUNCHES_ADAMW
    for step in range(4):
        for m in (mine, theirs):
            (m(x * (step + 1)) ** 2).sum().backward()
        opt.step()
        for _, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        ref.step()
        sched.step()
        theirs.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        for (n, p), q in zip(mine.named_parameters(), theirs.parameters()):
            assert ulp_gap(p.detach(), q.detach()) == 0, (step, n)
    assert aw.LAUNCHES_ADAMW - before == 4


@pytest.mark.cuda
def test_kernel_refuses_a_strided_gradient(cuda):
    leaf = torch.nn.Parameter(torch.zeros(4, 4, device=cuda))
    opt = aw.AdamW([leaf])
    leaf.grad = torch.zeros(4, 4, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous gradients"):
        opt.step()
