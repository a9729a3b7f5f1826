"""The port's spans and counters (``cugp_tpu_torch.utils.profiling``):
nothing recorded and no bit changed without a profiler session; under
one, each path's spans under their step or request, the host reads
counted, the stamps on the Chrome trace's clock, one session's record at
a time, and a span on another thread under the step that caused it."""

from __future__ import annotations

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cugp_tpu_torch import GP
from cugp_tpu_torch.utils import profiling

STEPS = 3


def _data(n=96, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand((n, d), generator=g) * 2.0 - 1.0
    y = torch.sin(3.0 * X.sum(1)) + 0.1 * torch.randn(n, generator=g)
    return X, y


def _fit(gp, X, y):
    info = gp.fit(X, y, steps=STEPS, learning_rate=0.1)
    return [info["loss"], *gp.params.values()]


def _fit_iterative(gp, X, y):
    info = gp.fit_iterative(X, y, steps=STEPS, learning_rate=0.1,
                            num_probes=4, precond_rank=16, tol=1e-4,
                            max_iters=200, split_programs=True)
    return [info["loss"], torch.as_tensor(info["cg_iters"]),
            *gp.params.values()]


def _predict(gp, X, y):
    gp.condition(X, y)
    Xs, _ = _data(n=40, seed=1)
    return list(gp.predict(Xs))


def _predict_twice(gp, X, y):
    """Two requests on one state: the second reuses the first's factor."""
    first = _predict(gp, X, y)
    Xs, _ = _data(n=24, seed=2)
    return first + list(gp.predict(Xs))


PATHS = {"fit": _fit, "fit_iterative": _fit_iterative, "predict": _predict,
         "predict_twice": _predict_twice}

# each path's spans: (name, its parent's name) in the order they begin
EXPECTED = {
    "fit": [("cugp.step", None), ("cugp.factorize", "cugp.step"),
            ("cugp.chol_backward", "cugp.step")] * STEPS,
    "fit_iterative": [("cugp.step", None),
                      ("cugp.precond_build", "cugp.step"),
                      ("cugp.cg_solve", "cugp.step"),
                      ("cugp.grad_sweep", "cugp.step")]
    + [("cugp.step", None), ("cugp.cg_solve", "cugp.step"),
       ("cugp.grad_sweep", "cugp.step")] * (STEPS - 1),
    "predict": [("cugp.request", None), ("cugp.factorize", "cugp.request")],
    "predict_twice": [("cugp.request", None),
                      ("cugp.factorize", "cugp.request"),
                      ("cugp.request", None)],
}


def _run(path, traced):
    X, y = _data()
    gp = GP(kind="matern32", device="cpu")
    if not traced:
        return PATHS[path](gp, X, y)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = PATHS[path](gp, X, y)
    return out, prof


def _empty_session():
    """A profiler session that records nothing: afterwards the record is
    empty, whatever an earlier session left."""
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.spans() == [] and profiling.counts() == {}


@pytest.mark.parametrize("path", list(PATHS))
def test_without_a_session_nothing_is_recorded_and_no_bit_changes(path):
    _empty_session()
    plain = _run(path, traced=False)
    assert profiling.spans() == [] and profiling.counts() == {}
    assert profiling.span_ms("cugp.step") is None
    traced, _ = _run(path, traced=True)
    assert profiling.spans()
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_nest_under_their_step_or_request(path):
    _run(path, traced=True)
    spans = profiling.spans()
    got = [(s.name, s.parent.name if s.parent else None) for s in spans]
    assert got == EXPECTED[path]
    roots = [s for s in spans if s.parent is None]
    assert len({s.op for s in roots}) == len(roots)
    for s in spans:
        root = s
        while root.parent is not None:
            root = root.parent
        assert s.op == root.op is not None
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            assert s.parent.t0_ns <= s.t0_ns and s.t1_ns <= s.parent.t1_ns
    # the children's host time lies inside their roots'
    root_ms = profiling.span_ms(roots[0].name)
    assert root_ms == pytest.approx(sum(s.ms for s in roots))
    assert profiling.span_ms("cugp.no_such_span") == 0.0


def test_host_reads_are_counted_where_they_are_made():
    (_, iters, *_), _ = _run("fit_iterative", traced=True)
    # CG tests convergence once before each iteration and once after the
    # last (none hit max_iters); the step's value is read once
    assert int(iters.max()) < 200
    assert profiling.counts() == {
        "host_read.cg_converged": int(iters.sum()) + STEPS,
        "host_read.fit_iterative_value": STEPS}
    _run("fit", traced=True)
    # the finite guard and the jitter ladder's one level, a step, and the
    # LML's backward
    assert profiling.counts() == {"host_read.finite_guard": STEPS,
                                  "host_read.chol_ladder": STEPS,
                                  "lml_backward.closed_form": STEPS}
    # the first request factors: the ladder's read and a miss of the kept
    # factor; a second request on the same state hits it and reads nothing
    _run("predict", traced=True)
    assert profiling.counts() == {"host_read.chol_ladder": 1,
                                  "factor_cache.miss": 1}
    _run("predict_twice", traced=True)
    assert profiling.counts() == {"host_read.chol_ladder": 1,
                                  "factor_cache.miss": 1,
                                  "factor_cache.hit": 1}
    X, y = _data()
    with profile(activities=[ProfilerActivity.CPU]):
        GP(kind="matern32", device="cpu", normalize_y=True).condition(X, y)
    assert profiling.counts() == {"host_read.normalize_y": 2}


@pytest.mark.parametrize("basis", [None, "constant"])
def test_each_step_counts_the_backward_rule_it_took(basis):
    """GP.fit on the plain LML takes the closed-form backward once a step,
    inside ``cugp.chol_backward``; the basis objective differentiates L
    itself and takes Murray's rule (its n x n factor and the m_b x m_b
    one: two a step)."""
    X, y = _data()
    gp = GP(kind="matern32", device="cpu", basis=basis)
    with profile(activities=[ProfilerActivity.CPU]):
        gp.fit(X, y, steps=STEPS, learning_rate=0.1)
    counts = profiling.counts()
    spans = [s for s in profiling.spans() if s.name == "cugp.chol_backward"]
    assert all(s.parent.name == "cugp.step" for s in spans)
    if basis is None:
        assert counts.get("lml_backward.closed_form", 0) == STEPS
        assert counts.get("lml_backward.murray", 0) == 0
        assert len(spans) == STEPS
    else:
        assert counts.get("lml_backward.closed_form", 0) == 0
        assert counts.get("lml_backward.murray", 0) == 2 * STEPS
        assert len(spans) == 2 * STEPS


def test_stamps_share_the_chrome_traces_clock(tmp_path):
    _, prof = _run("fit", traced=True)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        raw = json.load(f)
    base = raw["baseTimeNanoseconds"]
    events = sorted((e for e in raw["traceEvents"]
                     if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("cugp.")),
                    key=lambda e: e["ts"])
    spans = sorted(profiling.spans(), key=lambda s: s.t0_ns)
    assert [e["name"] for e in events] == [s.name for s in spans]
    for e, s in zip(events, spans):
        t0 = base + e["ts"] * 1e3
        t1 = t0 + e["dur"] * 1e3
        assert abs(t0 - s.t0_ns) < 1e6 and abs(t1 - s.t1_ns) < 1e6


def test_a_new_session_holds_only_its_own_record():
    _run("fit", traced=True)
    first = profiling.spans()
    assert profiling.counts()["host_read.finite_guard"] == STEPS
    _run("predict", traced=True)
    second = profiling.spans()
    assert [s.name for s in second] == [n for n, _ in EXPECTED["predict"]]
    assert not set(map(id, first)) & set(map(id, second))
    assert profiling.counts() == {"host_read.chol_ladder": 1,
                                  "factor_cache.miss": 1}
    assert second[0].op == 0  # ids start again with the session


def test_a_span_on_another_thread_finds_its_step():
    """Autograd runs a CUDA backward on a thread of its own: the span
    opened there belongs to the step open on the caller's thread."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("cugp.step", root=True):
            def work():
                with profiling.span("cugp.chol_backward"):
                    profiling.count("host_read.test")
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    step, child = profiling.spans()
    assert child.parent is step and child.op == step.op == 0
    assert profiling.counts() == {"host_read.test": 1}


def _sharded_step():
    """One sharded Adam step of the distributed tier in a world of one
    rank (make_mesh without a process group: every collective returns
    its input), on the block-cyclic layout with several blocks."""
    from cugp_tpu_torch.ops import kernels as kops
    from cugp_tpu_torch.parallel import gspmd, mesh as mesh_lib

    X, y = _data()
    step, tx = gspmd.make_map_train_step(mesh_lib.make_mesh(),
                                         kind="matern32", chunk=32,
                                         lml_backend="chunked")
    state = tx.init(kops.init_params(d=3))
    params, state, loss = step(state.params, state, X, y)
    return [loss, *params.values()]


def test_sharded_step_records_its_spans_and_collectives():
    """The sharded step is a ``cugp.step`` holding the distributed LML's
    ``cugp.factorize`` and its closed-form backward ``cugp.chol_backward``
    (counted as ``lml_backward.distributed``), with every collective's
    bytes counted (a group of one moves 0); without a session it records
    nothing and gives the same bits."""
    _empty_session()
    plain = _sharded_step()
    assert profiling.spans() == [] and profiling.counts() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _sharded_step()
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    got = [(s.name, s.parent.name if s.parent else None)
           for s in profiling.spans()]
    assert got == [("cugp.step", None), ("cugp.factorize", "cugp.step"),
                   ("cugp.chol_backward", "cugp.step")]
    counts = profiling.counts()
    assert counts["lml_backward.distributed"] == 1
    moved = {k: v for k, v in counts.items()
             if k.startswith("collective_bytes.")}
    assert {"collective_bytes.all_gather", "collective_bytes.broadcast",
            "collective_bytes.all_reduce"} <= set(moved)
    assert all(v == 0 for v in moved.values())
