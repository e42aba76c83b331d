"""PlanServer of the port (``repro_torch.serve.planserver``) on the CPU,
held against the JAX package's.

Fingerprints are bitwise ``repro``'s; every test of
``tests/unit/test_planserver.py`` and the two PlanServer tests of
``tests/unit/test_obs.py`` run on the port with ``backend="torch-fused"``
and ``device="cpu"`` (the captured step program's eager twin), their Plans
held to ``repro``'s NumPy solver.  ``repro``'s own server cannot dispatch
where ``jax.experimental`` has no ``enable_x64`` (its ``_solve_batch``
imports ``repro.opt.gia_jax``); with that module stubbed in
``sys.modules`` it runs ``backend="numpy"`` beside the port's on the same
queued trace.  The small signature (N = 4, dim = 1024) is the one the
other solver tests use, so the fused programs are shared.
"""
import collections
import dataclasses
import functools
import sys
import threading
import types

import numpy as np
import pytest
import torch

import repro.api as R
import repro.serve.planserver as RS
from repro.opt import solve_param_opt_batched as r_batched
import repro_torch.api as P
import repro_torch.serve.planserver as PS
from repro_torch import obs
from repro_torch.opt import RefreshPlan, solve_param_opt_batched
from repro_torch.opt import gia_fused
from repro_torch.opt.structure import structure_signature
from tests.test_torch_slice import _equal_plans
from tests.test_torch_solver import assert_plan_targets

CONSTS = dict(L=0.084, sigma=33.18, G=33.63, f_gap=2.3, N=4)
STEPS = {"C": ("ConstantRule", (0.01,)),
         "E": ("ExponentialRule", (0.02, 0.9995)),
         "D": ("DiminishingRule", (0.02, 600.0)), "J": None}
FAULTY = dict(straggler_prob=0.3, straggler_factor=4.0, crash_prob=0.1,
              crash_rounds=2, corrupt_prob=0.05, deadline_slack=1.5)


@pytest.fixture(autouse=True)
def one_thread():
    """The solver's tensors are a few rows wide: intra-op threads only add
    overhead on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenario(mod, C_max=0.25, m="C", family="genqsgd", T_max=1e5, **kw):
    step = STEPS[m]
    step = None if step is None else getattr(mod, step[0])(*step[1])
    return mod.Scenario(system=mod.EdgeSystem.paper_sec_vii(dim=1024, N=4),
                        consts=mod.MLProblemConstants(**CONSTS), T_max=T_max,
                        C_max=C_max, family=family, step=step, **kw)


def _server(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("window_s", 0.01)
    kw.setdefault("device", "cpu")
    return PS.PlanServer(**kw)


@functools.lru_cache(maxsize=None)
def ref_plan(C_max=0.25, m="C", family="genqsgd", tol=1e-4):
    """``repro``'s ``Scenario.optimize()`` (the NumPy solver), once."""
    return scenario(R, C_max=C_max, m=m, family=family).optimize(tol=tol)


def _same_key(p, r):
    assert (p.K0, p.B, p.Kn) == (r.K0, r.B, r.Kn)


def _result(srv, h):
    """The converged GIA result the server cached for ``h``."""
    return srv.cache.get(h.sig, h.fp).result


def mod_serve(mod):
    return PS if mod is P else RS


def _poison(C_max=0.27):
    """A queued request whose warm seed has the wrong shape."""
    s = scenario(P, C_max=C_max)
    prob = s.problem(P.Objective.CONSTANT)
    bad = PS.PlanHandle(s, P.Objective.CONSTANT, prob,
                        structure_signature(prob), PS.fingerprint(prob),
                        b"x")
    bad.source = "warm"
    bad.z0 = np.zeros(3)                         # wrong-shape seed: poison
    return bad


# ---------------------------------------------------------------------------
# fingerprints: bitwise the JAX package's
# ---------------------------------------------------------------------------
_FP_CASES = {
    "C": {}, "E": dict(m="E"), "D": dict(m="D"), "J": dict(m="J"),
    "gqfedwavg": dict(family="gqfedwavg"),
    "uniform2": dict(sampling="uniform2"), "edge": dict(faults="edge")}


def _fp_scenario(mod, case, C_max=0.25):
    kw = dict(_FP_CASES[case])
    if kw.get("sampling") == "uniform2":
        kw["sampling"] = mod.uniform(S=2)
    if kw.get("faults") == "edge":
        kw["faults"] = mod.edge_faults(**FAULTY)
    return scenario(mod, C_max=C_max, **kw)


@pytest.mark.parametrize("case", list(_FP_CASES))
def test_fingerprints_bitwise_repro(case):
    pv, rv = ([mod_serve(mod).fingerprint(_fp_scenario(mod, case).problem())
               for mod in (P, R)])
    assert pv.dtype == rv.dtype and pv.tobytes() == rv.tobytes()
    assert PS._quantize(pv) == RS._quantize(rv)
    pn, rn = ([mod_serve(mod).fingerprint(
        _fp_scenario(mod, case, C_max=0.2501).problem()) for mod in (P, R)])
    assert pn.tobytes() == rn.tobytes()
    d = PS.fingerprint_distance(pn, pv)
    assert d == RS.fingerprint_distance(rn, rv) and 0.0 < d < 1e-3


# ---------------------------------------------------------------------------
# tests/unit/test_planserver.py, ported
# ---------------------------------------------------------------------------
def test_fingerprint_identity_and_distance():
    a = PS.fingerprint(scenario(P, C_max=0.25).problem())
    a2 = PS.fingerprint(scenario(P, C_max=0.25).problem())
    b = PS.fingerprint(scenario(P, C_max=0.2501).problem())
    far = PS.fingerprint(scenario(P, C_max=0.4).problem())
    assert np.array_equal(a, a2)
    assert PS._quantize(a) == PS._quantize(a2)
    assert PS._quantize(a) != PS._quantize(b)
    assert PS.fingerprint_distance(a, a) == 0.0
    # a 0.04% budget nudge is a *near* neighbor, a 60% change is not
    assert 0.0 < PS.fingerprint_distance(b, a) < 1e-3
    assert PS.fingerprint_distance(far, a) > 0.05


def test_plan_cache_lru_eviction():
    cache = PS.PlanCache(maxsize=2)
    vecs = [np.array([float(i)]) for i in range(3)]
    for i, v in enumerate(vecs):
        cache.put(("sig",), PS._quantize(v), PS._CacheEntry(v, result=i))
    assert len(cache) == 2
    assert cache.get(("sig",), PS._quantize(vecs[0])) is None    # evicted
    assert cache.get(("sig",), PS._quantize(vecs[2])).result == 2
    # touching an entry protects it from the next eviction
    cache.get(("sig",), PS._quantize(vecs[1]))
    v3 = np.array([3.0])
    cache.put(("sig",), PS._quantize(v3), PS._CacheEntry(v3, result=3))
    assert cache.get(("sig",), PS._quantize(vecs[1])) is not None
    assert cache.get(("sig",), PS._quantize(vecs[2])) is None
    # nearest() only sees surviving entries of the signature
    near, d = cache.nearest(("sig",), np.array([2.9]))
    assert near.result == 3 and d == pytest.approx(0.1 / 4.0)
    assert cache.nearest(("other",), v3)[0] is None


def test_server_micro_batches_one_signature_one_compile():
    """Concurrent same-signature requests coalesce into micro-batches,
    solve in one padded fused dispatch each, and the whole stream pays at
    most one build of the step program (it may be inherited from an
    earlier test — hence <=)."""
    budgets = [0.22, 0.24, 0.26, 0.3]
    with _server(window_s=0.05) as srv:
        handles = [srv.submit(scenario(P, C_max=c)) for c in budgets]
        plans = [h.result(timeout=300) for h in handles]
    for c, p, h in zip(budgets, plans, handles):
        assert p.feasible and p.converged
        assert h.source == "cold" and h.batch_size == 4
        _same_key(p, ref_plan(c))
    st = srv.stats()
    assert st["submitted"] == 4 and st["cold"] == 4 and st["batches"] == 1
    assert all(c <= 1 for c in srv.compile_counts().values())


def test_exact_hit_serves_cached_plan_without_solving():
    with _server() as srv:
        p1 = srv.solve(scenario(P, C_max=0.25))
        h = srv.submit(scenario(P, C_max=0.25))     # identical fingerprint
        assert h.done() and h.source == "hit"
        p2 = h.result()
        assert dataclasses.asdict(p1) == dataclasses.asdict(p2)
        st = srv.stats()
        assert st["hits"] == 1 and st["batches"] == 1    # no second solve
        assert st["hit_rate"] == pytest.approx(0.5)
    _equal_plans(ref_plan(0.25), p1)


def test_warm_request_seeds_from_neighbor_and_matches_cold():
    with _server(tol=1e-8) as srv:
        cold = srv.solve(scenario(P, C_max=0.25))
        h = srv.submit(scenario(P, C_max=0.25005))   # 0.02% away: warm
        warm = h.result(timeout=300)
        assert h.source == "warm" and h.warm_dist < 1e-3
        assert h.z0 is not None
        got = _result(srv, h)
    # a from-scratch solve of the same scenario lands on the same point
    ref = ref_plan(0.25005, tol=1e-8)
    _same_key(warm, ref)
    assert warm.predicted_E == pytest.approx(ref.predicted_E, rel=1e-6)
    assert cold.feasible and warm.feasible
    # and the warm row is the NumPy solver's from the same seed
    rprob = scenario(R, C_max=0.25005).problem()
    assert_plan_targets(r_batched([rprob], z0s=[h.z0], tol=1e-8,
                                  backend="numpy"), [got])


def test_optimize_server_kwarg_routes_through_server():
    with _server() as srv:
        direct = scenario(P, C_max=0.27).optimize()
        served = scenario(P, C_max=0.27).optimize(server=srv)
        _same_key(served, direct)
        assert srv.stats()["submitted"] == 1
    _same_key(served, ref_plan(0.27))


def test_closed_server_rejects_and_drains():
    srv = _server(window_s=5.0)                  # window >> test: close()
    h = srv.submit(scenario(P, C_max=0.25))      # must force the drain
    srv.close()
    assert h.done() and h.result().feasible
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(scenario(P, C_max=0.3))


def test_failed_batch_resolves_handles_with_error():
    """A solver exception must resolve every handle of the batch with the
    error message — never leave a caller blocked on a dead batch."""
    bad = _poison(C_max=0.25)
    with _server() as srv:                       # raises inside the batch
        with srv._cond:
            srv._queues.setdefault(bad.sig,
                                   collections.deque()).append(bad)
            srv._cond.notify_all()
        with pytest.raises(RuntimeError, match="shape"):
            bad.result(timeout=300)
        assert bad.error is not None


def test_poison_request_batch_resolves_healthy_peers():
    """One poison row in a micro-batch (a wrong-shape warm seed: the fused
    solver raises on it, on the host) does not take its healthy peers
    down: the batch is bisected, every healthy row solves, the poison row
    is quarantined, then errors — and no step program is built for it."""
    budgets = [0.22, 0.25, 0.3]
    key = RefreshPlan.build([scenario(P).problem()]).signature_key
    prog = gia_fused._PROGRAMS.get((key, 60, gia_fused._CHUNK, "cpu"))
    # the healthy rows build the padded shape if no earlier test did
    c0 = gia_fused.capture_count(key) + (prog is None or 4 not in prog.shapes)
    bad = _poison()
    srv = _server(window_s=0.2, retry_base_s=0.001, retry_cap_s=0.01,
                  start=False)
    healthy = [srv.submit(scenario(P, C_max=c)) for c in budgets]
    with srv._cond:                              # same queue, same batch
        srv._queues[bad.sig].insert(1, bad)
    with srv:
        plans = [h.result(timeout=300) for h in healthy]
        with pytest.raises(RuntimeError):
            bad.result(timeout=300)
    for c, p, h in zip(budgets, plans, healthy):
        assert p.feasible and h.converged
        _same_key(p, ref_plan(c))
    st = srv.stats()
    assert st["bisections"] >= 1                 # the batch was split
    assert st["quarantined"] == 1 and st["poisoned"] == 1
    assert bad.error is not None and not bad.converged
    assert gia_fused.capture_count(key) == c0


def test_cancel_pending_request_skipped_and_counted():
    srv = _server(window_s=0.2, start=False)     # dispatcher not running:
    keep = srv.submit(scenario(P, C_max=0.24))   # both requests stay queued
    drop = srv.submit(scenario(P, C_max=0.26))
    assert drop.cancel() is True
    assert drop.done() and drop.cancelled
    with pytest.raises(RuntimeError, match="cancelled"):
        drop.result()
    with srv:
        plan = keep.result(timeout=300)
    assert plan.feasible and keep.cancel() is False   # too late to cancel
    st = srv.stats()
    assert st["cancelled"] == 1
    assert st["batches"] == 1 and st["mean_batch"] == 1.0   # solo batch


def test_converged_surfaces_on_handle_and_stats():
    with _server() as srv:
        h1 = srv.submit(scenario(P, C_max=0.25))
        h1.result(timeout=300)
        assert h1.converged is True
        h2 = srv.submit(scenario(P, C_max=0.25))  # exact hit: cached result
        assert h2.source == "hit" and h2.converged is True
        assert srv.stats()["non_converged"] == 0
    # a solve stopped before convergence is surfaced, not cached
    with _server(max_iter=1) as srv:
        h = srv.submit(scenario(P, C_max=0.25))
        p = h.result(timeout=300)
        assert h.converged is False and p.converged is False
        st = srv.stats()
        assert st["non_converged"] == 1 and st["cache_entries"] == 0


@pytest.mark.serve
@pytest.mark.slow
def test_stream_mixed_signatures_and_joint_warm():
    """An interleaved stream over three signatures (m=C, m=J, gqfedwavg):
    every request returns its scenario's own plan, signatures never share a
    batch, and the trace pays <=1 program build per signature."""
    scens = []
    for c in (0.22, 0.25, 0.3):
        scens.append(scenario(P, C_max=c))
        scens.append(scenario(P, C_max=c, m="J"))
        scens.append(scenario(P, C_max=c, family="gqfedwavg"))
    with _server(max_batch=3, window_s=0.05) as srv:
        handles = [srv.submit(s) for s in scens]
        plans = [h.result(timeout=600) for h in handles]
        # warm round: jitter every budget by 0.1%
        warm_handles = [srv.submit(dataclasses.replace(
            s, C_max=s.C_max * 1.001)) for s in scens]
        warm_plans = [h.result(timeout=600) for h in warm_handles]
    for s, p in zip(scens, plans):
        ref = ref_plan(s.C_max, "J" if s.step is None else "C", s.family)
        assert (p.K0, p.B) == (ref.K0, ref.B)
    assert all(h.source == "warm" for h in warm_handles)
    assert all(h.batch_size <= 3 for h in handles + warm_handles)
    for p in warm_plans:
        assert p.feasible
    st = srv.stats()
    assert st["signatures"] == 3
    assert all(c <= 1 for c in srv.compile_counts().values())


def test_sampled_and_full_scenarios_key_separate_pools():
    """A sampled Scenario (same m/family/N) gets its own signature, queue,
    and cache pool: identical budgets on a full and a uniform(S=2)
    scenario may NOT cross-serve each other's cached plans."""
    full = scenario(P, C_max=0.25)
    samp = dataclasses.replace(full, sampling=P.uniform(S=2))
    sig_f = structure_signature(full.problem())
    sig_s = structure_signature(samp.problem())
    assert sig_f != sig_s
    with _server(backend="numpy") as srv:
        p_full = srv.solve(full)
        h = srv.submit(samp)                 # same budgets, sampled model
        p_samp = h.result(timeout=300)
        assert h.source == "cold"            # NOT served from the full pool
        assert p_full.cohort_S is None and p_samp.cohort_S == 2
        st = srv.stats()
        assert st["signatures"] == 2 and st["hits"] == 0
    # neutral uniform(S=N) folds back into the full pool (("full",) key)
    neut = dataclasses.replace(full, sampling=P.uniform(S=4))
    assert structure_signature(neut.problem()) == sig_f
    rfull = scenario(R, C_max=0.25)
    _equal_plans(dataclasses.replace(rfull, sampling=R.uniform(S=2))
                 .optimize(), p_samp)


def test_concurrent_submitters_keep_the_counts():
    """Eight threads submit at once (a warm row each, then exact hits of
    one cached solve) against the dispatcher, with a short switch
    interval: every request resolves and no count or gauge loses an
    update."""
    base = scenario(P, C_max=0.25)
    per, n_threads = 8, 8
    interval = sys.getswitchinterval()
    with _server(backend="numpy") as srv:
        srv.solve(base)
        handles = [[] for _ in range(n_threads)]

        def submit(i):
            for k in range(per):
                c = 0.25 * (1 + 1e-4 * (1 + i)) if k == 0 else 0.25
                handles[i].append(srv.submit(dataclasses.replace(base,
                                                                 C_max=c)))

        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(interval)
        for hs in handles:
            for h in hs:
                assert h.result(timeout=300).feasible
    st = srv.stats()
    total = 1 + per * n_threads
    assert st["submitted"] == total
    assert st["hits"] == (per - 1) * n_threads
    assert st["hits"] + st["warm"] + st["cold"] == total
    assert st["queue_depth"] == 0 and st["inflight"] == 0
    assert st["latency_s"]["all"]["count"] == total


# ---------------------------------------------------------------------------
# tests/unit/test_obs.py's PlanServer tests, ported
# ---------------------------------------------------------------------------
def test_planserver_stats_and_spans():
    obs.enable(reset=True)
    try:
        with _server() as srv:
            h1 = srv.submit(scenario(P, C_max=0.25))
            h1.result(timeout=300)
            h2 = srv.submit(scenario(P, C_max=0.25))  # hit
            h2.result(timeout=300)
            st = srv.stats()
        evs = obs.TRACER.events()
    finally:
        obs.disable()
        obs.TRACER.clear()
        obs.REGISTRY.reset()

    for k in ("submitted", "hits", "warm", "cold", "hit_rate", "batches",
              "mean_batch", "cancelled", "bisections", "quarantined",
              "poisoned", "non_converged", "signatures", "cache_entries",
              "compiles"):
        assert k in st, k
    assert st["submitted"] == 2 and st["hits"] == 1
    # live gauges (drained server: all idle) + latency summaries
    assert st["queue_depth"] == 0 and st["inflight"] == 0
    assert isinstance(st["queue_depth"], int)
    assert st["latency_s"]["all"]["count"] == 2
    assert st["latency_s"]["hit"]["count"] == 1
    assert st["latency_s"]["hit"]["p50"] <= st["latency_s"]["all"]["max"]
    assert st["queue_wait_s"]["count"] >= 1

    # queue -> solve async pairs are balanced and the batch span is present
    names = {e["name"] for e in evs}
    assert {"planserver.queue", "planserver.solve",
            "planserver.batch"} <= names
    for nm in ("planserver.queue", "planserver.solve"):
        b = sum(1 for e in evs if e["name"] == nm and e["ph"] == "b")
        e_ = sum(1 for e in evs if e["name"] == nm and e["ph"] == "e")
        assert b == e_ > 0, (nm, b, e_)
    assert any(e["name"] == "planserver.hit" and e["ph"] == "i"
               for e in evs)


def test_planserver_measures_even_with_global_obs_off():
    """stats() is public API: the server's own registry is always on."""
    assert not obs.enabled()
    n0 = len(obs.TRACER)
    with _server(max_batch=2) as srv:
        srv.solve(scenario(P, C_max=0.25))
        st = srv.stats()
    assert st["submitted"] == 1 and st["latency_s"]["all"]["count"] == 1
    # ...but the global tracer stayed empty (no span leaks while off)
    assert len(obs.TRACER) == n0


# ---------------------------------------------------------------------------
# repro's own PlanServer beside the port's, on one queued trace
# ---------------------------------------------------------------------------
def _trace(mod):
    """Four signatures (genqsgd at m = C and D, pm and fa at m = C) at one
    budget each, a repeat of the first and a 0.1 % jitter of the last,
    queued before the server starts (all cold); then every base scenario
    again (hits) and a -0.1 % jitter of each (warm), submitted while the
    dispatcher waits on the queue's lock."""
    base = [scenario(mod, C_max=0.25, m=m) for m in "CD"]
    base += [scenario(mod, C_max=0.25, family=f) for f in ("pm", "fa")]
    wave = base + [base[0], dataclasses.replace(base[3], C_max=0.25 * 1.001)]
    return wave, base + [dataclasses.replace(s, C_max=0.25 * 0.999)
                         for s in base]


def _run_trace(mod, srv):
    first, second = _trace(mod)
    handles = [srv.submit(s) for s in first]
    srv.start()
    plans = [h.result(timeout=300) for h in handles]
    with srv._cond:                  # the dispatcher sees the whole wave
        more = [srv.submit(s) for s in second]
    plans += [h.result(timeout=300) for h in more]
    srv.close()
    return handles + more, plans, srv.stats()


def test_repro_planserver_and_port_agree(monkeypatch):
    stub = types.ModuleType("repro.opt.gia_jax")
    stub.trace_count = lambda key: 0
    monkeypatch.setitem(sys.modules, "repro.opt.gia_jax", stub)
    kw = dict(max_batch=4, window_s=0.01, backend="numpy", start=False)
    rh, rp, rst = _run_trace(R, RS.PlanServer(**kw))
    ph, pp, pst = _run_trace(P, PS.PlanServer(**kw))
    assert [h.source for h in ph] == [h.source for h in rh]
    assert {h.source for h in ph} == {"cold", "hit", "warm"}
    assert [h.batch_size for h in ph] == [h.batch_size for h in rh]
    assert [h.warm_dist for h in ph] == [h.warm_dist for h in rh]
    assert [h.converged for h in ph] == [h.converged for h in rh]
    for a, b in zip(rp, pp):
        _equal_plans(a, b)
    assert pst.keys() == rst.keys()
    for k in ("latency_s", "queue_wait_s"):
        assert {s: v["count"] for s, v in pst[k].items()
                if isinstance(v, dict)} == \
            {s: v["count"] for s, v in rst[k].items() if isinstance(v, dict)}
        pst.pop(k), rst.pop(k)
    assert pst == rst
    assert all(c == 0 for c in pst["compiles"].values())


# ---------------------------------------------------------------------------
# the port's own: device refusal, host-side poison, capture failure
# ---------------------------------------------------------------------------
def test_device_refusals_come_at_construction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = threading.active_count()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        PS.PlanServer()                              # torch-fused, "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        PS.PlanServer(backend="torch", device="cuda:0", start=False)
    with pytest.raises(RuntimeError):
        PS.PlanServer(device="no-such-device")
    with pytest.raises(ValueError, match="'torch-fused'"):
        PS.PlanServer(backend="jnp-fused", device="cpu")
    with pytest.raises(ValueError, match="'torch'"):
        PS.PlanServer(backend="jnp", device="cpu")
    with pytest.raises(ValueError, match="unknown solver backend"):
        PS.PlanServer(backend="fused", device="cpu")
    assert threading.active_count() == n            # no dispatcher started
    # the host solver reads no device
    PS.PlanServer(backend="numpy", start=False).close()
    assert P.PlanServer is PS.PlanServer


def test_wrong_shape_seed_fails_on_the_host():
    """A wrong-shape warm seed raises before any program or device call:
    no program is made or looked up, and no build is counted."""
    prob = scenario(P, C_max=0.27).problem()
    key = RefreshPlan.build([prob]).signature_key
    c0, info0 = gia_fused.capture_count(key), gia_fused.compile_cache_info()
    for z0s in ([np.zeros(3)], [None, np.zeros(3)]):
        probs = [prob] * len(z0s)
        with pytest.raises(ValueError, match=r"shape \(3,\)"):
            solve_param_opt_batched(probs, z0s=z0s, backend="torch-fused",
                                    pad_to=4, device="cpu")
    assert gia_fused.capture_count(key) == c0
    info = gia_fused.compile_cache_info()
    assert (info.hits, info.misses) == (info0.hits, info0.misses)


def test_failed_first_run_leaves_no_shape(monkeypatch):
    """A step program that fails at a new padded shape keeps no shape and
    counts no build, releases its lock, and builds cleanly next time."""
    probs = [scenario(P, C_max=c).problem() for c in (0.23, 0.29)]
    rprobs = [scenario(R, C_max=c).problem() for c in (0.23, 0.29)]
    seeds = [r.z for r in r_batched(rprobs, backend="numpy")]
    key = RefreshPlan.build(probs).signature_key
    rows = 5                                   # a shape no other test uses
    c0 = gia_fused.capture_count(key)
    real = gia_fused._Program.step

    def broken(self, st, inp):
        raise RuntimeError("step failed")

    monkeypatch.setattr(gia_fused._Program, "step", broken)
    with pytest.raises(RuntimeError, match="step failed"):
        solve_param_opt_batched(probs, z0s=seeds, backend="torch-fused",
                                pad_to=rows, device="cpu")
    prog, = [p for k, p in gia_fused._PROGRAMS.items()
             if k == (key, 60, gia_fused._CHUNK, "cpu")]
    assert rows not in prog.shapes and gia_fused.capture_count(key) == c0
    assert not prog.lock.locked() and not gia_fused._CAPTURE_LOCK.locked()
    monkeypatch.setattr(gia_fused._Program, "step", real)
    got = solve_param_opt_batched(probs, z0s=seeds, backend="torch-fused",
                                  pad_to=rows, device="cpu")
    assert rows in prog.shapes and gia_fused.capture_count(key) == c0 + 1
    assert_plan_targets(r_batched(rprobs, z0s=seeds, backend="numpy"), got)

