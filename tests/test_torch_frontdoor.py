"""The port's front door against the JAX package (``tests/test_frontdoor.py``).

- :class:`FairScheduler`, :class:`FifoScheduler` and
  :class:`AdmissionController` are pure host policy: one seeded script of
  submissions, ticks, pops, requeues, removals, expiries and victim
  picks goes through the reference's objects and the port's, and every
  decision (pop order, victims, expiries, ``max_delay_ticks``, the
  virtual clocks, rejection reasons) must be identical;
- ``SamplingParams`` refuses what the reference refuses;
- cancellation and deadlines on the engine, on a clock both engines
  read the same: the same finish reasons, tokens, drop and completion
  counters, the blocks released and a clean ``audit()``;
- a sampling mix in one batch: greedy and ``top_k=1`` requests give the
  JAX engine's tokens exactly, a top-k request's tokens lie in the JAX
  model's top-k set, and first tokens drawn at temperature 0.8 under
  top-k 5 follow the JAX model's filtered softmax (chi-square);
- :class:`FrontDoor` (port only, its engine held to the JAX one above):
  submissions from two threads mid-flight, streaming, cancel and
  deadline, backpressure, an idle engine woken by a late submission,
  pump death unblocking every handle, and a concurrent double stop.

Every wait on a thread or a handle has an explicit timeout.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
from paddle_tpu.inference.frontend import AdmissionController as JaxAdmission
from paddle_tpu.inference.frontend import AdmissionRejected as JaxRejected
from paddle_tpu.inference.frontend import FairScheduler as JaxFair
from paddle_tpu.inference.frontend import FifoScheduler as JaxFifo
from paddle_tpu.inference.frontend import SamplingParams as JaxSampling
from paddle_tpu.inference.frontend import Tenant as JaxTenant
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference.frontend import (AdmissionController,
                                                 AdmissionRejected,
                                                 FairScheduler, FifoScheduler,
                                                 FrontDoor, SamplingParams,
                                                 Tenant)
from test_torch_serving import models  # noqa: F401  (fixture)

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

PROMPTS = [[5, 9, 2, 11, 4, 7, 8, 3] * 3, [3, 3, 7, 1, 8, 2, 9, 4] * 2,
           [17, 23, 2, 9, 14, 6, 1, 12, 4], [1, 2, 3, 4, 5, 6, 7, 8] * 3]
KW = dict(max_batch_slots=3, max_len=64, prefill_chunk=16, seed=7,
          block_size=8)


# ------------------------------------------------------- scheduler policy
def _reqs(seed, n=40):
    """Request stand-ins (only the fields the policies read), one list
    per package."""
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        arrival = float(rs.randint(0, 12)) * 0.5
        rows.append(dict(
            prompt=[1] * int(rs.randint(1, 30)),
            max_new_tokens=int(rs.randint(1, 30)), arrival_time=arrival,
            deadline=(arrival + float(rs.randint(1, 16)) * 0.5
                      if rs.rand() < 0.3 else None),
            tenant=["paid", "free", "batch", "stranger"][rs.randint(4)],
            priority=(int(rs.randint(0, 3)) if rs.rand() < 0.2 else None),
            kind="generate", id=-1))
    return [[SimpleNamespace(**r) for r in rows] for _ in range(2)]


def _drive(sched, reqs, seed):
    """One seeded op script through ``sched``; returns the log of every
    decision, as request indices."""
    idx = {id(r): i for i, r in enumerate(reqs)}
    ops = np.random.RandomState(100 + seed).randint(0, 8, size=400)
    picks = np.random.RandomState(200 + seed).randint(0, 1 << 30, size=400)
    log, popped, nxt, seq = [], [], 0, 0
    for step, (op, pick) in enumerate(zip(ops, picks)):
        now = step * 0.1
        sched.on_tick(now)
        if op in (0, 1) and nxt < len(reqs):
            sched.submit(reqs[nxt])
            nxt += 1
        elif op in (2, 3):
            r = sched.next_due(now)
            log.append(("due", None if r is None else idx[id(r)]))
            if r is not None:
                sched.pop(r)
                popped.append((r, seq))
                seq += 1
        elif op == 4 and popped:
            r, _ = popped.pop(pick % len(popped))
            sched.requeue(r)
            log.append(("requeue", idx[id(r)]))
        elif op == 5:
            pend = sched.pending()
            if pend:
                r = pend[pick % len(pend)]
                log.append(("remove", idx[id(r)], sched.remove(r)))
            log.append(("expired", sorted(idx[id(r)]
                                          for r in sched.pop_expired(now))))
        elif op == 6 and popped:
            cands = [(i, r, s) for i, (r, s) in enumerate(popped)]
            v = sched.select_victim(cands, now)
            log.append(("victim", v, idx[id(popped[v][0])]))
        log.append(("state", sched.depth(), sched.due_count(now),
                    sched.next_arrival(now),
                    sorted(idx[id(r)] for r in sched.pending())))
        if hasattr(sched, "tenant_depth"):
            log.append(("tenant_depth", [sched.tenant_depth(t) for t in
                                         ("paid", "free", "batch",
                                          "stranger")]))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_scheduler_decides_as_the_reference(seed):
    """Pop order, expiries, victims, removals, depths, the counted delay
    per tier, admissions per tenant and the virtual clocks: equal to the
    reference's on one seeded script (a starvation bound of 5 ticks, so
    it binds)."""
    jr, pr = _reqs(seed)

    def tenants(T):
        return [T("paid", weight=4.0, tier=0), T("free", weight=1.0, tier=1),
                T("batch", weight=2.0, tier=1, max_queue_depth=3)]

    js = JaxFair(tenants(JaxTenant), starvation_bound=5)
    ps = FairScheduler(tenants(Tenant), starvation_bound=5)
    assert _drive(ps, pr, seed) == _drive(js, jr, seed)
    assert ps.max_delay_ticks == js.max_delay_ticks
    assert ps.admitted_by_tenant == js.admitted_by_tenant
    assert ps._vtime == js._vtime and ps._vfloor == js._vfloor
    assert sorted(ps.tenants) == sorted(js.tenants)


def test_fifo_scheduler_decides_as_the_reference():
    jr, pr = _reqs(3)
    assert _drive(FifoScheduler(), pr, 3) == _drive(JaxFifo(), jr, 3)


def test_tenant_and_scheduler_refusals_match_the_reference():
    for T, F in ((Tenant, FairScheduler), (JaxTenant, JaxFair)):
        with pytest.raises(ValueError, match="weight must be > 0"):
            T("x", weight=0.0)
        with pytest.raises(ValueError, match="tier must be >= 0"):
            T("x", tier=-1)
        with pytest.raises(ValueError, match="starvation_bound"):
            F(starvation_bound=0)
        with pytest.raises(ValueError, match="duplicate tenant"):
            F([T("a"), T("a")])


def test_admission_rejects_as_the_reference():
    """The same submissions and pops through both controllers: the same
    accepted requests and the same rejection reasons and tenants."""
    rs = np.random.RandomState(5)
    script = [(["paid", "free", "capped", "other"][rs.randint(4)],
               rs.rand() < 0.3) for _ in range(120)]

    def run(T, F, A, Rej):
        sched = F([T("paid"), T("capped", max_queue_depth=1)])
        adm = A(max_queue_depth=6, max_tenant_depth=2)
        out = []
        for tenant, pop in script:
            if pop:
                r = sched.next_due(1e9)
                if r is not None:
                    sched.pop(r)
                out.append(("pop", None if r is None else r.tenant))
                continue
            try:
                adm.check(sched, tenant)
            except Rej as e:
                out.append(("rejected", e.reason, e.tenant, str(e)))
                continue
            sched.submit(SimpleNamespace(
                prompt=[1], max_new_tokens=1, arrival_time=0.0,
                deadline=None, tenant=tenant, priority=None,
                kind="generate"))
            out.append(("accepted", tenant))
        return out

    got = run(Tenant, FairScheduler, AdmissionController, AdmissionRejected)
    assert got == run(JaxTenant, JaxFair, JaxAdmission, JaxRejected)
    assert {g[1] for g in got if g[0] == "rejected"} == {
        "backpressure:global", "backpressure:tenant"}
    for A in (AdmissionController, JaxAdmission):
        with pytest.raises(ValueError, match="max_queue_depth"):
            A(max_queue_depth=0)
        with pytest.raises(ValueError, match="max_tenant_depth"):
            A(max_tenant_depth=0)


@pytest.mark.parametrize("bad", [dict(temperature=0.0),
                                 dict(temperature=-1.0), dict(top_k=0),
                                 dict(top_p=0.0), dict(top_p=1.5)])
def test_sampling_params_refuse_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        JaxSampling(**bad)
    with pytest.raises(ValueError) as got:
        SamplingParams(**bad)
    assert str(got.value) == str(want.value)
    assert SamplingParams(temperature=0.5, top_k=3, top_p=0.5, seed=1) \
        == SamplingParams(temperature=0.5, top_k=3, top_p=0.5, seed=1)


# ------------------------------------------- cancellation and deadlines
def _stepped(eng, t, hooks):
    """Drive ``eng`` one stepped tick at a time on the injected clock
    ``t`` (one unit a tick), calling ``hooks[step]`` between ticks."""
    step = 0
    while eng.scheduler.depth() or eng.active_count():
        if step in hooks:
            hooks[step]()
        eng.run(max_steps=1, keep_epoch=True)
        t[0] += 1.0
        step += 1
        assert step < 400


def _cancel_deadline_run(Eng, Req, model, sched, **kw):
    t = [0.0]
    eng = Eng(model, **KW, clock=lambda: t[0], scheduler=sched, **kw)
    mk = [dict(prompt=PROMPTS[0], max_new_tokens=12, tenant="paid"),
          dict(prompt=PROMPTS[1], max_new_tokens=12, tenant="free"),
          dict(prompt=PROMPTS[2], max_new_tokens=6, tenant="free"),
          dict(prompt=PROMPTS[3], max_new_tokens=10, tenant="paid",
               deadline=6.5),
          dict(prompt=PROMPTS[2], max_new_tokens=5, tenant="late",
               deadline=2.5),
          dict(prompt=PROMPTS[0][:9], max_new_tokens=8)]
    reqs = [eng.submit(Req(greedy=True, **kw)) for kw in mk]
    _stepped(eng, t, {
        # reqs[2] still queued, reqs[1] running
        3: lambda: (eng.cancel(reqs[2]), eng.cancel(reqs[1]))})
    reg = eng.telemetry.registry
    out = {
        "reasons": [r.finish_reason for r in reqs],
        "tokens": [r.tokens for r in reqs],
        "dropped": reg.get("serving_requests_dropped_total").snapshot(),
        "completed": reg.get("serving_requests_completed_total").snapshot(),
        "cancel_again": eng.cancel(reqs[2]),
        "free": eng._alloc.free_count() == eng._alloc.capacity,
        "audit": {k: v for k, v in eng.audit().items() if v},
    }
    tenants = eng.metrics.by_tenant()
    out["by_tenant"] = {k: (v["completed"], v["dropped"])
                        for k, v in tenants.items()}
    return out


@pytest.mark.parametrize("policy", ["fifo", "fair"])
def test_cancel_and_deadline_as_the_reference_engine(models, policy):
    """A queued and a running cancel, a queued and a running expiry, on a
    clock both engines read the same: the same finish reasons, greedy
    tokens, ``serving_requests_dropped_total`` and ``_completed_total``
    by reason, per-tenant completions and drops, and every block back
    with a clean audit."""
    jm, pm = models

    def sched(F, T):
        if policy == "fifo":
            return F()
        F = JaxFair if T is JaxTenant else FairScheduler
        return F([T("paid", weight=4.0, tier=0),
                  T("free", weight=1.0, tier=1)])

    want = _cancel_deadline_run(JaxEngine, JaxRequest, jm,
                                sched(JaxFifo, JaxTenant))
    got = _cancel_deadline_run(ServingEngine, Request, pm,
                               sched(FifoScheduler, Tenant)
                               if policy == "fifo"
                               else sched(FairScheduler, Tenant),
                               device="cpu")
    assert got == want
    assert "cancelled" in got["reasons"]
    assert "deadline_exceeded" in got["reasons"]
    assert got["free"] and not got["audit"]


def test_deadline_before_arrival_and_unsubmitted_cancel_refused(models):
    _, pm = models
    eng = ServingEngine(pm, **KW, device="cpu")
    with pytest.raises(ValueError, match="is not after arrival_time"):
        eng.submit(Request(prompt=[1, 2], deadline=1.0, arrival_time=2.0))
    with pytest.raises(ValueError, match="never submitted"):
        eng.cancel(Request(prompt=[1, 2]))


# ------------------------------------------------------------ sampling mix
MIX = [dict(greedy=True), dict(temperature=0.8),
       dict(sampling=SamplingParams(top_k=1, seed=4)),
       dict(temperature=0.8, top_k=5), dict(temperature=0.9, top_p=0.9)]
JAX_MIX = [dict(greedy=True), dict(temperature=0.8),
           dict(sampling=JaxSampling(top_k=1, seed=4)),
           dict(temperature=0.8, top_k=5), dict(temperature=0.9, top_p=0.9)]


def _jax_logits(jm, ids):
    """The JAX model's fp32 logits over ``ids``, teacher-forced. The row
    is padded to 40 tokens (the model is causal, so the padding changes
    no logit of ``ids``) so that every call has one shape."""
    row = np.zeros((1, 40), np.int32)
    row[0, :len(ids)] = ids
    out = jm(paddle.to_tensor(row))
    return np.asarray(out.value, np.float32)[0, :len(ids)]


def _mix_run(Eng, Req, model, mixes, **kw):
    eng = Eng(model, **{**KW, "max_batch_slots": 4}, **kw)
    reqs = [eng.submit(Req(prompt=p, max_new_tokens=10, **m))
            for p in PROMPTS[:2] for m in mixes]
    eng.run(max_steps=2000)
    assert all(r.status == "done" for r in reqs)
    return reqs


def test_sampling_mix_greedy_and_top1_exact_support_inside_topk(models):
    """One batch mixing greedy, temperature, top-k 1, top-k 5 and top-p
    0.9: greedy and top-k 1 requests give the JAX engine's tokens
    exactly (and each other's); every top-k 5 token lies in the JAX
    model's top-5 at its position, every top-p token in its nucleus."""
    jm, pm = models
    want = _mix_run(JaxEngine, JaxRequest, jm, JAX_MIX)
    got = _mix_run(ServingEngine, Request, pm, MIX, device="cpu")
    for i in range(len(got)):
        if i % len(MIX) in (0, 2):
            assert got[i].tokens == want[i].tokens
    for p in range(2):
        assert got[p * len(MIX)].tokens == got[p * len(MIX) + 2].tokens
    for i, r in enumerate(got):
        m = i % len(MIX)
        if m not in (3, 4):
            continue
        rows = _jax_logits(jm, list(r.prompt) + r.tokens[:-1])[
            len(r.prompt) - 1:]
        for row, tok in zip(rows, r.tokens):
            if m == 3:
                assert tok in set(np.argsort(-row)[:5].tolist())
            else:
                z = row / 0.9
                order = np.argsort(-z)
                p_sorted = np.exp(z[order] - z.max())
                p_sorted /= p_sorted.sum()
                keep = order[(np.cumsum(p_sorted) - p_sorted) < 0.9]
                assert tok in set(keep.tolist())


def test_sampled_first_tokens_follow_the_reference_softmax(models):
    """300 requests of one prompt, each with its own seed, temperature
    0.8 and top-k 5, one token each: the first-token counts against the
    JAX model's filtered softmax at the prompt's last position,
    chi-square at p > 1e-3, and nothing outside the top 5."""
    jm, pm = models
    prompt, n, temp = PROMPTS[2], 300, 0.8
    eng = ServingEngine(pm, **{**KW, "max_batch_slots": 8}, device="cpu")
    reqs = [eng.submit(Request(prompt=prompt, max_new_tokens=1,
                               sampling=SamplingParams(temperature=temp,
                                                       top_k=5, seed=s)))
            for s in range(n)]
    eng.run(max_steps=5000)
    row = _jax_logits(jm, prompt)[-1].astype(np.float64)
    keep = np.argsort(-row)[:5]
    z = row[keep] / temp
    p = np.exp(z - z.max())
    p /= p.sum()
    counts = np.bincount([r.tokens[0] for r in reqs], minlength=row.size)
    assert counts.sum() == counts[keep].sum() == n
    chi2 = (((counts[keep] - n * p) ** 2) / (n * p)).sum()
    assert chi2 < stats.chi2.ppf(0.999, 4), chi2


# ------------------------------------------------------------- FrontDoor
def _greedy_ref(pm, prompts, n):
    eng = ServingEngine(pm, **KW, device="cpu")
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    eng.run(max_steps=2000)
    return [r.tokens for r in reqs]


def test_front_door_serves_threads_mid_flight(models):
    """Two threads submit a sampling mix while the pump runs, under two
    tenants: greedy and top-k 1 handles stream the engine's greedy
    tokens; a queued and a running request are cancelled, one request
    cannot meet its deadline, and every block comes back with a clean
    audit."""
    _, pm = models
    ref = _greedy_ref(pm, PROMPTS, 12)
    door = FrontDoor(pm, tenants=[Tenant("paid", weight=4, tier=0),
                                  Tenant("free", weight=1, tier=1)],
                     **KW, device="cpu")
    handles, errs = {}, []
    mixes = [SamplingParams(greedy=True), SamplingParams(temperature=0.8),
             SamplingParams(top_k=1), SamplingParams(top_k=40),
             SamplingParams(top_p=0.9)]

    def client(tenant, base):
        try:
            for i, p in enumerate(PROMPTS):
                for j, sp in enumerate(mixes):
                    handles[(base, i, j)] = door.submit(
                        p, tenant=tenant, max_new_tokens=12, sampling=sp)
        except BaseException as e:      # noqa: BLE001 - reported below
            errs.append(e)

    with door:
        running = door.submit(PROMPTS[0], max_new_tokens=40,
                              sampling=SamplingParams(greedy=True))
        ts = [threading.Thread(target=client, args=(t, b))
              for t, b in (("paid", 0), ("free", 1))]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=60)
        queued = door.submit(PROMPTS[1], tenant="free", max_new_tokens=8)
        late = door.submit(PROMPTS[2], max_new_tokens=12, deadline=1e-4)
        assert queued.cancel()
        t0 = time.monotonic()
        while len(running.tokens) < 2 and time.monotonic() - t0 < 30:
            time.sleep(0.005)
        running.cancel()
        for h in list(handles.values()) + [running, queued, late]:
            assert h.wait(timeout=60)
        streamed = list(handles[(0, 0, 0)])
    assert not errs
    assert streamed == handles[(0, 0, 0)].tokens
    for (base, i, j), h in handles.items():
        assert h.finish_reason in ("eos", "length")
        if j in (0, 2):
            assert h.tokens == ref[i], (base, i, j)
    assert running.finish_reason == "cancelled"
    assert queued.finish_reason == "cancelled"
    assert late.finish_reason == "deadline_exceeded"
    with pytest.raises(RuntimeError, match="cancelled"):
        queued.result(timeout=1)
    eng = door.engine
    assert eng._alloc.free_count() == eng._alloc.capacity
    assert not {k: v for k, v in eng.audit().items() if v}
    # every sampling mix rode the same two programs
    assert len(eng.telemetry.sentinel.baseline()) == 2
    tenants = eng.metrics.by_tenant()
    assert tenants["paid"]["completed"] == tenants["free"]["completed"] \
        == len(PROMPTS) * len(mixes)


def test_front_door_backpressure_and_drain(models):
    _, pm = models
    door = FrontDoor(pm, tenants=[Tenant("free", max_queue_depth=2)],
                     max_queue_depth=5, **KW, device="cpu")
    door.engine.submit(Request(prompt=[1, 2], max_new_tokens=2))
    door.engine.submit(Request(prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(AdmissionRejected) as ei:
        for _ in range(3):
            door.submit([2] * 8, tenant="free", max_new_tokens=2)
    assert ei.value.reason == "backpressure:tenant"
    door.submit([2] * 8, tenant="paid", max_new_tokens=2)
    with pytest.raises(AdmissionRejected) as ei:
        door.submit([2] * 8, tenant="paid", max_new_tokens=2)
    assert ei.value.reason == "backpressure:global"
    assert door.drain() == {"draining": True, "active": 0, "queued": 5}
    with pytest.raises(AdmissionRejected) as ei:
        door.submit([2] * 8, max_new_tokens=2)
    assert ei.value.reason == "draining"
    rej = door.engine.telemetry.registry.get(
        "frontdoor_rejected_total").snapshot()
    assert rej == {"backpressure:tenant": 1.0, "backpressure:global": 1.0,
                   "draining": 1.0}
    door.start()
    door.stop(drain=True, timeout=60)
    assert door.queue_depth() == door.active_count() == 0


def test_idle_engine_wakes_on_late_submission(models):
    """An engine parked on a far arrival admits a late due submission
    within a tick (the condition wait), and a cancel of the far one ends
    the run."""
    _, pm = models
    eng = ServingEngine(pm, **KW, scheduler=FairScheduler(), device="cpu")
    far = eng.submit(Request(prompt=[9, 9], max_new_tokens=2,
                             arrival_time=30.0))
    th = threading.Thread(target=eng.run, daemon=True)
    th.start()
    time.sleep(0.2)
    t_sub, first = time.perf_counter(), {}
    late = eng.submit(Request(
        prompt=[5, 6], max_new_tokens=2, greedy=True,
        on_token=lambda r, tok, d: first.setdefault(
            "t", time.perf_counter())))
    t0 = time.monotonic()
    while late.status != "done" and time.monotonic() - t0 < 20:
        time.sleep(0.01)
    assert late.status == "done" and first["t"] - t_sub < 2.0
    assert eng.cancel(far)
    th.join(timeout=20)
    assert not th.is_alive()
    assert far.finish_reason == "cancelled"


def test_pump_death_unblocks_handles_and_double_stop(models, tmp_path,
                                                     monkeypatch):
    """A raising client callback kills the pump: every outstanding handle
    unblocks with ``error``, later submits refuse, and of two concurrent
    stops exactly one re-raises the death; a healthy door's concurrent
    double stop drains once and detaches both HTTP planes."""
    _, pm = models
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))

    def stopper(door, errs):
        try:
            door.stop(drain=True, timeout=60)
        except BaseException as e:      # noqa: BLE001 - collected
            errs.append(e)

    door = FrontDoor(pm, **KW, device="cpu", ops_port=0, ingest_port=0)
    door.start()
    assert door.pump_alive() and door.ops is not None
    h = door.submit([1, 2, 3], max_new_tokens=4,
                    sampling=SamplingParams(greedy=True))
    errs = []
    ts = [threading.Thread(target=stopper, args=(door, errs))
          for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert errs == [] and h.finish_reason == "length"
    assert door.ops is None and door.ingest is None
    door.stop()

    door = FrontDoor(pm, **KW, device="cpu").start()

    def boom(req, tok, done):
        raise RuntimeError("client callback exploded")

    h = door.submit([1, 2, 3], max_new_tokens=8, on_token=boom)
    others = [door.submit(p, max_new_tokens=30) for p in PROMPTS]
    for x in [h] + others:
        assert x.wait(timeout=60)
    assert {x.finish_reason for x in [h] + others} == {"error"}
    assert not door.pump_alive()
    with pytest.raises(RuntimeError, match="pump died"):
        door.submit([1], max_new_tokens=1)
    errs = []
    ts = [threading.Thread(target=stopper, args=(door, errs))
          for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert len(errs) == 1 and "exploded" in str(errs[0])
    door.stop()


async def _collect(h):
    return [t async for t in h]


def test_handle_is_an_async_iterable(models):
    import asyncio

    _, pm = models
    with FrontDoor(pm, **KW, device="cpu") as door:
        h = door.submit(PROMPTS[0], max_new_tokens=6,
                        sampling=SamplingParams(greedy=True))
        toks = asyncio.run(asyncio.wait_for(_collect(h), timeout=60))
    assert toks == h.tokens == _greedy_ref(pm, PROMPTS[:1], 6)[0]
