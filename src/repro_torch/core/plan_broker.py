"""Session-scoped planning broker: one fused program call plans every
operator of every concurrent query.

The paper's architecture (Fig. 8) invokes resource planning once *per
operator per query*; even with an array backend that is one kernel
launch per request, and the §VII-C 100K-container story multiplies it by
every operator of every query in flight.  This module breaks that
per-request wall: callers (``OperatorCosting`` and the ``RAQO`` facade's
multi-query entry point) *defer* their planning requests to a shared
per-session broker, which resolves them in three stages mapping onto the
paper's §VI machinery:

1. **Dedup / cache fronting (§VI-B3).**  Requests are resolved against
   the ``ResourcePlanCache`` first (same lookup modes, same stats), and
   requests that share a cache key — or, for cache-less callers, the
   exact (cost-fn, params, mode) signature — collapse onto one *leader*
   search; followers reuse the leader's configuration and re-cost it
   through their own scalar float64 path, exactly like a sequential
   cache hit would.  Cache-less results additionally persist in a
   bounded session memo, so recurring jobs across queries (the paper's
   §V story) never re-search.

2. **Stacked search (§VI-B1/2).**  Surviving leaders are grouped by
   (cost-fn object, grid) and their per-request scalars stacked into a
   padded ``(Q, P)`` params array; each group then runs as ONE array
   program on the selected ``PlanBackend`` — ``argmin_grid_many`` (the
   vectorized exhaustive scan of §VI-B1, all Q requests per chunk) or
   ``hill_climb_ensemble_many`` (the batched Algorithm 1 of §VI-B2).  On
   the exact ``"torch"`` backend the stacked arithmetic is bit-identical
   with Q independent per-operator searches (argmin ties included); on
   ``"cuda"`` a grid group is ONE launch of the CUDA scan kernel
   (repro_torch.kernels.plan_scan) — zero materialized ``(Q, chunk)``
   cost matrix — and an ensemble group one host-driven climb per
   request on the neighbor-step kernel.

3. **Commit / fan-out.**  Each winner is re-evaluated through the
   caller's scalar float64 cost fn before being fanned back to the
   caller's future.  A float32 CUDA winner that turns out infeasible in
   float64 is redone exactly on the float64 ``"torch"`` backend (same
   fallback the per-operator path used; ``PlanBroker.f64_researches``
   counts them); on the *exact* backend that fallback is a parity
   assertion.  Ensemble requests stranded on
   an all-infeasible plateau rerun as a grid scan (stacked again) when
   ``scan_fallback`` is set.  Freshly searched feasible plans are
   inserted into the cache, so the next flush dedups against them.

Semantics note: broker results are sequential-identical for *every*
cache mode.  Exact-mode caches (and cache-less requests) resolve their
lookups at flush entry — within-flush sharing is pure leader/follower
dedup, bit-identical to the sequential loop.  Nearest-neighbor and
weighted-average caches interpolate, so their lookups must observe
entries inserted *earlier in the same flush*; those requests are
therefore planned two-phase: stage 2 still runs their searches stacked
(speculatively, one fused program with everything else), but the cache
lookup is re-done per request in submission order during stage 3 — a
request whose re-lookup hits (possibly against a same-flush insert)
takes the hit exactly as the sequential loop would, and the speculative
search result is committed (and inserted) only otherwise.  Cached
requests sharing a key with an *earlier same-flush* request take the
same per-request stage-3 replay whatever the cache mode: an exact-mode
duplicate must count one miss on the leader and one HIT on the
follower (its sequential lookup would see the leader's fresh insert),
not two entry-time misses — the lockstep multi-query driver
(repro_torch.core.raqo ``plan_queries``) routinely puts every query's
level-L copy of a recurring operator in one wave, and its cache
counters must still match per-query sequential planning exactly.
Plans, costs, cache contents, and cache hit/miss counters all match
the sequential per-operator loop; only ``configs_explored`` may exceed
it for interpolating caches (discarded speculative searches are still
counted as work done).  The property tests in
tests/test_plan_broker.py and tests/test_lockstep.py pin this.  If a
leader's search comes back infeasible (nothing insertable), its
followers are re-planned one by one through the sequential semantics,
so that corner matches the per-operator loop too.

Double-buffered flushes: stage 2 is internally split into *dispatch*
(group, stack, launch the array programs — backends expose this half as
``argmin_grid_many_async`` / ``hill_climb_ensemble_many_async``) and
*finalize* (the single host sync reading the winners back).
``flush_async()`` commits the previous in-flight wave, dispatches the
currently pending requests as the new wave, and returns WITHOUT syncing:
the driver (``selinger_join_order``'s next DP level, FastRandomized's
next generation) enumerates wave N+1 while wave N's programs run on
device.  Commit order is preserved exactly — wave N's stage-3 commits
(float64 re-cost, cache inserts, future resolution, in submission
order) always complete before wave N+1's stage-1 cache lookups, so
plans, cache contents, and hit/miss counters are bit-identical to
calling ``flush()`` at the same points; ``PlanFuture.result()`` on an
in-flight request commits just that wave.  ``double_buffer=False`` (or
a backend without the async split) degrades ``flush_async`` to
``flush``.  Within a *synchronous* flush the same split still pays:
every (fn, grid) group's program is dispatched before any group's
results are read back, so e.g. a flush mixing SMJ and BHJ operators
overlaps the two scans.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.registry import hot_path
from repro_torch.core.cluster import ClusterConditions, PlanningStats
from repro_torch.core.plan_cache import ResourcePlanCache
from repro_torch.core.planning_backend import (BatchCostFn, PlanBackend, Result,
                                         get_backend)
from repro_torch.obs import get_metrics, get_tracer

ScalarCostFn = Callable[[Tuple[int, ...]], float]

# bound once at import; enable/disable flips the singletons in place.
# Disabled-tracer cost on the flush hot loop: one attribute load + branch
# per instrumentation point (no kwargs dicts, no clock reads — pinned
# allocation-free by tests/test_obs.py)
_obs = get_tracer()
_metrics = get_metrics()


def _request_done(fut: "PlanFuture") -> None:
    """Tracing-enabled path: stamp resolution and feed the per-request
    latency histogram (submit -> resolve, the broker's tail metric)."""
    now = time.perf_counter_ns()
    fut.obs["resolve"] = now
    _metrics.histogram("broker.request_s").observe(
        (now - fut.obs["submit"]) / 1e9)


def _wave_assembled(t0_ns: int, wave_no: int, size: int, leaders: int,
                    order, pipelined: bool, dispatched: bool) -> None:
    """Tracing-enabled path: close the wave-assembly span (stage 1 dedup
    + stage 2 dispatch), stamp every future the wave carries, and open
    the wave's async interval (closed at commit, so double-buffered
    waves render as overlapping tracks in Perfetto)."""
    _obs.complete("broker.wave", t0_ns, cat="broker", wave=wave_no,
                  size=size, leaders=leaders, pipelined=pipelined)
    now = time.perf_counter_ns()
    _metrics.histogram("broker.wave_assembly_s").observe(
        (now - t0_ns) / 1e9)
    for role, entry in order:
        futs = [entry[1]] if role == "dfollower" else \
            [entry.fut] + [f for _, f in entry.followers]
        for f in futs:
            if f.obs is not None:
                f.obs["wave"] = wave_no
                f.obs["dispatch"] = now
    if dispatched:
        _obs.async_begin("wave", wave_no, size=size, pipelined=pipelined)


def _wave_executed(t0_ns: int, wave_no: int, order) -> None:
    """Tracing-enabled path: record the finalize (host-sync) duration and
    stamp per-request execute completion."""
    now = time.perf_counter_ns()
    _obs.complete("broker.wave.execute", t0_ns, cat="broker", wave=wave_no)
    _metrics.histogram("broker.wave_execute_s").observe(
        (now - t0_ns) / 1e9)
    for role, entry in order:
        futs = [entry[1]] if role == "dfollower" else \
            [entry.fut] + [f for _, f in entry.followers]
        for f in futs:
            if f.obs is not None:
                f.obs["execute_done"] = now


def _wave_committed(t0_ns: int, wave_no: int, n: int) -> None:
    """Tracing-enabled path: record the stage-3 commit duration and close
    the wave's async interval."""
    _obs.complete("broker.wave.commit", t0_ns, cat="broker",
                  wave=wave_no, entries=n)
    _metrics.histogram("broker.wave_commit_s").observe(
        (time.perf_counter_ns() - t0_ns) / 1e9)
    _obs.async_end("wave", wave_no)


@dataclasses.dataclass
class PlanRequest:
    """One deferred resource-planning request.

    ``fn`` is the param-style batch cost surface (``fn(configs, params)``
    -> costs, carrying a ``.surface`` for the CUDA backend); ``params``
    the per-request scalars (e.g. ``[ss, ls]``);
    ``commit_fn`` the scalar float64 cost of one configuration (the
    commit/validation path, never inside the search); ``fallback_fn`` a
    float64 twin of ``fn`` used to redo the search exactly when a
    non-exact backend's winner fails the float64 commit."""
    fn: BatchCostFn
    cluster: ClusterConditions
    params: np.ndarray
    commit_fn: ScalarCostFn
    mode: str = "grid"                 # "grid" | "ensemble"
    n_random: int = 0
    seed: int = 0
    scan_fallback: bool = False        # ensemble all-inf -> grid scan
    fallback_fn: Optional[BatchCostFn] = None
    cache: Optional[ResourcePlanCache] = None
    cache_key: Optional[Tuple[str, str, float]] = None
    validate_hit: bool = False         # reject infeasible cache hits
    stats: Optional[PlanningStats] = None

    def __post_init__(self):
        self.params = np.asarray(self.params, dtype=np.float64)


class PlanFuture:
    """Handle to a deferred plan; ``result()`` flushes the broker if the
    request is still pending and returns ``(resources, cost)``.

    When tracing is enabled at submit time, ``obs`` holds the request's
    lifecycle stamps (``perf_counter_ns``) and ``critical_path()``
    reports the latency breakdown; with tracing off, ``obs`` stays None
    and the future costs exactly what it did pre-instrumentation."""

    __slots__ = ("_broker", "done", "value", "obs")

    def __init__(self, broker: "PlanBroker"):
        self._broker = broker
        self.done = False
        self.value: Result = (None, math.inf)
        self.obs: Optional[dict] = None

    def result(self) -> Result:
        if not self.done:
            self._broker._ensure(self)
        if not self.done:
            raise RuntimeError("broker flush did not resolve this request")
        return self.value

    def critical_path(self) -> Optional[dict]:
        """Latency breakdown of this request (None when tracing was off
        at submit): ``verdict`` (memo / cache-hit / leader / follower /
        replay / dleader), ``wave`` number, and the seconds split —
        ``queue_s`` (submit -> wave dispatch), ``execute_s`` (dispatch ->
        wave sync), ``commit_s`` (sync -> resolve), ``total_s``.  Memo /
        cache hits resolve before any wave, so they only carry
        ``total_s``."""
        o = self.obs
        if o is None:
            return None
        out: dict = {"verdict": o.get("verdict", "pending"),
                     "wave": o.get("wave")}
        sub, res = o.get("submit"), o.get("resolve")
        disp, xd = o.get("dispatch"), o.get("execute_done")
        if sub is not None and res is not None:
            out["total_s"] = (res - sub) / 1e9
        if sub is not None and disp is not None:
            out["queue_s"] = (disp - sub) / 1e9
        if disp is not None and xd is not None:
            out["execute_s"] = (xd - disp) / 1e9
        if xd is not None and res is not None:
            out["commit_s"] = (res - xd) / 1e9
        return out


@dataclasses.dataclass
class _Exec:
    """A leader request plus the followers deduplicated onto it."""
    req: PlanRequest
    fut: PlanFuture
    followers: List[Tuple[PlanRequest, PlanFuture]] = \
        dataclasses.field(default_factory=list)
    res: Optional[Tuple[int, ...]] = None
    cost: float = math.inf


@dataclasses.dataclass
class _Wave:
    """One dispatched-but-uncommitted flush wave (the double buffer):
    its programs are in flight on device; ``finalize`` syncs them, after
    which stage 3 commits ``order``.  ``futs`` holds the ``id()`` of
    every future the wave will resolve, so ``PlanFuture.result()`` can
    commit exactly this wave without flushing newer pending work."""
    order: List[Tuple[str, object]]
    execs: List[_Exec]
    finalize: Callable[[], None]
    futs: frozenset
    wave_no: int = 0


class PlanBroker:
    """Collects planning requests from every operator of every query in
    flight and resolves them in batched flushes (see module docstring).

    One broker per *session* (a RAQO instance, a multi-tenant batch of
    queries): the backend's kernels,
    the session memo, and the dedup scope all live here.
    """

    MAX_MEMO = 4096                    # FIFO bound on the session memo

    def __init__(self, backend=None, double_buffer: bool = True):
        self.backend: PlanBackend = get_backend(backend)
        self.double_buffer = bool(double_buffer)
        self._pending: List[Tuple[PlanRequest, PlanFuture]] = []
        self._inflight: Optional[_Wave] = None
        # exact-signature session memo for cache-less callers; callers
        # with a ResourcePlanCache keep the cache as their single source
        # of cross-flush reuse (so mutable-cache semantics stay per-op)
        self._memo: Dict[Tuple, Tuple[BatchCostFn, Result]] = {}
        self.stats = PlanningStats()   # broker-level aggregate
        # float64 re-searches after a float32 winner failed its commit
        # (kept out of PlanningStats, whose fields mirror the reference)
        self.f64_researches = 0

    # ------------------------------------------------------------------ #
    def _key(self, req: PlanRequest) -> Tuple:
        return (id(req.fn), req.cluster.dims, req.params.tobytes(),
                req.mode, req.n_random, req.seed)

    def _bump(self, req: PlanRequest, field: str, n: int = 1) -> None:
        setattr(self.stats, field, getattr(self.stats, field) + n)
        if req.stats is not None:
            setattr(req.stats, field, getattr(req.stats, field) + n)

    def submit(self, req: PlanRequest) -> PlanFuture:
        """Queue a request; returns a future resolved at the next flush
        (or immediately, on a session-memo hit)."""
        fut = PlanFuture(self)
        if _obs.enabled:
            fut.obs = {"submit": time.perf_counter_ns(),
                       "verdict": "pending"}
        self._bump(req, "broker_requests")
        if req.cache is None:
            hit = self._memo.get(self._key(req))
            if hit is not None and hit[0] is req.fn:
                self._bump(req, "broker_dedup_hits")
                fut.value, fut.done = hit[1], True
                if fut.obs is not None:
                    fut.obs["verdict"] = "memo"
                    _request_done(fut)
                return fut
        self._pending.append((req, fut))
        return fut

    def pending_count(self) -> int:
        return len(self._pending)

    def _record_wave(self, pending) -> None:
        """Wave accounting: one entry per non-empty flush, sized by the
        requests that entered it (broker-level only — a wave spans many
        costings, so per-request stats never see these counters)."""
        self.stats.broker_waves += 1
        self.stats.broker_wave_sizes.append(len(pending))

    def counters_snapshot(self) -> dict:
        """JSON-friendly broker counters including flush-wave geometry —
        the lockstep multi-query win is wave *shape* (few waves, ΣQ_L
        requests each), not just wall-clock, so benches trend these next
        to the timings."""
        ws = list(self.stats.broker_wave_sizes)
        return {
            "requests": self.stats.broker_requests,
            "dedup_hits": self.stats.broker_dedup_hits,
            "batches": self.stats.broker_batches,
            "waves": self.stats.broker_waves,
            "wave_sizes": ws,
            "max_wave": max(ws) if ws else 0,
            "mean_wave": round(sum(ws) / len(ws), 3) if ws else 0.0,
        }

    # ------------------------------------------------------------------ #
    @staticmethod
    def _lookup(req: PlanRequest) -> Optional[Result]:
        """One cache lookup + validate for ``req`` (sequential
        semantics); None when it must search."""
        hit = req.cache.lookup(req.cache_key[0], req.cache_key[1],
                               req.cache_key[2], req.cluster, req.stats)
        if hit is None:
            return None
        cfg = tuple(int(v) for v in hit)
        cost = req.commit_fn(cfg)
        if not req.validate_hit or math.isfinite(cost):
            return cfg, cost
        # cached plan invalid under current conditions (degraded
        # cluster, budget): caller falls through to search
        return None

    @hot_path("resolves every pending request of the session per flush")
    def flush(self) -> None:
        """Resolve every pending request: dedup -> stacked search ->
        float64 commit -> fan-out (stages 1-3 of the module docstring).
        Any in-flight double-buffered wave commits first, so sequential
        ordering is preserved."""
        self._commit_inflight()
        pending, self._pending = self._pending, []
        if not pending:
            return
        self._record_wave(pending)
        wave_no = self.stats.broker_waves
        t0 = time.perf_counter_ns() if _obs.enabled else 0
        order, execs = self._stage1(pending)
        fin = self._dispatch(execs) if execs else None
        if _obs.enabled:
            _wave_assembled(t0, wave_no, len(pending), len(execs), order,
                            False, fin is not None)
        if fin is None:
            return
        self._finish(order, execs, fin, wave_no)

    def flush_async(self) -> None:
        """Double-buffered flush: commit the previous in-flight wave
        (its programs ran while the caller enumerated), dispatch the
        currently pending requests as the NEW in-flight wave, and return
        without syncing.  Results land at the next ``flush_async()`` /
        ``flush()`` / ``result()`` on one of the wave's futures — always
        committed in submission order before any newer stage-1 lookup,
        so outcomes are bit-identical to calling ``flush()`` at the same
        points (the identity the broker property tests pin)."""
        if not self.double_buffer:
            self.flush()
            return
        self._commit_inflight()
        pending, self._pending = self._pending, []
        if not pending:
            return
        self._record_wave(pending)
        wave_no = self.stats.broker_waves
        t0 = time.perf_counter_ns() if _obs.enabled else 0
        order, execs = self._stage1(pending)
        if not execs:
            if _obs.enabled:
                _wave_assembled(t0, wave_no, len(pending), 0, order,
                                True, False)
            return
        futs = set()
        for role, entry in order:
            if role == "dfollower":
                futs.add(id(entry[1]))
            else:
                futs.add(id(entry.fut))
                futs.update(id(ffut) for _, ffut in entry.followers)
        fin = self._dispatch(execs)
        if _obs.enabled:
            _wave_assembled(t0, wave_no, len(pending), len(execs), order,
                            True, True)
        self._inflight = _Wave(order=order, execs=execs, finalize=fin,
                               futs=frozenset(futs), wave_no=wave_no)

    def inflight_count(self) -> int:
        """Futures the in-flight wave will resolve (0 when none)."""
        return 0 if self._inflight is None else len(self._inflight.futs)

    def _commit_inflight(self) -> None:
        """Finalize + commit the in-flight wave, if any."""
        wave, self._inflight = self._inflight, None
        if wave is not None:
            self._finish(wave.order, wave.execs, wave.finalize,
                         wave.wave_no)

    def _ensure(self, fut: PlanFuture) -> None:
        """Resolve ``fut``: a member of the in-flight wave commits just
        that wave (newer pending requests stay pending, still
        accumulating into the next one); anything else takes the full
        flush."""
        if self._inflight is not None and id(fut) in self._inflight.futs:
            self._commit_inflight()
        else:
            self.flush()

    # ------------------------------------------------------------------ #
    def _stage1(self, pending: List[Tuple[PlanRequest, PlanFuture]]
                ) -> Tuple[List[Tuple[str, object]], List[_Exec]]:
        """Stage 1: cache fronting + within-flush dedup.

        Interpolating (nearest-neighbor / weighted-average) caches must
        observe same-flush inserts, so their lookups are deferred to
        stage 3 (submission order); their searches still run stacked in
        stage 2, speculatively.  Exact caches cannot hit on anything a
        same-flush insert adds under a *different* key, so a first-seen
        key's lookup happens here — but a request whose key an EARLIER
        same-flush request already claimed must replay in stage 3: its
        sequential lookup would have seen that leader's fresh insert
        (one miss + one hit, not two misses), which is exactly the
        multi-query lockstep shape where every query's copy of a
        recurring operator lands in one wave.  Cache-less duplicates
        stay plain followers (memo semantics are insertion-order
        identical either way).  Returns (stage-3 submission order,
        leader execs)."""
        leaders: Dict[Tuple, _Exec] = {}
        order: List[Tuple[str, object]] = []   # stage-3 submission order
        for req, fut in pending:
            cached = req.cache is not None and req.cache_key is not None
            if req.cache is None:
                memo = self._memo.get(self._key(req))
                if memo is not None and memo[0] is req.fn:
                    self._bump(req, "broker_dedup_hits")
                    if fut.obs is not None:
                        fut.obs["verdict"] = "memo"
                    self._resolve(fut, memo[1])
                    continue
            deferred = cached and \
                getattr(req.cache, "mode", "exact") != "exact"
            if cached:
                dkey = (("cache", id(req.cache)) + req.cache_key +
                        (req.mode, req.n_random, req.seed))
            else:
                dkey = ("exact",) + self._key(req)
            led = leaders.get(dkey)
            if led is not None:
                if fut.obs is not None:
                    fut.obs["verdict"] = "replay" if cached else "follower"
                if cached:
                    # same cache key as an earlier same-flush request:
                    # the sequential loop would give it a fresh lookup
                    # AFTER the leader's insert (an exact-mode hit / an
                    # interpolating re-interpolation) — full per-request
                    # replay in stage 3, in submission order.  The replay
                    # lookup counts the cache hit sequential planning
                    # would count, so no dedup bump: broker counters stay
                    # sequential-identical under lockstep multi-query
                    order.append(("dfollower", (req, fut)))
                else:
                    self._bump(req, "broker_dedup_hits")
                    led.followers.append((req, fut))
                continue
            if cached and not deferred:
                got = self._lookup(req)
                if got is not None:
                    if fut.obs is not None:
                        fut.obs["verdict"] = "cache-hit"
                    self._resolve(fut, got)
                    continue
            ex = _Exec(req=req, fut=fut)
            leaders[dkey] = ex
            if fut.obs is not None:
                fut.obs["verdict"] = "dleader" if deferred else "leader"
            order.append(("dleader" if deferred else "leader", ex))
        return order, list(leaders.values())

    def _finish(self, order: List[Tuple[str, object]], execs: List[_Exec],
                finalize: Callable[[], None], wave_no: int = 0) -> None:
        """Finalize a dispatched wave (the single host sync), then run
        stage 3: float64 commit + fan-out, in submission order."""
        t0 = time.perf_counter_ns() if _obs.enabled else 0
        finalize()
        if _obs.enabled:
            _wave_executed(t0, wave_no, order)
        retry = [ex for ex in execs
                 if ex.req.scan_fallback and ex.req.mode == "ensemble"
                 and not math.isfinite(ex.cost)]
        if retry:
            # all starts stranded on an infeasible plateau: exhaustive
            # scan, still stacked per (fn, grid) group
            self._run(retry, force_mode="grid")

        tc = time.perf_counter_ns() if _obs.enabled else 0
        for role, entry in order:
            if role == "dfollower":
                # sequential per-request replay: its lookup sees every
                # insert made earlier in this loop
                freq, ffut = entry
                self._resolve(ffut, self._solve_one(freq))
                continue
            ex = entry
            req = ex.req
            if role == "dleader":
                # deferred (interpolating-cache) lookup, now that earlier
                # requests of this flush have committed their inserts; a
                # hit discards the speculative stage-2 search
                got = self._lookup(req)
                if got is not None:
                    self._resolve(ex.fut, got)
                    continue
            res, cost = self._commit(req, ex.res, ex.cost)
            ok = res is not None and math.isfinite(cost)
            if req.cache is None:
                while len(self._memo) >= self.MAX_MEMO:
                    self._memo.pop(next(iter(self._memo)))
                self._memo[self._key(req)] = (req.fn, (res, cost))
            self._resolve(ex.fut, (res, cost))
            if not ex.followers:
                continue
            if ok or req.cache is None:
                # follower = sequential cache hit: leader's configuration,
                # its own scalar float64 cost (exact-dedup followers are
                # bit-identical requests, so this recomputes the same
                # number the leader committed)
                for freq, ffut in ex.followers:
                    self._resolve(ffut,
                                  (res, freq.commit_fn(res)) if ok
                                  else (res, cost))
            else:
                # leader infeasible -> nothing was inserted; a sequential
                # loop would have searched each follower itself (possibly
                # feasibly — params differ within a cache key), inserting
                # as it goes.  Rare corner: replay it sequentially.
                for freq, ffut in ex.followers:
                    self._resolve(ffut, self._solve_one(freq))
        if _obs.enabled:
            _wave_committed(tc, wave_no, len(order))

    # ------------------------------------------------------------------ #
    @hot_path("dispatches one stacked search program per (fn, grid) group")
    def _dispatch(self, execs: List[_Exec],
                  force_mode: Optional[str] = None) -> Callable[[], None]:
        """Stage 2, dispatch half: group leaders per (cost-fn, grid,
        mode), stack their params, and launch every group's array
        program via the backend's async split — ALL groups dispatch
        before any result is read back, so a flush mixing cost surfaces
        (SMJ and BHJ operators, say) overlaps their scans on device.
        Returns the zero-arg finalize performing the host syncs and
        writing raw (res, cost) back onto each _Exec."""
        groups: Dict[Tuple, List[_Exec]] = {}
        for ex in execs:
            req = ex.req
            mode = force_mode or req.mode
            gkey = (id(req.fn), req.cluster.dims, mode, req.n_random,
                    req.seed, len(req.params))
            groups.setdefault(gkey, []).append(ex)
        be = self.backend
        waves = []
        for gkey, entries in groups.items():
            req0 = entries[0].req
            mode = force_mode or req0.mode
            pm = np.stack([ex.req.params for ex in entries])
            gstats = PlanningStats()
            with _obs.span("broker.dispatch.group", cat="broker") as sp:
                if mode == "grid":
                    if hasattr(be, "argmin_grid_many_async"):
                        fin = be.argmin_grid_many_async(
                            req0.fn, req0.cluster, pm, stats=gstats)
                    else:           # backend without the async split
                        results = be.argmin_grid_many(
                            req0.fn, req0.cluster, pm, stats=gstats)
                        fin = (lambda r=results: r)
                else:
                    if hasattr(be, "hill_climb_ensemble_many_async"):
                        fin = be.hill_climb_ensemble_many_async(
                            req0.fn, req0.cluster, pm, stats=gstats,
                            n_random=req0.n_random, seed=req0.seed)
                    else:
                        results = be.hill_climb_ensemble_many(
                            req0.fn, req0.cluster, pm, stats=gstats,
                            n_random=req0.n_random, seed=req0.seed)
                        fin = (lambda r=results: r)
                if sp:
                    sp.set(mode=mode, q=len(entries),
                           backend=getattr(be, "name", "?"))
            for ex in entries:
                self._bump(ex.req, "broker_batches")
            self.stats.broker_batches -= len(entries) - 1  # one per group
            waves.append((entries, gstats, fin))

        def finalize() -> None:
            for entries, gstats, fin in waves:
                with _obs.span("broker.group.sync", cat="broker") as sp:
                    results = fin()
                    if sp:
                        sp.set(q=len(entries))
                # attribute the group's exploration evenly (grid groups
                # are exactly grid_size per request; climb convergence
                # varies per request, so the split is approximate there)
                share, rem = divmod(gstats.configs_explored, len(entries))
                for i, (ex, rc) in enumerate(zip(entries, results)):
                    ex.res, ex.cost = rc
                    if ex.req.stats is not None:
                        n = share + (rem if i == 0 else 0)
                        ex.req.stats.configs_explored += n
                        ex.req.stats.cost_calls += n
        return finalize

    def _run(self, execs: List[_Exec], force_mode: Optional[str] = None
             ) -> None:
        """Synchronous stage 2: dispatch + immediate finalize (the
        scan_fallback retry path)."""
        self._dispatch(execs, force_mode)()

    def _commit(self, req: PlanRequest, res, cost: float) -> Result:
        """Float64 commit of one raw search result: re-cost through the
        caller's scalar fn; on a feasibility disagreement, exact backends
        assert parity and non-exact ones redo the search on the float64
        torch backend; feasible plans are inserted into the cache."""
        if res is not None:
            raw, cost = cost, req.commit_fn(res)
            if not math.isfinite(cost):
                if getattr(self.backend, "exact", False):
                    # exact backend: search and commit compute in the
                    # same float64 arithmetic — feasibility must agree
                    assert not math.isfinite(raw), (
                        f"exact backend {self.backend.name} selected "
                        f"{res} with finite search cost {raw} but "
                        f"infinite float64 commit")
                elif req.fallback_fn is not None:
                    self.f64_researches += 1
                    res, cost = get_backend("torch").argmin_grid(
                        req.fallback_fn, req.cluster, req.stats,
                        params=req.params)
                    if res is not None:
                        cost = req.commit_fn(res)
        if res is not None and math.isfinite(cost) and \
                req.cache is not None and req.cache_key is not None:
            req.cache.insert(req.cache_key[0], req.cache_key[1],
                             req.cache_key[2], res, stats=req.stats)
        return res, cost

    def _solve_one(self, req: PlanRequest) -> Result:
        """Strictly sequential per-operator semantics for one request:
        lookup -> search -> commit -> insert (the promotion path for
        followers of an infeasible leader)."""
        if req.cache is not None and req.cache_key is not None:
            hit = req.cache.lookup(req.cache_key[0], req.cache_key[1],
                                   req.cache_key[2], req.cluster, req.stats)
            if hit is not None:
                cfg = tuple(int(v) for v in hit)
                cost = req.commit_fn(cfg)
                if not req.validate_hit or math.isfinite(cost):
                    return cfg, cost
        stats = req.stats if req.stats is not None else PlanningStats()
        before = stats.configs_explored
        if req.mode == "grid":
            res, cost = self.backend.argmin_grid(
                req.fn, req.cluster, stats, params=req.params)
        else:
            res, cost = self.backend.hill_climb_ensemble(
                req.fn, req.cluster, stats=stats, params=req.params,
                n_random=req.n_random, seed=req.seed)
            if not math.isfinite(cost) and req.scan_fallback:
                res, cost = self.backend.argmin_grid(
                    req.fn, req.cluster, stats, params=req.params)
        stats.cost_calls += stats.configs_explored - before
        return self._commit(req, res, cost)

    @staticmethod
    def _resolve(fut: PlanFuture, value: Result) -> None:
        fut.value = (None if value[0] is None
                     else tuple(int(v) for v in value[0]), float(value[1]))
        fut.done = True
        if fut.obs is not None:
            _request_done(fut)
