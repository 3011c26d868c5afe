"""Fleet serving: a router over N ServingEngine replicas of one model (the
port's ``runtime/router.py``, a copy of the JAX package's with the same
placement, failover and ledger rules, and the same ``stats()`` /
``health()`` keys, metric families and span names).

``ServingRouter`` fronts N replicas, each driven by its own thread. The
replicas share the model's weights; each holds its own KV pool and, on
the card, captures and replays its own CUDA graphs on its own stream.

  * FAILOVER — a replica whose driver thread raises (a crashed engine),
    that stops heartbeating past ``health_timeout_s`` (a hung dispatch),
    or whose health probe itself dies is FENCED: its in-flight and
    engine-queued requests are resubmitted to survivors exactly once. A
    resubmitted request re-decodes from scratch on the survivor (the
    dead replica's partial tokens are discarded, never spliced), so its
    greedy stream equals an uninterrupted single-replica run. A request
    whose SECOND replica also dies fails ("replica lost twice"). A fence
    frees nothing: a wedged replica's engine, pool and graphs stay
    alive, only its work moves.
  * PER-REQUEST DEADLINES — ``submit(..., deadline_s=)``. A request that
    expires while queued (router queue or engine queue) retires as
    ``"timeout"`` without prefilling; an expired request found in flight
    on a FENCED replica is not resubmitted; an admitted request on a
    healthy replica is never cancelled mid-batch.
  * OVERLOAD SHEDDING — the router queue is bounded by ``max_queue``
    (FFConfig.serve_max_queue; 0 = unbounded). A submit over the bound
    returns at once with state ``"rejected"``, so accepted requests keep
    a bounded queue wait.
  * HEALTH-DRIVEN PLACEMENT — dispatch picks the least-loaded live
    replica (the router's outstanding ledger, then the engine's
    lock-free ``load()``), with PREFIX AFFINITY on top: the first full KV
    page of the prompt (the radix trie's first edge, namespaced by
    adapter and weight version) maps to the replica that last served it.
    Affinity is a preference, never a constraint.
  * ROLE-SPLIT DISAGGREGATION — replicas carry a role: ``mixed`` (the
    default), ``prefill`` or ``decode``. Prompts of ``handoff_min_pages``
    full pages or more go to a prefill replica
    (``ServingEngine.prefill_into_cache``), whose cached pages move as a
    host page slab (``export_prefix_slab`` -> ``import_prefix_slab``) to a
    decode replica, which then admits the prompt as a prefix hit. With
    ``seq_parallel_shards`` >= 2 a long prompt's page-aligned prefix is
    split into contiguous shards across the prefill-capable replicas and
    merged on the decode side through partial-prefix slabs. Every role
    preference falls back (a dead prefill tier downgrades work to the
    cold path on a decode replica). The home replica's tier events
    (``drain_tier_events``) keep an affinity entry routing home while its
    pages sit in the host tier, and drop it when they die in both.
  * ELASTIC MEMBERSHIP — ``add_replica()`` builds, adapter-replays and
    warms a new engine off the router lock and admits it atomically;
    ``remove_replica()`` retires one, requeueing its never-admitted work
    and handing its cached prefix paths to survivors as page slabs.
    SIGTERM / ``request_preempt()`` / the FF_FAULT ``preempt`` drill race
    a deadline to evacuate queued and in-flight requests and hot prefix
    slabs; a blown deadline degrades to the ordinary fence.

Failure drills through FF_FAULT (runtime/faultinject.py):
``crash@replica:<r>`` kills replica r's driver at its first busy tick
(``crash(<t>)@replica:<r>`` at its t-th), ``hang@replica:<r>`` wedges it
until the heartbeat sweep fences it, ``slow(<ms>)@serve:<n>`` stalls an
engine admission so an in-flight deadline expires on cue,
``preempt(<deadline_ms>)@replica:<r>`` delivers a SIGTERM-equivalent
preemption with that evacuation deadline, and
``slow_evac(<ms>)@evacuate:<n>`` stalls the n-th evacuation slab export.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from flexflow_tpu_torch.ops import sampling as sampling_ops
from flexflow_tpu_torch.runtime import faultinject, flightrec, locks, telemetry
from flexflow_tpu_torch.runtime.serving import RadixPrefixCache, version_ns

fflogger = logging.getLogger(__name__)


class ReplicaCrash(RuntimeError):
    """Injected replica loss (FF_FAULT ``crash@replica:<r>``): raised on
    the replica's driver thread to simulate the whole engine dying
    mid-dispatch."""


# process-wide router ids: trace ids must be unique across fleets in one
# process (two routers both start their rids at 0)
_ROUTER_IDS = iter(range(1 << 30))


def _slab_nbytes(slab: Dict) -> int:
    """Host bytes a page slab's payload actually moves."""
    total = 0
    stack = [slab.get("payload")]
    while stack:
        x = stack.pop()
        if isinstance(x, np.ndarray):
            total += x.nbytes
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


@dataclass
class FleetRequest:
    """One router-level request and its lifecycle record. The underlying
    engine Request is replaced wholesale on failover — ``tokens`` always
    holds ONE replica's complete stream, never a splice."""

    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int
    # per-request sampling config + LoRA adapter: assigned
    # at ROUTER submit (the seed defaults to the fleet rid) so a
    # failover resubmission replays the identical counter-based sample
    # stream on the survivor — sampled streams are as failover-stable
    # as greedy ones
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    adapter: Optional[str] = None
    # absolute time.perf_counter() deadline (None = none)
    deadline: Optional[float] = None
    # first full KV page of the prompt (the radix trie's first edge);
    # None when the prompt is shorter than one page
    affinity: Optional[Tuple[int, ...]] = None
    # queued | dispatched | done | failed | timeout | rejected
    state: str = "queued"
    replica: int = -1               # current/last replica
    attempts: int = 0               # dispatches (a clean role-split
    #                                 handoff uses 2: prefill + decode)
    losses: int = 0                 # replicas that died under this
    #                                 request (the exactly-once cap: 2)
    # role-split lifecycle: "direct" = the classic single-dispatch path;
    # "prefill" = headed to a prefill replica for prefill-only + slab
    # export; "decode" = slab in hand, headed to a decode replica
    phase: str = "direct"
    slab: Optional[Dict] = None     # exported page slab (host bytes)
    handoff: bool = False           # ever routed through a prefill tier
    tokens: List[int] = field(default_factory=list)
    error: str = ""
    t_submit: float = 0.0
    ttft: float = 0.0               # router submit -> first token (s)
    t_done: float = 0.0
    # telemetry: the fleet-wide trace id every span of this request
    # carries (it survives resubmission and the prefill->decode
    # handoff), and the open root-span handle closed at settlement
    trace_id: str = ""
    root_span: int = 0

    @property
    def output(self) -> np.ndarray:
        """prompt + emitted tokens (the generate() shape)."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def settled(self) -> bool:
        return self.state not in ("queued", "dispatched")


class ServingRouter:
    """Route requests over N ServingEngine replicas of one model.

    Each replica runs on its own daemon thread; the lock order is
    router -> engine, and an engine's lock is only ever taken by its own
    driver thread (plus warmup/drain when the fleet is quiet), so the
    two layers can never deadlock. ``submit()``/``run()`` from any
    thread; ``drain()`` for graceful shutdown, ``close()`` to abandon.

    ``start=False`` builds the fleet without spawning drivers (requests
    queue, shed and expire deterministically — the test hook);
    ``start()``/``run()`` bring the drivers up."""

    # the hang detector cannot distinguish a wedged dispatch from a
    # legitimately long one by wall clock alone, and a COLD tick builds
    # its kernels and captures its graphs (seconds) — so the default
    # timeout is sized for cold ticks. Latency-sensitive
    # fleets warmup() every replica first, after which a healthy tick is
    # milliseconds and a tight timeout (the drill tests run 0.5 s) is
    # meaningful.
    DEFAULT_HEALTH_TIMEOUT_S = 60.0

    ROLES = ("prefill", "decode", "mixed")

    def __init__(self, model, replicas: int = 2,
                 max_queue: Optional[int] = None,
                 health_timeout_s: Optional[float] = None,
                 dispatch_backlog: Optional[int] = None,
                 roles=None, handoff_min_pages: int = 1,
                 seq_parallel_shards: Optional[int] = None,
                 start: bool = True, **engine_kwargs):
        if health_timeout_s is None:
            health_timeout_s = self.DEFAULT_HEALTH_TIMEOUT_S
        if replicas < 1:
            raise ValueError(f"replicas={replicas}: must be >= 1")
        if health_timeout_s <= 0:
            raise ValueError(
                f"health_timeout_s={health_timeout_s}: must be > 0")
        cfg = model.config
        # adopt FFConfig.sanitize before the replica engines (and
        # this router's own lock) are created — lock proxying is
        # decided at creation time (runtime/locks.py)
        locks.configure(cfg)
        self.model = model
        self.n = int(replicas)
        # replica roles: default "mixed" for every replica. A
        # per-replica list (or
        # FFConfig.serve_replica_roles as "prefill,decode,decode") turns
        # on the disaggregated placement + handoff below.
        raw = (roles if roles is not None
               else getattr(cfg, "serve_replica_roles", "") or "")
        if isinstance(raw, str):
            role_list = [t.strip() for t in raw.split(",") if t.strip()]
        else:
            role_list = [str(t) for t in raw]
        if not role_list:
            role_list = ["mixed"] * self.n
        if len(role_list) != self.n:
            raise ValueError(
                f"roles={role_list}: need one role per replica "
                f"({self.n}), one of {self.ROLES}")
        bad = [t for t in role_list if t not in self.ROLES]
        if bad:
            raise ValueError(
                f"roles={role_list}: unknown role(s) {bad} — each must "
                f"be one of {self.ROLES}")
        if all(t == "prefill" for t in role_list):
            raise ValueError(
                f"roles={role_list}: a fleet of only prefill replicas "
                f"has nowhere to decode — include a 'decode' or "
                f"'mixed' replica")
        self.roles = role_list
        self.handoff_min_pages = int(handoff_min_pages)
        if self.handoff_min_pages < 1:
            raise ValueError(
                f"handoff_min_pages={handoff_min_pages}: must be >= 1")
        # sequence-parallel prefill: split a monster prompt's
        # page-aligned prefix into contiguous shards across the prefill
        # tier; the decode replica merges the shard slabs through
        # partial-prefix import_prefix_slab. 0/1 = off.
        self.seq_parallel_shards = int(
            seq_parallel_shards if seq_parallel_shards is not None
            else getattr(cfg, "seq_parallel_shards", 0) or 0)
        if self.seq_parallel_shards < 0 or self.seq_parallel_shards == 1:
            raise ValueError(
                f"seq_parallel_shards={self.seq_parallel_shards}: must "
                f"be 0 (off) or >= 2 (shard count)")
        self.max_queue = int(max_queue if max_queue is not None
                             else getattr(cfg, "serve_max_queue", 0))
        if self.max_queue < 0:
            raise ValueError(
                f"max_queue={self.max_queue}: must be >= 0 (0 = unbounded)")
        self.health_timeout_s = float(health_timeout_s)
        # kept verbatim for live scale-out: add_replica()
        # builds its engine with the SAME kwargs the fleet was built
        # with, so a scaled-out replica is indistinguishable from a
        # founding one
        self._engine_kwargs = dict(engine_kwargs)
        self.engines = [model.make_serving_engine(**engine_kwargs)
                        for _ in range(self.n)]
        self.page_size = self.engines[0].page_size
        slots = self.engines[0].slots
        # outstanding-per-replica cap: slots in flight + a short engine
        # queue so admission can pipeline, but deep backlogs stay in the
        # ROUTER queue where deadlines expire before dispatch and a
        # fence requeues cheaply
        self.dispatch_backlog = int(dispatch_backlog
                                    if dispatch_backlog is not None
                                    else slots)
        self._cap = slots + self.dispatch_backlog
        # the role split hands off through the radix trie: without it a
        # prefill replica has nowhere to publish, so the fleet quietly
        # degrades to direct placement (roles still shape placement)
        self._handoff_capable = (
            any(t == "prefill" for t in self.roles)
            and self.engines[0].prefix_cache is not None)

        self._lock = locks.make_rlock("router")
        self._queue: collections.deque = collections.deque()  # FleetRequest
        # rid -> (FleetRequest, engine Request | None): None until the
        # replica's driver hands the request to its engine
        self._outstanding: List[Dict] = [dict() for _ in range(self.n)]
        self._to_submit: List[collections.deque] = [
            collections.deque() for _ in range(self.n)]
        # prefix chunk -> replica that last served it (bounded LRU: the
        # map must not grow with total distinct-prompt traffic)
        self._affinity: "collections.OrderedDict" = collections.OrderedDict()
        self._affinity_cap = 4096
        self._fenced = [False] * self.n
        self._fence_reason = [""] * self.n
        self._heartbeat = [time.monotonic()] * self.n
        self._busy_ticks = [0] * self.n
        self._stop = threading.Event()
        self._draining = False
        # rolling deploy: a SUSPENDED replica is alive (its
        # driver keeps ticking, it is never fenced) but receives no new
        # dispatches — the deployer's drain-swap-warmup window. The
        # deploying flag degrades (not breaches) the /healthz rollup
        # while a roll is in progress.
        self._suspended = [False] * self.n
        self._deploying = False
        self._swaps_completed = 0
        self._rollbacks = 0
        # elastic fleet: a RETIRED replica left the fleet
        # cleanly (scale-in or evacuated preemption) — indices stay
        # stable (parallel lists never compact), it is excluded from
        # _alive()/dispatch/rollups, and unlike a fence it owes the
        # router nothing: everything it held was handed to survivors
        self._retired = [False] * self.n
        # replica -> evacuation deadline (seconds): set by SIGTERM /
        # request_preempt / FF_FAULT `preempt`, consumed by the
        # replica's own driver tick (the evacuation runs there)
        self._preempt_req: Dict[int, float] = {}
        # replicas whose driver is running their evacuation race: the
        # preemption deadline governs them, not the heartbeat sweep (an
        # export or an import waiting on a survivor's tick may outlast
        # health_timeout_s while the replica is alive and on schedule)
        self._evacuating: set = set()
        self._default_preempt_deadline_s = float(
            getattr(cfg, "preempt_deadline_s", 5.0))
        self._sigterm_installed = False
        self._prev_sigterm = None
        # fleet-wide adapter registry replay: register_adapter
        # fans out to every live replica at call time; a replica added
        # LATER replays this so survivors and newcomers always share one
        # registry view
        self._adapter_registry: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._warm_prompts = None   # captured by warmup() for add_replica
        self._next_rid = 0
        # router counters (stats()): the fleet-level ledger
        self._submitted = 0
        self._dispatched = 0
        self._completed = 0
        self._failed = 0
        self._timeouts = 0
        self._rejected = 0
        self._fenced_count = 0
        self._resubmitted = 0
        # role-split ledger: completed handoffs (prefill done, slab
        # moved to the decode queue), downgrades to the cold path (no
        # prefill replica alive / prefill-side pressure), and slab
        # imports that fell back cold on the decode side
        self._handoffs = 0
        self._handoff_fallbacks = 0
        # sequence-parallel prefills completed (every shard exported and
        # the request queued for decode with its slab LIST)
        self._seq_parallel = 0
        # elastic-fleet ledger: membership changes, and the
        # evacuation half of exactly-once — requests moved OFF a
        # retiring/preempted replica cleanly (ownership transfer, no
        # loss counted; a survivor death afterwards still caps at 2)
        self._scale_outs = 0
        self._scale_ins = 0
        self._preempts = 0
        self._evacuated_requests = 0
        self._evacuated_slabs = 0
        self._evacuated_pages = 0
        self._evacuation_bytes = 0
        self._evac_deadline_misses = 0
        self._preempt_margin_s: Optional[float] = None
        self._ttfts = collections.deque(maxlen=4096)
        # unified telemetry plane: fleet identity on every
        # replica's metric labels + trace track, the fleet TTFT
        # histogram, and a scrape-time collector exporting the router
        # ledger (fenced/resubmitted/timeouts/rejected/handoffs) and the
        # fleet rollup as first-class series
        self._tm_on = getattr(cfg, "telemetry", "on") != "off"
        self._tm_uid = next(_ROUTER_IDS)
        for r, eng in enumerate(self.engines):
            eng.set_telemetry_identity(r, self.roles[r])
        self._tm_ttft = None
        # unconditional: configure() is how telemetry="off" reaches the
        # recorder's own gate (an env FF_FLIGHT_DIR must not keep it
        # live under an off config)
        flightrec.configure(cfg)
        if self._tm_on:
            if getattr(cfg, "metrics_port", 0):
                telemetry.start_http_server(cfg.metrics_port)
            # resolve the settle-path histogram child once (the engine's
            # _tm_bind_children discipline): no registry lookup per
            # completion
            self._tm_ttft = telemetry.registry().histogram(
                "ff_router_ttft_seconds",
                "router submit -> first token (queue wait included — "
                "what shedding bounds)").labels()
            telemetry.registry().add_collector(self._tm_collect)
            # flight recorder + SLO health plane: the fleet
            # ledger rides every post-mortem bundle, and health() — the
            # probe that never blocks behind a mid-tick replica — feeds
            # the /healthz rollup (ok|degraded|breach)
            flightrec.recorder().attach_source(self._flightrec_source)
            flightrec.register_health_source(self._health_probe)
        self._threads: List[threading.Thread] = []
        self._started = False
        if start:
            self.start()

    # ---- lifecycle ----------------------------------------------------------

    def start(self):
        """Spawn one driver thread per replica (idempotent)."""
        with self._lock:
            if self._started:
                return
            self._started = True
            # the heartbeats start now, not at construction: a warmup
            # between the two would otherwise read as a hang to the first
            # sweep, before the replica's own driver has ticked once
            self._heartbeat = [time.monotonic()] * self.n
        self._threads = [
            threading.Thread(target=self._replica_main, args=(r,),
                             daemon=True, name=f"ff-router-replica-{r}")
            for r in range(self.n)]
        for t in self._threads:
            t.start()

    def submit(self, prompt, max_new_tokens: int,
               deadline_s: Optional[float] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               top_k: Optional[int] = None,
               seed: Optional[int] = None,
               adapter: Optional[str] = None) -> FleetRequest:
        """Queue one request (validated synchronously against replica
        0's admission rules, so a malformed request raises HERE, not on
        a driver thread). Over ``max_queue``, returns immediately with
        state ``"rejected"`` — shedding is a fast status, not an
        exception, so a loaded front door costs one queue-length check."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens}: must be >= 1")
        eng0 = self.engines[0]
        bucket = eng0._bucket(prompt.size)
        if bucket + max_new_tokens > eng0.max_seq_len:
            raise ValueError(
                f"bucketed prompt ({bucket}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len {eng0.max_seq_len}")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s={deadline_s}: must be >= 0")
        t, p, k = sampling_ops.validate_sampling(
            temperature if temperature is not None
            else eng0.default_temperature,
            top_p if top_p is not None else eng0.default_top_p,
            top_k if top_k is not None else eng0.default_top_k,
            "router.submit")
        if adapter is not None:
            if eng0.lora is None:
                raise ValueError(
                    f"adapter={adapter!r}: this fleet has no adapter "
                    f"pool (build replicas with adapter_pool_pages > 0)")
            if adapter not in eng0.lora.registry:
                raise ValueError(
                    f"adapter {adapter!r} is not registered (known: "
                    f"{sorted(eng0.lora.registry)}) — "
                    f"router.register_adapter first")
        now = time.perf_counter()
        # adapter-aware affinity: the key IS the trie's (namespaced)
        # first edge, so equal key still guarantees a trie hit on the
        # home replica — tenants never alias each other's homes
        affinity = (RadixPrefixCache.first_chunk(
            prompt[:self.page_size], adapter)
            if prompt.size >= self.page_size else None)
        with self._lock:
            if self._draining:
                raise RuntimeError(
                    "ServingRouter is draining: new requests are not "
                    "admitted")
            req = FleetRequest(
                rid=self._next_rid, prompt=prompt,
                max_new_tokens=int(max_new_tokens),
                temperature=t, top_p=p, top_k=k,
                # the seed is assigned HERE (fleet rid, stable across
                # failover) unless the caller pins one
                seed=(int(seed) if seed is not None
                      else self._next_rid & 0x7FFFFFFF),
                adapter=adapter,
                deadline=(now + deadline_s if deadline_s is not None
                          else None),
                affinity=affinity, t_submit=now)
            req.trace_id = f"req-{self._tm_uid}-{req.rid}"
            self._next_rid += 1
            self._submitted += 1
            if self._tm_on:
                # the fleet-wide root span: open until settlement, so
                # every engine/handoff/failover span nests inside it
                req.root_span = telemetry.tracer().begin(
                    "request", trace_id=req.trace_id, track="router",
                    prompt_tokens=int(prompt.size),
                    max_new_tokens=int(max_new_tokens))
            if self.max_queue and len(self._queue) >= self.max_queue:
                req.state = "rejected"
                req.error = f"router queue full ({self.max_queue})"
                req.t_done = time.perf_counter()
                self._rejected += 1
                telemetry.tracer().end(req.root_span, state="rejected")
                req.root_span = 0
                return req
            self._queue.append(req)
        return req

    def run(self, prompts, max_new_tokens: int = 32,
            deadline_s: Optional[float] = None,
            timeout: Optional[float] = None,
            **submit_kw) -> List[FleetRequest]:
        """Submit ``prompts`` and block until every one settles; returns
        the requests in submission order (rejected/expired included).
        Extra kwargs (temperature/top_p/top_k/seed/adapter) forward to
        submit()."""
        self.start()
        reqs = [self.submit(p, max_new_tokens, deadline_s=deadline_s,
                            **submit_kw)
                for p in prompts]
        self.wait(reqs, timeout=timeout)
        return reqs

    def register_adapter(self, name: str, weights: Dict,
                         alpha: Optional[float] = None) -> None:
        """Register a LoRA adapter on EVERY replica (the fleet shares
        one registry view, so failover and handoff always find the
        adapter wherever a request lands). Replacement is pre-validated
        across the whole fleet BEFORE any replica mutates: if the
        adapter is pinned by live slots anywhere, nothing changes — a
        partial fan-out would serve two weight versions under one name,
        and a failover between them would splice streams. (Quiesce the
        tenant's traffic before replacing an adapter: the pre-check
        races in-flight admissions by design — it closes the ordering
        gap, not the concurrency one.)"""
        pinned = []
        for r, eng in enumerate(self.engines):
            if eng.lora is None:
                raise RuntimeError(
                    "this fleet has no adapter pool: build replicas "
                    "with adapter_pool_pages > 0")
            if self._fenced[r] or self._retired[r]:
                continue
            res = eng.lora.resident.get(name)
            if res is not None and res.ref > 0:
                pinned.append(r)
        if pinned:
            raise ValueError(
                f"adapter {name!r} is pinned by live slots on "
                f"replica(s) {pinned}: drain its traffic before "
                f"replacing it (no replica was modified)")
        for r, eng in enumerate(self.engines):
            if self._fenced[r] or self._retired[r]:
                continue
            eng.register_adapter(name, weights, alpha)
        # replayed onto replicas added later (add_replica), so the whole
        # fleet — newcomers included — shares one registry view and a
        # retiree's tenants keep serving from survivors with no caller
        # re-register
        with self._lock:
            self._adapter_registry[name] = (weights, alpha)

    def wait(self, reqs: Optional[List[FleetRequest]] = None,
             timeout: Optional[float] = None):
        """Block until ``reqs`` (default: everything outstanding) settle.
        This is also where fleet-level liveness runs when the caller's
        thread is the only healthy one left: the hang sweep and the
        no-survivors check. Brings the drivers up if nobody has yet —
        only driver threads move queued work, so waiting on an
        un-started fleet would otherwise spin forever."""
        self.start()
        t0 = time.monotonic()
        while True:
            with self._lock:
                self._sweep_hangs_locked()
                self._fail_if_no_survivors_locked()
                if reqs is None:
                    open_work = (bool(self._queue)
                                 or any(self._outstanding)
                                 or any(self._to_submit))
                else:
                    open_work = any(not r.settled for r in reqs)
            if not open_work:
                return
            if self._stop.is_set():
                raise RuntimeError(
                    "router.wait: the router was closed with work still "
                    "open — close() abandons un-settled requests")
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"router.wait: work still open after {timeout}s "
                    f"(health: {self.health()})")
            time.sleep(0.003)

    def warmup(self, prompts, max_new_tokens: int = 4):
        """Drive ``prompts`` through EVERY replica engine directly
        (bypassing the router queue) via ``ServingEngine.warmup`` — all
        cold-prefill buckets, every (bucket, matched_pages) hit variant
        the set can reach (two passes: publish, then saturated repeat),
        the decode/verify programs, and (for role-split or tiered
        fleets) the shared page-import writer — so failover AND handoff
        traffic later hits only warm programs: the smoke asserts zero
        survivor recompiles through a mid-flight crash of the prefill
        replica. Call while the fleet is quiet (before routed
        traffic)."""
        plist = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        # captured so add_replica() can warm a scaled-out engine to the
        # same program set before it takes traffic
        self._warm_prompts = ([p.copy() for p in plist],
                              int(max_new_tokens))
        for r, eng in enumerate(self.engines):
            if self._fenced[r] or self._retired[r]:
                continue
            eng.warmup(plist, max_new_tokens=max_new_tokens)
        # ANY prefix-cached replica can receive a page slab now — from a
        # prefill handoff or from a retiring/preempted peer's evacuation
        # — so the shared import writer is warmed fleet-wide,
        # not just on role-split fleets: a preemption mid-flood must
        # cost survivors zero compiles
        if any(eng.prefix_cache is not None for eng in self.engines):
            cand = max((p for p in plist if p.size >= self.page_size),
                       key=lambda p: p.size, default=None)
            for r, eng in enumerate(self.engines):
                if (eng.prefix_cache is None or self._fenced[r]
                        or self._retired[r]):
                    continue
                if cand is None or not eng.warm_page_import(cand):
                    fflogger.warning(
                        "router: warmup could not warm replica %d's "
                        "page-import writer — its first handoff will "
                        "compile it", r)
        if self._tm_on:
            # every replica's warmup already rebaselined; one more after
            # the LAST replica restarts the fleet-wide window clock too
            flightrec.slo_monitor().rebaseline()

    def drain(self) -> Dict:
        """Graceful fleet shutdown: stop admitting, let the drivers
        finish everything queued and in flight, stop the threads, drain
        the surviving engines, return a final stats snapshot."""
        with self._lock:
            self._draining = True
        self.start()    # a start=False fleet still owes its queued work
        self.wait(None)
        self.close()
        for r, eng in enumerate(self.engines):
            if not self._fenced[r] and not self._retired[r]:
                eng.drain()
        snap = self.stats()
        snap["drained"] = True
        fflogger.info(
            "router: drained — %d completed, %d failed, %d timeouts, "
            "%d rejected; %d fenced, %d resubmitted",
            snap["completed"], snap["failed"], snap["timeouts"],
            snap["rejected"], snap["fenced"], snap["resubmitted"])
        return snap

    def close(self):
        """Stop the driver threads without waiting for open work (the
        work stays un-settled); idempotent."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)

    # ---- rolling deploy hooks (a deployer drives these) ---------------------

    def suspend_replica(self, r: int):
        """Stop dispatching NEW work to replica r; its driver keeps
        ticking so in-flight work drains naturally, and the hang sweep
        never fences it (an idle replica has no outstanding work). The
        deployer's drain-swap-warmup window."""
        with self._lock:
            self._suspended[r] = True
            self.engines[r].deploy_state = "draining"

    def resume_replica(self, r: int):
        """Readmit replica r to dispatch after a swap (or an aborted
        one). Affinity entries recorded for it under its PREVIOUS
        version are dropped — the swap flushed those pages."""
        with self._lock:
            self._suspended[r] = False
            self._drop_affinity_locked(r)
            # only the drain gate resets here: "canary" belongs to the
            # deployer, which resumes the canary so it RECEIVES soak
            # traffic while still being judged (and drilled) as canary
            if self.engines[r].deploy_state == "draining":
                self.engines[r].deploy_state = "serving"

    def replica_quiesced(self, r: int) -> bool:
        """True when replica r owes the router nothing: no outstanding
        engine work and nothing assigned-but-not-submitted."""
        with self._lock:
            return (not self._outstanding[r]
                    and not self._to_submit[r])

    def _drop_affinity_locked(self, r: int):
        for key in [k for k, v in self._affinity.items() if v[0] == r]:
            del self._affinity[key]

    def set_deploying(self, on: bool):
        """Mark a roll in progress: /healthz degrades (never breaches)
        while this is set (flightrec.health_rollup)."""
        with self._lock:
            self._deploying = bool(on)

    def note_swap(self):
        with self._lock:
            self._swaps_completed += 1

    def note_rollback(self):
        with self._lock:
            self._rollbacks += 1

    # ---- elastic fleet: live membership + preemption -------------

    def add_replica(self, role: str = "mixed", warmup_prompts=None,
                    max_new_tokens: int = 4) -> int:
        """Scale OUT: build one more replica engine and admit it to the
        fleet. The engine is constructed, adapter-replayed and warmed
        entirely OFF the router lock (the live fleet keeps serving
        through the whole build), then joins under one short lock
        acquisition: parallel lists extend, a driver thread spawns, and
        the SLO windows rebaseline so the capacity step does not smear
        into the breach history. Warmup uses ``warmup_prompts`` when
        given, else the prompt set the fleet's own warmup() captured —
        either way the newcomer's programs (page-import writer included,
        so it can receive evacuation/handoff slabs) are warm BEFORE its
        first dispatch: scale-out adds capacity, never a compile stall.
        Returns the new replica index."""
        if role not in self.ROLES:
            raise ValueError(
                f"role={role!r}: must be one of {self.ROLES}")
        with self._lock:
            if self._draining:
                raise RuntimeError(
                    "ServingRouter is draining: the fleet cannot grow")
            registry = list(self._adapter_registry.items())
            warm = self._warm_prompts
        eng = self.model.make_serving_engine(**self._engine_kwargs)
        if eng.lora is not None:
            for name, (weights, alpha) in registry:
                eng.register_adapter(name, weights, alpha)
        if warmup_prompts is not None:
            warm = ([np.asarray(p, np.int32).reshape(-1)
                     for p in warmup_prompts], int(max_new_tokens))
        if warm is not None:
            plist, mnt = warm
            eng.warmup(plist, max_new_tokens=mnt)
            if eng.prefix_cache is not None:
                cand = max((p for p in plist
                            if p.size >= self.page_size),
                           key=lambda p: p.size, default=None)
                if cand is not None:
                    eng.warm_page_import(cand)
        with self._lock:
            r = self.n
            self.engines.append(eng)
            self.roles.append(role)
            self._outstanding.append({})
            self._to_submit.append(collections.deque())
            self._fenced.append(False)
            self._fence_reason.append("")
            self._retired.append(False)
            self._suspended.append(False)
            self._heartbeat.append(time.monotonic())
            self._busy_ticks.append(0)
            self.n += 1
            self._scale_outs += 1
            self._handoff_capable = (
                any(t == "prefill" for t in self.roles)
                and self.engines[0].prefix_cache is not None)
            eng.set_telemetry_identity(r, role)
            thread = None
            if self._started:
                thread = threading.Thread(
                    target=self._replica_main, args=(r,), daemon=True,
                    name=f"ff-router-replica-{r}")
                self._threads.append(thread)
        if thread is not None:
            thread.start()
        if self._tm_on:
            telemetry.tracer().instant("scale_out", track="router",
                                       replica=r, role=role,
                                       warmed=warm is not None)
            flightrec.slo_monitor().rebaseline()
        fflogger.info(
            "router: scaled OUT to replica %d (role %s, warmed=%s, "
            "%d adapters replayed)", r, role, warm is not None,
            len(registry))
        return r

    def remove_replica(self, r: int, timeout_s: float = 60.0) -> Dict:
        """Scale IN: retire replica r without losing a request or a
        cached prefix. The replica is first suspended (no new
        dispatches), its never-admitted work — the engine queue drain()
        deliberately parks plus anything assigned
        but not yet handed over — is requeued to survivors, in-flight
        requests finish in place (bounded by ``timeout_s``; a replica
        that cannot quiesce is fenced, which resubmits exactly-once),
        the engine drains, and its cached prefix paths are exported as
        page slabs into the least-loaded survivors under their original
        per-version/per-adapter namespaces. Resident adapters already
        live fleet-wide (register_adapter fans out; add_replica
        replays), so tenants keep serving with no caller action.
        Returns an evacuation summary dict."""
        with self._lock:
            self._check_member_locked(r)
            survivors = [s for s in self._alive()
                         if s != r and not self._suspended[s]]
            if not survivors:
                raise RuntimeError(
                    f"remove_replica({r}): no live survivor to inherit "
                    f"its work — the fleet cannot scale below 1")
            if all(self.roles[s] == "prefill" for s in survivors):
                raise RuntimeError(
                    f"remove_replica({r}): the survivors are all "
                    f"prefill replicas — nowhere to decode")
            self._suspended[r] = True
        eng = self.engines[r]
        # pull back un-admitted work, then wait for in-flight slots to
        # retire on the replica's own driver; re-reclaim each pass —
        # racing submissions that were mid-handoff when we suspended
        # land in the engine queue one driver tick later
        pending: Dict[int, object] = {}
        requeued = 0
        t0 = time.monotonic()
        while True:
            for ereq in eng.reclaim_queued():
                pending[id(ereq)] = ereq
            with self._lock:
                requeued += self._pull_unadmitted_locked(
                    r, pending, "scale_in")
                open_work = (bool(self._outstanding[r])
                             or bool(self._to_submit[r]))
                fenced = self._fenced[r]
            if fenced or not open_work:
                break
            if time.monotonic() - t0 > timeout_s:
                with self._lock:
                    self._fence_locked(
                        r, f"scale-in: failed to quiesce in "
                           f"{timeout_s}s")
                    fenced = True
                break
            time.sleep(0.003)
        evac = {"slabs": 0, "pages": 0, "bytes": 0, "paths": 0,
                "deadline_missed": False}
        if not fenced:
            eng.drain()
            evac = self._evacuate_prefixes(r, deadline_t=None)
            # a retired replica reads no weight version: its set (if a
            # deploy gave it one) is freed with its last reader
            eng.release_weights()
        with self._lock:
            self._retired[r] = True
            self._scale_ins += 1
            self._drop_affinity_locked(r)
        if self._tm_on:
            telemetry.tracer().instant(
                "scale_in", track="router", replica=r,
                requeued=requeued, slabs=evac["slabs"],
                pages=evac["pages"])
            flightrec.slo_monitor().rebaseline()
        fflogger.info(
            "router: scaled IN replica %d — %d never-admitted requests "
            "requeued, %d prefix slabs (%d pages, %d bytes) inherited "
            "by survivors", r, requeued, evac["slabs"], evac["pages"],
            evac["bytes"])
        return {"replica": r, "requeued": requeued, "fenced": fenced,
                **evac}

    def request_preempt(self, r: int,
                        deadline_s: Optional[float] = None):
        """Preemption notice for replica r (the programmatic SIGTERM,
        resilience.py's request_preempt applied to the fleet): flag the
        replica for evacuation; its own driver runs the deadline race on
        its next tick. ``deadline_s`` defaults to
        FFConfig.preempt_deadline_s."""
        with self._lock:
            self._check_member_locked(r)
            self._preempt_req[r] = float(
                deadline_s if deadline_s is not None
                else self._default_preempt_deadline_s)

    def install_preempt_handler(self, replica: int = 0,
                                deadline_s: Optional[float] = None):
        """Route a real SIGTERM (the cloud's preemption notice) to
        ``request_preempt(replica, deadline_s)`` — the serving half of
        resilience.py's handler path. Main thread only (signal module
        rule); off the main thread this warns and the owner calls
        request_preempt() itself. Idempotent."""
        if self._sigterm_installed:
            return
        from flexflow_tpu_torch.runtime import resilience

        def _on_sigterm(signum, frame):
            self.request_preempt(replica, deadline_s)

        ok, prev = resilience.install_sigterm(_on_sigterm)
        if ok:
            self._sigterm_installed = True
            self._prev_sigterm = prev
        else:
            fflogger.warning(
                "router: cannot install SIGTERM handler outside the "
                "main thread; call request_preempt() instead")

    def _check_member_locked(self, r: int):
        if r < 0 or r >= self.n:
            raise ValueError(f"replica {r}: not in [0, {self.n})")
        if self._retired[r]:
            raise ValueError(f"replica {r} already retired")
        if self._fenced[r]:
            raise ValueError(
                f"replica {r} is fenced ({self._fence_reason[r]})")

    def _preempt_scheduled(self, r: int) -> bool:
        """Driver-tick check: a pending request_preempt/SIGTERM notice,
        or the FF_FAULT drill ``preempt(<deadline_ms>)@replica:<r>``
        (fires at the replica's first busy tick; the value is the
        evacuation deadline, defaulting to preempt_deadline_s)."""
        if r in self._preempt_req:
            return True
        plan = faultinject.active_plan()
        scheduled, value = plan.pending("preempt", "replica", r)
        if scheduled and self._busy_ticks[r] >= 1:
            plan.at_site("preempt", "replica", r)
            self._preempt_req[r] = (
                value / 1e3 if value is not None
                else self._default_preempt_deadline_s)
            return True
        return False

    def _preempt_now(self, r: int):
        """The evacuation race (runs on replica r's own driver thread,
        which exits right after): against ``deadline_s``, (1) requeue
        every never-admitted request (cheap — host memory), (2) export
        hot prefix paths as page slabs into survivors, hottest first,
        checking the deadline between slabs (FF_FAULT ``slow_evac``
        stalls here), (3) transfer in-flight requests to the router
        queue under one lock acquisition — ownership flips, so the dying
        replica's late completions are discarded by _collect's owner
        check and the survivor's re-decode is the request's ONE stream.
        Evacuated requests count no loss (clean transfer: a survivor
        death afterwards still fails over normally). A blown deadline
        degrades to _fence_locked — whatever was not yet evacuated
        resubmits cold with a loss counted, the existing exactly-once
        path. Either way the replica ends retired."""
        with self._lock:
            if self._fenced[r] or self._retired[r]:
                self._preempt_req.pop(r, None)
                return
            deadline_s = self._preempt_req.pop(
                r, self._default_preempt_deadline_s)
            self._suspended[r] = True
            self._preempts += 1
            self._evacuating.add(r)
        deadline_t = time.perf_counter() + deadline_s
        if self._tm_on:
            telemetry.tracer().instant(
                "preempt", track="router", replica=r,
                deadline_s=deadline_s)
        fflogger.warning(
            "router: replica %d PREEMPTED — evacuating against a "
            "%.3fs deadline", r, deadline_s)
        eng = self.engines[r]
        pending = {id(e): e for e in eng.reclaim_queued()}
        with self._lock:
            evacuated = self._pull_unadmitted_locked(
                r, pending, "preempt")
        evac = self._evacuate_prefixes(r, deadline_t)
        missed = (evac["deadline_missed"]
                  or time.perf_counter() >= deadline_t)
        with self._lock:
            if not missed:
                evacuated += self._evacuate_inflight_locked(r)
            if self._outstanding[r] or self._to_submit[r]:
                # hard-deadline fallback: a clean fence — remaining
                # work resubmits cold through the exactly-once path
                self._evac_deadline_misses += 1
                self._fence_locked(
                    r, f"preempt deadline ({deadline_s:.3f}s) expired "
                       f"mid-evacuation")
            self._retired[r] = True
            self._evacuating.discard(r)
            self._drop_affinity_locked(r)
            margin = deadline_t - time.perf_counter()
            # last drill's deadline headroom (negative = starved)
            self._preempt_margin_s = round(margin, 4)
        if self._tm_on:
            flightrec.trip(
                "preempt", replica=r, deadline_s=deadline_s,
                evacuated_requests=evacuated, slabs=evac["slabs"],
                pages=evac["pages"], bytes=evac["bytes"],
                deadline_missed=missed,
                deadline_margin_s=round(margin, 4))
            flightrec.slo_monitor().rebaseline()
        fflogger.warning(
            "router: replica %d preemption %s — %d requests evacuated, "
            "%d slabs / %d pages / %d bytes inherited, %.3fs deadline "
            "margin", r, "DEADLINE-STARVED (fenced)" if missed
            else "evacuated cleanly", evacuated, evac["slabs"],
            evac["pages"], evac["bytes"], margin)

    def _pull_unadmitted_locked(self, r: int, pending: Dict,
                                reason: str) -> int:
        """Requeue replica r's never-admitted work: everything still on
        the hand-off deque, plus engine-queue requests the caller
        reclaimed (matched by engine-Request identity — ``pending`` maps
        id(ereq) -> ereq and unmatched entries stay for the caller's
        next pass, closing the race where reclaim beats the driver's
        outstanding-ledger write). No loss is counted: the engine never
        admitted these, so requeue is a pure ownership transfer."""
        moved = []
        while self._to_submit[r]:
            req = self._to_submit[r].pop()
            self._outstanding[r].pop(req.rid, None)
            if req.state == "dispatched" and req.replica == r:
                moved.append(req)
        for rid in list(self._outstanding[r].keys()):
            req, ereq = self._outstanding[r][rid]
            if ereq is None or id(ereq) not in pending:
                continue
            del pending[id(ereq)]
            del self._outstanding[r][rid]
            if req.state == "dispatched" and req.replica == r:
                moved.append(req)
        moved.sort(key=lambda q: q.rid)
        now = time.perf_counter()
        for req in moved:
            if req.deadline is not None and now >= req.deadline:
                self._finalize_locked(
                    req, "timeout",
                    f"deadline expired while queued on retiring "
                    f"replica {r}")
                continue
            req.state = "queued"
            req.replica = -1
            req.tokens = []
            self._evacuated_requests += 1
            if self._tm_on:
                telemetry.tracer().instant(
                    "evacuate", trace_id=req.trace_id, track="router",
                    from_replica=r, reason=reason, admitted=False)
        for req in reversed([q for q in moved if q.state == "queued"]):
            self._queue.appendleft(req)
        return sum(1 for q in moved if q.state == "queued")

    def _evacuate_inflight_locked(self, r: int) -> int:
        """Clean ownership transfer of replica r's admitted in-flight
        requests back to the router queue (the preemption path: the
        hardware is going away, so their decode cannot finish here).
        Tokens are discarded — the survivor re-decodes the identical
        stream from scratch — and NO loss is counted: this is an
        evacuation, not a death, so a survivor crash afterwards still
        gets its one failover before the cap."""
        out = self._outstanding[r]
        self._outstanding[r] = {}
        self._to_submit[r].clear()
        now = time.perf_counter()
        moved = []
        for _, (req, _ereq) in sorted(out.items()):
            if req.state != "dispatched" or req.replica != r:
                continue
            if req.deadline is not None and now >= req.deadline:
                self._finalize_locked(
                    req, "timeout",
                    f"deadline expired in flight on preempted "
                    f"replica {r}")
                continue
            req.state = "queued"
            req.replica = -1
            req.tokens = []
            moved.append(req)
            self._evacuated_requests += 1
            if self._tm_on:
                telemetry.tracer().instant(
                    "evacuate", trace_id=req.trace_id, track="router",
                    from_replica=r, reason="preempt", admitted=True)
        for req in reversed(moved):
            self._queue.appendleft(req)
        return len(moved)

    def _evacuate_prefixes(self, r: int,
                           deadline_t: Optional[float]) -> Dict:
        """Export replica r's cached prefix paths as page slabs and
        import each into the least-loaded live survivor, hottest path
        first. ``deadline_t`` (absolute perf_counter, or None for
        unbounded scale-in) is checked BETWEEN slabs — a preemption
        deadline can starve the tail, never wedge mid-transfer. The
        FF_FAULT drill ``slow_evac(<ms>)@evacuate:<n>`` stalls the n-th
        export to make the starved path deterministic. Namespaces ride
        each slab verbatim, so per-version/per-adapter prefixes land on
        survivors under the exact keys they were cached under, and the
        importer's dedupe makes shared interior pages free."""
        eng = self.engines[r]
        stats = {"slabs": 0, "pages": 0, "bytes": 0, "paths": 0,
                 "deadline_missed": False}
        if eng.prefix_cache is None:
            return stats
        manifest = eng.cached_prefix_manifest()
        stats["paths"] = len(manifest)
        plan = faultinject.active_plan()
        for tokens, ns in manifest:
            if (deadline_t is not None
                    and time.perf_counter() >= deadline_t):
                stats["deadline_missed"] = True
                break
            if plan.fire("slow_evac", "evacuate"):
                time.sleep((plan.last_value or 0) / 1e3)
                if (deadline_t is not None
                        and time.perf_counter() >= deadline_t):
                    stats["deadline_missed"] = True
                    break
            slab = eng.export_prefix_path(tokens, ns)
            if slab is None:
                continue        # evicted since the manifest walk
            with self._lock:
                cands = [s for s in self._alive()
                         if s != r and not self._suspended[s]
                         and self.engines[s].prefix_cache is not None]
            if not cands:
                break           # nobody can inherit: stop exporting
            dest = min(cands, key=lambda s: (
                self._load(s), self.engines[s].load()["queued"], s))
            try:
                self.engines[dest].import_prefix_slab(slab)
            except Exception as e:  # noqa: BLE001 — a survivor that
                #   cannot ingest must not abort the whole evacuation
                fflogger.warning(
                    "router: evacuation import on replica %d failed "
                    "(%s) — slab dropped", dest, e)
                continue
            nbytes = _slab_nbytes(slab)
            stats["slabs"] += 1
            # pages CARRIED by the slab (like `bytes`): the importer
            # dedupes pages the survivor already holds, and a dedup is
            # still a successful evacuation, not a smaller one
            stats["pages"] += len(slab["payload"])
            stats["bytes"] += nbytes
            with self._lock:
                self._evacuated_slabs += 1
                self._evacuated_pages += len(slab["payload"])
                self._evacuation_bytes += nbytes
        return stats

    # ---- dispatch (router lock held) ----------------------------------------

    def _alive(self) -> List[int]:
        return [r for r in range(self.n)
                if not self._fenced[r] and not self._retired[r]]

    def _load(self, r: int) -> int:
        # the health() counters, via the router's exact outstanding
        # ledger: dispatched minus settled == active + engine-queued +
        # assigned-but-not-yet-handed-over (the hand-off deque is a
        # SUBSET of outstanding — never add the two)
        return len(self._outstanding[r])

    def _eligible_locked(self, phase: str) -> List[int]:
        """Live replicas whose role fits the request phase. Roles are a
        preference, never a constraint: with the decode side gone,
        prefill replicas decode (the fleet degrades to mixed); with the
        prefill side gone, _classify_locked already downgraded the work
        to the cold path."""
        alive = [r for r in self._alive() if not self._suspended[r]]
        if phase == "prefill":
            return [r for r in alive if self.roles[r] == "prefill"]
        cands = [r for r in alive if self.roles[r] != "prefill"]
        return cands or alive

    def _classify_locked(self, req: FleetRequest):
        """Pick the request's phase at dispatch time (roles and liveness
        change between submit and dispatch): long prompts (>=
        handoff_min_pages matchable full pages) route through a live
        prefill replica for prefill-only + slab handoff — unless their
        prefix is already homed on a live decode-side replica, where a
        direct dispatch is a guaranteed trie hit and the handoff would
        move bytes for nothing. Everything else (and every downgrade
        when the prefill tier is dead or failed) takes the classic
        direct path."""
        if req.phase == "decode":
            return                  # slab in hand, decode placement only
        was_prefill = req.phase == "prefill"
        req.phase = "direct"
        if not self._handoff_capable:
            return
        matchable = (req.prompt.size - 1) // self.page_size
        if matchable < self.handoff_min_pages:
            return
        if not any(self.roles[r] == "prefill" for r in self._alive()):
            if was_prefill:
                # the prefill tier died under this request: cold-path
                # fallback on the decode side, never stranded
                self._handoff_fallbacks += 1
            return
        entry = self._home_locked(req)
        if entry is not None and self.roles[entry[0]] != "prefill":
            return                  # warm home: direct hit beats handoff
        req.phase = "prefill"

    def _affinity_key(self, req: FleetRequest, version: str):
        """The affinity-map key for this request under weight
        ``version``: exactly the trie's version-salted first edge
        (serving.version_ns), so equal key still guarantees a trie hit
        on the home replica. At the default version this is bit-
        identical to the pre-deploy adapter-namespaced key."""
        if req.affinity is None:
            return None
        ns = version_ns(version, req.adapter)
        if ns == req.adapter:
            return req.affinity     # default version: the precomputed key
        return RadixPrefixCache.first_chunk(
            req.prompt[:self.page_size], ns)

    def _home_locked(self, req: FleetRequest):
        """The live (replica, tier) whose trie is guaranteed to hold
        this request's first-page prefix. Affinity entries are keyed by
        the VERSION-SALTED trie edge, so mid-roll the lookup tries each
        live weight version (<= 2 during a roll, 1 otherwise) and only
        trusts an entry whose replica still serves the version it was
        recorded under — a swapped replica's old-version pages are
        flushed, so its stale entries must not steer."""
        if req.affinity is None:
            return None
        seen = set()
        for r0 in self._alive():
            v = self.engines[r0].weight_version
            if v in seen:
                continue
            seen.add(v)
            entry = self._affinity.get(self._affinity_key(req, v))
            if entry is None:
                continue
            home = entry[0]
            if (not self._fenced[home]
                    and self.engines[home].weight_version == v):
                return entry
        return None

    def _pick_replica_locked(self, req: FleetRequest) -> Optional[int]:
        cands = self._eligible_locked(req.phase)
        if not cands:
            return None
        if req.affinity is not None and req.phase != "prefill":
            entry = self._home_locked(req)
            if entry is not None:
                home, _tier = entry
                if home in cands and self._load(home) < self._cap:
                    return home
        cands = [r for r in cands if self._load(r) < self._cap]
        if not cands:
            return None
        # role- and queue-depth-aware least-loaded: the router's exact
        # outstanding ledger first, the engine's live queue depth (the
        # lock-free probe) as the tie-break
        return min(cands, key=lambda r: (
            self._load(r), self.engines[r].load()["queued"], r))

    def _dispatch_locked(self):
        """Assign queued work: expired requests retire as timeout
        BEFORE placement (never dispatched), the rest go to the affinity
        home when it is live and has room, else the least-loaded
        role-eligible replica with room. Assignment only moves the
        request onto the replica's hand-off deque — the driver thread
        performs the actual engine.submit on its own lock, so dispatch
        never blocks behind a replica mid-tick.

        FIFO is per ROLE TIER, not fleet-wide: a phase-"prefill" head
        that cannot place (prefill tier saturated) is SKIPPED — direct
        and decode work behind it still flows to the decode side (one
        full role tier must not stall the whole fleet; prefill requests
        stay FIFO among themselves). A direct/decode request that
        cannot place stops the scan — the decode side is genuinely
        full, which is the pre-role blocking rule."""
        now = time.perf_counter()
        prefill_blocked = False
        i = 0
        while i < len(self._queue):
            req = self._queue[i]
            if req.deadline is not None and now >= req.deadline:
                del self._queue[i]
                self._finalize_locked(
                    req, "timeout", "deadline expired in router queue")
                continue
            self._classify_locked(req)
            if prefill_blocked and req.phase == "prefill":
                i += 1
                continue
            r = self._pick_replica_locked(req)
            if r is None:
                if req.phase == "prefill":
                    prefill_blocked = True
                    i += 1
                    continue
                return
            del self._queue[i]
            req.state = "dispatched"
            req.replica = r
            req.attempts += 1
            self._dispatched += 1
            if self._tm_on:
                telemetry.tracer().instant(
                    "dispatch", trace_id=req.trace_id, track="router",
                    replica=r, phase=req.phase, attempt=req.attempts)
            if req.affinity is not None and req.phase != "prefill":
                # the affinity home is where the prefix DECODES (and
                # therefore publishes); a prefill dispatch must not
                # steal the key from the decode side. Tier starts hbm;
                # the replica's tier events keep it current. The key is
                # salted with the DISPATCHED replica's weight version —
                # the namespace its trie will file the prefix under.
                key = self._affinity_key(
                    req, self.engines[r].weight_version)
                self._affinity[key] = (r, "hbm")
                self._affinity.move_to_end(key)
                while len(self._affinity) > self._affinity_cap:
                    self._affinity.popitem(last=False)
            self._outstanding[r][req.rid] = (req, None)
            self._to_submit[r].append(req)

    def _finalize_locked(self, req: FleetRequest, state: str,
                         error: str = ""):
        req.state = state
        req.error = error
        req.t_done = time.perf_counter()
        if state == "done":
            self._completed += 1
            if req.ttft:
                self._ttfts.append(req.ttft)
                if self._tm_ttft is not None:
                    self._tm_ttft.observe(req.ttft)
        elif state == "timeout":
            self._timeouts += 1
        else:
            self._failed += 1
        telemetry.tracer().end(
            req.root_span, state=state, replica=req.replica,
            attempts=req.attempts, handoff=req.handoff,
            **({"error": error} if error else {}))
        req.root_span = 0

    def _fence_locked(self, r: int, reason: str):
        """Fence replica r: mark it dead, requeue its outstanding work.
        Exactly-once resubmission: a request is resubmitted only from
        state "dispatched" on THIS replica, at most once overall (the
        cap counts replica LOSSES, not dispatches: ``losses`` caps at 2,
        since a clean role-split handoff legitimately dispatches twice
        — prefill then decode — and a failed-over handoff three times),
        and never after its deadline — an expired
        in-flight request is already worthless, so it retires as timeout
        instead of burning survivor capacity."""
        if self._fenced[r]:
            return
        self._fenced[r] = True
        self._fence_reason[r] = reason
        self._fenced_count += 1
        if self._tm_on:
            telemetry.tracer().instant("fence", track="router",
                                       replica=r, reason=reason)
            # a fence IS the incident the flight recorder exists for:
            # snapshot the window (debounced — the crash that caused
            # this fence already opened the pending bundle, so the two
            # triggers merge into one)
            flightrec.trip("replica_fence", replica=r, reason=reason,
                           role=self.roles[r])
        out = self._outstanding[r]
        self._outstanding[r] = {}
        self._to_submit[r].clear()
        now = time.perf_counter()
        requeued = []
        for _, (req, _ereq) in sorted(out.items()):
            if req.state != "dispatched" or req.replica != r:
                continue
            req.losses += 1     # a replica died under this request —
            #                     the exactly-once cap counts LOSSES,
            #                     not dispatches (a clean role-split
            #                     handoff legitimately dispatches twice)
            if req.deadline is not None and now >= req.deadline:
                self._finalize_locked(
                    req, "timeout",
                    f"deadline expired in flight on fenced replica {r}")
            elif req.losses >= 2:
                self._finalize_locked(
                    req, "failed",
                    f"replica lost twice (last: {reason})")
            else:
                req.state = "queued"
                req.replica = -1
                req.tokens = []   # discard the dead replica's partial
                #                   stream: the survivor re-decodes the
                #                   identical greedy tokens from scratch
                #                   (a phase-"prefill" victim re-
                #                   classifies at dispatch: with the
                #                   prefill tier gone it downgrades to
                #                   the cold path on a decode replica)
                requeued.append(req)
                self._resubmitted += 1
                if self._tm_on:
                    # the trace context SURVIVES resubmission: the same
                    # trace_id rides the requeued request, so its spans
                    # on the survivor join the original tree
                    telemetry.tracer().instant(
                        "resubmit", trace_id=req.trace_id,
                        track="router", from_replica=r, reason=reason)
        # front of the queue, original order: failover work has waited
        # longest
        for req in reversed(requeued):
            self._queue.appendleft(req)
        # shared-prefix homes pointing at the corpse re-home on next use
        for key in [k for k, v in self._affinity.items() if v[0] == r]:
            del self._affinity[key]
        fflogger.warning(
            "router: replica %d FENCED (%s) — %d requests resubmitted, "
            "%d survivors", r, reason, len(requeued), len(self._alive()))
        self._fail_if_no_survivors_locked()

    def _sweep_hangs_locked(self):
        """Fence any replica with outstanding work whose driver has not
        heartbeaten within health_timeout_s — run by every healthy
        driver's tick and by wait(), so one wedged replica cannot take
        the detector down with it. A replica racing its preemption
        deadline is left to that deadline."""
        if not self._started:
            return
        now = time.monotonic()
        for r in range(self.n):
            if self._fenced[r] or self._retired[r] or r in self._evacuating:
                continue
            if not self._outstanding[r] and not self._to_submit[r]:
                continue
            if now - self._heartbeat[r] > self.health_timeout_s:
                self._fence_locked(
                    r, f"hang: no heartbeat for {self.health_timeout_s}s")

    def _fail_if_no_survivors_locked(self):
        if self._started and not self._alive():
            while self._queue:
                req = self._queue.popleft()
                self._finalize_locked(
                    req, "failed", "no live replicas")

    # ---- the replica driver thread ------------------------------------------

    def _maybe_injected_fault(self, r: int) -> bool:
        """FF_FAULT fleet drills, checked each busy tick: crash raises
        ReplicaCrash (the driver's except fences and requeues — the real
        crash path end to end); hang stops heartbeating and spins until
        the sweep fences this replica (returns True: exit the driver)."""
        plan = faultinject.active_plan()
        scheduled, value = plan.pending("crash", "replica", r)
        if scheduled and self._busy_ticks[r] >= (value or 1):
            plan.at_site("crash", "replica", r)
            raise ReplicaCrash(f"injected crash@replica:{r} "
                               f"(busy tick {self._busy_ticks[r]})")
        scheduled, value = plan.pending("hang", "replica", r)
        if scheduled and self._busy_ticks[r] >= (value or 1):
            plan.at_site("hang", "replica", r)
            fflogger.warning(
                "router: replica %d injected hang — waiting for the "
                "health sweep to fence it", r)
            while not self._fenced[r] and not self._stop.is_set():
                time.sleep(0.005)
            return True
        return False

    def _replica_main(self, r: int):
        eng = self.engines[r]
        while not self._stop.is_set():
            with self._lock:
                if self._fenced[r] or self._retired[r]:
                    return
                self._sweep_hangs_locked()
                self._dispatch_locked()
                assigned = []
                while self._to_submit[r]:
                    assigned.append(self._to_submit[r].popleft())
                busy = bool(self._outstanding[r])
            # heartbeat BEFORE the tick too: the sweep then measures one
            # tick's duration, not dispatch-wait + tick
            self._heartbeat[r] = time.monotonic()
            try:
                if busy:
                    self._busy_ticks[r] += 1
                    if self._maybe_injected_fault(r):
                        return
                if self._preempt_scheduled(r):
                    # the evacuation runs HERE, on the replica's own
                    # driver thread, then the driver exits. `assigned`
                    # is safe to drop: dispatch already recorded every
                    # entry in the outstanding ledger, and the
                    # evacuation requeues from there.
                    self._preempt_now(r)
                    return
                for req in assigned:
                    if req.phase == "prefill":
                        # prefill-replica half of the handoff: prefill
                        # only, export the slab, bounce the request back
                        # to the router queue for decode placement. An
                        # engine death in here propagates to the fence
                        # below — the exactly-once machinery requeues.
                        self._handoff_prefill(r, eng, req)
                        continue
                    if req.slab is not None:
                        # decode-side ingestion: page scatter + trie
                        # publish; the submit below then admits as a
                        # prefix HIT. A sequence-parallel handoff
                        # carries a LIST of shard slabs, merged in
                        # order through partial-prefix import. Any
                        # import problem falls back to the
                        # cold path — always correct, never lost.
                        slabs = (req.slab if isinstance(req.slab, list)
                                 else [req.slab])
                        try:
                            with telemetry.tracer().span(
                                    "handoff_import",
                                    trace_id=req.trace_id,
                                    track=f"replica{r}",
                                    shards=len(slabs),
                                    pages=sum(len(s.get("payload", []))
                                              for s in slabs)):
                                for sl in slabs:
                                    eng.import_prefix_slab(sl)
                        except Exception as e:  # noqa: BLE001
                            fflogger.warning(
                                "router: slab import on replica %d "
                                "failed (%s) — cold-path fallback", r, e)
                            with self._lock:
                                self._handoff_fallbacks += 1
                        req.slab = None
                    ereq = eng.submit(req.prompt, req.max_new_tokens,
                                      deadline=req.deadline,
                                      trace_id=req.trace_id,
                                      temperature=req.temperature,
                                      top_p=req.top_p, top_k=req.top_k,
                                      seed=req.seed,
                                      adapter=req.adapter)
                    with self._lock:
                        if self._fenced[r]:     # fenced mid-hand-off
                            return
                        self._outstanding[r][req.rid] = (req, ereq)
                progressed = eng.step() if busy else False
            except Exception as e:  # noqa: BLE001 — ANY driver/engine
                #   death is a replica loss; classification happens in
                #   the fence reason
                with self._lock:
                    self._fence_locked(r, f"{type(e).__name__}: {e}")
                return
            self._heartbeat[r] = time.monotonic()
            self._collect(r)
            self._collect_tier_events(r)
            if self._tm_on:
                # fleet-side SLO tick: returns at one time compare
                # until a full window has elapsed
                flightrec.slo_monitor().maybe_evaluate()
            if not progressed and not assigned:
                time.sleep(0.002)   # idle: don't spin the host

    def _handoff_prefill(self, r: int, eng, req: FleetRequest):
        """Prefill-replica half of the role split: run the prefill-only
        admission through the replica's warm bucket programs, export the
        finished prompt's KV pages (+ quantized scales, draft pool
        included) as a host-memory slab, and move the request — slab in
        hand — to the FRONT of the router queue for decode placement
        (handoff work has waited longest). Pool pressure or a failed
        export downgrades to the cold path on a decode replica; an
        engine death propagates to the driver's fence handler, whose
        exactly-once requeue re-classifies the request at its next
        dispatch."""
        slab = None
        sharded = False
        if self.seq_parallel_shards >= 2:
            # monster-prompt path: fan the prefix out across the prefill
            # tier; any problem (too small, lone replica, pressure,
            # export miss) falls through to the single-replica export
            slab = self._seq_parallel_prefill(r, eng, req)
            sharded = slab is not None
        if slab is None:
            with telemetry.tracer().span("handoff_export",
                                         trace_id=req.trace_id,
                                         track=f"replica{r}") as sp:
                if eng.prefill_into_cache(req.prompt,
                                          adapter=req.adapter) is not None:
                    slab = eng.export_prefix_slab(req.prompt,
                                                  adapter=req.adapter)
                sp.annotate(exported=slab is not None)
        with self._lock:
            if self._fenced[r]:
                return          # the fence already requeued this request
            if req.state != "dispatched" or req.replica != r:
                return          # stale: resubmitted elsewhere meanwhile
            self._outstanding[r].pop(req.rid, None)
            req.state = "queued"
            req.replica = -1
            req.phase = "decode" if slab is not None else "direct"
            req.slab = slab
            if slab is not None:
                req.handoff = True
                self._handoffs += 1
                if sharded:
                    self._seq_parallel += 1
            else:
                self._handoff_fallbacks += 1
            self._queue.appendleft(req)

    def _seq_parallel_prefill(self, r: int, eng, req: FleetRequest):
        """Sequence-parallel prefill: split the prompt's
        page-aligned prefix into ``seq_parallel_shards`` contiguous
        page ranges and compute each on a prefill-capable replica —
        shard 0 on THIS replica, later shards on round-robin peers that
        first import the earlier shards' slabs (their shard is then a
        prefix-HIT tail compute, attending real KV for everything
        before it — the causal dependency sequence sharding must
        honor). Each shard exports a partial-prefix slab
        (``export_prefix_slab(start_page=shard start)``); the decode
        replica merges the LIST in order through partial-prefix
        ``import_prefix_slab``, bitwise the single-replica pages
        (tests/test_seq_parallel.py). Returns the slab list, or None —
        prompt too small (< shards * handoff_min_pages full pages),
        no peer alive, pool pressure anywhere, or any shard error —
        and the caller falls back to the single-replica export."""
        shards = self.seq_parallel_shards
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        last = prompt.size // self.page_size
        if last < shards * self.handoff_min_pages:
            return None
        with self._lock:
            cands = [i for i in range(self.n)
                     if not self._fenced[i] and not self._suspended[i]
                     and self.roles[i] in ("prefill", "mixed")]
        if r not in cands or len(cands) < 2:
            return None         # sharding needs a live peer to pay off
        cands.remove(r)
        cands.insert(0, r)      # shard 0 stays home (its KV is local)
        # contiguous page ranges, remainder spread over the front shards
        base, rem = divmod(last, shards)
        bounds = [0]
        for i in range(shards):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        slabs = []
        try:
            with telemetry.tracer().span("seq_parallel_prefill",
                                         trace_id=req.trace_id,
                                         track=f"replica{r}",
                                         shards=shards,
                                         pages=last) as sp:
                for i in range(shards):
                    s_pg, e_pg = bounds[i], bounds[i + 1]
                    eng_i = self.engines[cands[i % len(cands)]]
                    for sl in slabs:
                        # cumulative merge: already-cached chunks are
                        # skipped, so re-imports on a reused replica
                        # are cheap no-ops
                        eng_i.import_prefix_slab(sl)
                    sub = prompt[:e_pg * self.page_size]
                    if eng_i.prefill_into_cache(
                            sub, adapter=req.adapter) is None:
                        sp.annotate(aborted=f"shard{i}_pressure")
                        return None
                    sl = eng_i.export_prefix_slab(
                        sub, adapter=req.adapter, start_page=s_pg)
                    if sl is None:
                        sp.annotate(aborted=f"shard{i}_export")
                        return None
                    slabs.append(sl)
        except Exception as e:  # noqa: BLE001 — any shard failure
            #   downgrades; the single-replica path is always correct
            fflogger.warning(
                "router: sequence-parallel prefill failed (%s) — "
                "single-replica fallback", e)
            return None
        return slabs

    def _collect_tier_events(self, r: int):
        """Fold the replica's depth-1 tier transitions into the affinity
        map's TIER dimension: a demoted prefix keeps routing home (the
        host copy + H2D promotion beats a cold re-prefill anywhere
        else), and a prefix dead in BOTH tiers drops its entry so
        cold-prefix traffic stops chasing a page that no longer
        exists."""
        events = self.engines[r].drain_tier_events()
        if not events:
            return
        with self._lock:
            for key, tier in events:
                entry = self._affinity.get(key)
                if entry is None or entry[0] != r:
                    continue
                if tier is None:
                    del self._affinity[key]
                else:
                    self._affinity[key] = (r, tier)

    def _collect(self, r: int):
        """Finalize engine requests that settled on replica r. Runs on
        r's own driver thread after its step(), so the engine states it
        reads are final; the router lock makes finalize exactly-once
        even against a concurrent fence (state must still be
        "dispatched" and owned by r)."""
        with self._lock:
            out = self._outstanding[r]
            for rid in list(out.keys()):
                req, ereq = out[rid]
                if ereq is None or ereq.state in ("queued", "running"):
                    continue
                del out[rid]
                if req.state != "dispatched" or req.replica != r:
                    continue    # fenced + resubmitted elsewhere: stale
                if ereq.state == "done":
                    req.tokens = list(ereq.tokens)
                    # engine TTFT measures from ENGINE submit; the
                    # router's adds the dispatch wait
                    req.ttft = (ereq.t_submit - req.t_submit) + ereq.ttft
                    self._finalize_locked(req, "done")
                elif ereq.state == "timeout":
                    self._finalize_locked(
                        req, "timeout",
                        ereq.error or "deadline expired in engine queue")
                else:
                    self._finalize_locked(
                        req, "failed", ereq.error or "engine failure")

    # ---- observability ------------------------------------------------------

    def _flightrec_source(self):
        """Post-mortem bundle payload: the fleet ledger + per-replica
        engine rows (stats() reads each engine outside the router lock;
        the recorder's per-source timeout bounds a wedged replica)."""
        return ("router", {"stats": self.stats(),
                           "health": self.health()})

    def _health_probe(self):
        """The /healthz fleet row — health() never takes an engine
        lock, so the rollup answers mid-tick."""
        return {"kind": "router", **self.health()}

    def dump_flight_record(self, directory: Optional[str] = None,
                           **note) -> Optional[str]:
        """Manual post-mortem bundle (the router half of the trigger
        API): synchronous, always writes (merging any pending
        debounced triggers), returns the bundle path — or None when
        telemetry is off. Raises without a configured
        ``FFConfig.flight_recorder_dir`` and no ``directory``."""
        return flightrec.dump("manual", directory=directory,
                              source="router", **note)

    def recent_traces(self, n: int = 32) -> List[Dict]:
        """Span trees of the most recent fleet requests still in the
        bounded trace ring (newest last): per request the root span,
        every child span across replicas (handoff/failover included —
        the trace id survives both), the instant annotations
        (dispatch/resubmit/fault), and a ``complete`` verdict. Export
        the raw ring with ``telemetry.export_chrome_trace()``."""
        tr = telemetry.tracer()
        mine = f"req-{self._tm_uid}-"
        ids = [t for t in tr.trace_ids() if t.startswith(mine)]
        return [tr.trace_tree(t) for t in ids[-n:]]

    def _tm_collect(self, reg):
        """Scrape-time collector: the fleet ledger as ``ff_router_*``
        series (the failure-drill acceptance surface: fenced,
        resubmitted, timeouts, rejected, handoffs), the fleet rollup as
        ``ff_fleet_*``, and per-replica liveness/load labeled
        (replica, role). Engine collectors export their own series."""
        st = self.stats()
        for k, v in st.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            reg.gauge(f"ff_router_{k}",
                      f"ServingRouter stats()['{k}']").set(v)
        for k, v in st["fleet"].items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            reg.gauge(f"ff_fleet_{k}",
                      f"fleet rollup stats()['fleet']['{k}']").set(v)
        for tier, pages in st["fleet"]["pages_by_tier"].items():
            reg.gauge("ff_fleet_kv_pages", "fleet KV pages by tier",
                      labels=("tier",)).labels(tier).set(pages)
        # elastic fleet: the replica-count gauge the
        # autoscaler and dashboards watch, plus the preemption ledger
        reg.gauge("ff_fleet_replica_count",
                  "live (non-fenced, non-retired) replicas"
                  ).set(st["alive"])
        reg.gauge("ff_preempt_total",
                  "replica preemptions handled").set(st["preempts"])
        reg.gauge("ff_preempt_evacuated_requests",
                  "requests cleanly evacuated off retiring/preempted "
                  "replicas (no loss counted)"
                  ).set(st["evacuated_requests"])
        reg.gauge("ff_preempt_evacuated_pages",
                  "prefix-cache pages inherited by survivors"
                  ).set(st["evacuated_pages"])
        reg.gauge("ff_preempt_evacuation_bytes",
                  "host bytes moved by prefix evacuation"
                  ).set(st["evacuation_bytes"])
        reg.gauge("ff_preempt_deadline_misses",
                  "evacuations that blew their deadline and fell back "
                  "to a fence").set(st["evac_deadline_misses"])
        live = reg.gauge("ff_router_replica_up",
                         "1 = replica live, 0 = fenced",
                         labels=("replica", "role"))
        outg = reg.gauge("ff_router_replica_outstanding",
                         "router outstanding ledger per replica",
                         labels=("replica", "role"))
        for row in st["per_replica"]:
            lab = (str(row["replica"]), row["role"])
            live.labels(*lab).set(0 if row["fenced"] else 1)
            outg.labels(*lab).set(row["outstanding"])

    def stats(self) -> Dict:
        """Fleet ledger + per-replica engine stats + the FLEET ROLLUP
        per-replica ``ServingEngine.stats()``
        merged into one ``"fleet"`` dict — aggregate prefix hit rate,
        pages by tier (hbm/host), handoff and migration counters, and
        per-role queue depths — so callers stop looping replicas and
        re-deriving rates by hand. The router counters (fenced,
        resubmitted, timeouts, rejected) are the failure-drill
        acceptance surface; TTFT percentiles cover COMPLETED requests
        and measure router-submit -> first token (queue wait included —
        that is what shedding bounds). Engine snapshots are taken
        OUTSIDE the router lock (each serializes behind its own
        replica's tick only)."""
        eng_stats = [eng.stats() for eng in self.engines]
        with self._lock:
            ttfts = sorted(self._ttfts)

            def pct(p):
                if not ttfts:
                    return 0.0
                return ttfts[min(len(ttfts) - 1, int(p * len(ttfts)))]

            per_replica = []
            for r, eng in enumerate(self.engines):
                row = {"replica": r, "role": self.roles[r],
                       "fenced": self._fenced[r],
                       "fence_reason": self._fence_reason[r],
                       "retired": self._retired[r],
                       "outstanding": self._load(r),
                       "weight_version": eng.weight_version,
                       "deploy_state": eng.deploy_state,
                       "suspended": self._suspended[r],
                       **eng.load()}
                per_replica.append(row)
            retired = sum(self._retired)
            return {
                # "replicas" is the CURRENT fleet size (retirees left
                # cleanly — they are not capacity and not down);
                # "replicas_total" counts every index ever created
                "replicas": self.n - retired,
                "replicas_total": self.n,
                "retired": retired,
                "alive": len(self._alive()),
                "roles": list(self.roles),
                "submitted": self._submitted,
                "dispatched": self._dispatched,
                "completed": self._completed,
                "failed": self._failed,
                "timeouts": self._timeouts,
                "rejected": self._rejected,
                "fenced": self._fenced_count,
                "resubmitted": self._resubmitted,
                "handoffs": self._handoffs,
                "handoff_fallbacks": self._handoff_fallbacks,
                # rolling-deploy ledger (keys pinned):
                # completed per-replica swaps, automatic rollbacks, and
                # whether a roll is in progress right now
                "swaps_completed": self._swaps_completed,
                "rollbacks": self._rollbacks,
                "deploying": self._deploying,
                # elastic-fleet ledger (keys pinned):
                # membership changes + the evacuation half of
                # exactly-once (clean transfers, losses NOT counted)
                "scale_outs": self._scale_outs,
                "scale_ins": self._scale_ins,
                "preempts": self._preempts,
                "evacuated_requests": self._evacuated_requests,
                "evacuated_slabs": self._evacuated_slabs,
                "evacuated_pages": self._evacuated_pages,
                "evacuation_bytes": self._evacuation_bytes,
                "evac_deadline_misses": self._evac_deadline_misses,
                "preempt_margin_s": self._preempt_margin_s,
                "queued": len(self._queue),
                "max_queue": self.max_queue,
                "ttft_p50_ms": round(pct(0.50) * 1e3, 3),
                "ttft_p99_ms": round(pct(0.99) * 1e3, 3),
                "affinity_keys": len(self._affinity),
                "affinity_host_keys": sum(
                    1 for v in self._affinity.values() if v[1] == "host"),
                "per_replica": per_replica,
                "fleet": self._fleet_rollup_locked(eng_stats),
            }

    def _fleet_rollup_locked(self, eng_stats: List[Dict]) -> Dict:
        """Merge per-replica engine stats into ONE fleet dict."""
        agg = {k: sum(s[k] for s in eng_stats)
               for k in ("requests", "completed", "failed", "timeouts",
                         "tokens_generated", "recompiles",
                         "prefix_lookups", "prefix_hits",
                         "prefill_tokens_saved", "prefix_evictions",
                         "kv_pages_hbm", "kv_pages_host",
                         "tier_demotions", "tier_promotions",
                         "tier_demote_failures", "tier_promote_failures",
                         "tier_host_evictions", "tier_pending_migrations",
                         "prefill_only_requests", "prefix_slab_exports",
                         "prefix_slab_imports", "prefix_pages_imported",
                         "partial_slab_imports",
                         "prefill_chunks_interleaved",
                         "prefill_preempted_ticks",
                         "spec_proposed", "spec_accepted",
                         "sampled_requests", "adapter_faults",
                         "adapter_evictions", "adapter_pages_in_use",
                         "adapters_resident")}
        agg["prefix_hit_rate"] = round(
            agg["prefix_hits"] / max(1, agg["prefix_lookups"]), 4)
        agg["spec_accept_rate"] = round(
            agg["spec_accepted"] / max(1, agg["spec_proposed"]), 4)
        agg["pages_by_tier"] = {"hbm": agg.pop("kv_pages_hbm"),
                                "host": agg.pop("kv_pages_host")}
        agg["handoffs"] = self._handoffs
        agg["handoff_fallbacks"] = self._handoff_fallbacks
        agg["seq_parallel_prefills"] = self._seq_parallel
        per_role: Dict[str, Dict] = {}
        for r, role in enumerate(self.roles):
            if self._retired[r]:
                continue    # a retiree is not capacity (its historical
                #             counters still ride the aggregate above)
            row = per_role.setdefault(role, {
                "replicas": 0, "alive": 0, "outstanding": 0,
                "queued": 0, "active_slots": 0})
            row["replicas"] += 1
            if not self._fenced[r]:
                load = self.engines[r].load()
                row["alive"] += 1
                row["outstanding"] += self._load(r)
                row["queued"] += load["queued"]
                row["active_slots"] += load["active_slots"]
        agg["per_role"] = per_role
        return agg

    def health(self) -> Dict:
        """Cheap fleet probe: never takes an engine lock (per-replica
        load rides the lock-free ``load()``), so it answers even while
        every replica is mid-dispatch."""
        with self._lock:
            alive = self._alive()
            open_work = (bool(self._queue) or any(self._outstanding)
                         or any(self._to_submit))
            if self._draining:
                status = "draining" if open_work else "drained"
            elif not alive:
                status = "dead"
            elif open_work:
                status = "busy"
            else:
                status = "idle"
            return {
                "status": status,
                "admitting": not self._draining and bool(alive),
                "alive": len(alive),
                # current fleet size: retirees left cleanly and are not
                # "down" — the /healthz rollup compares alive against
                # this, so a finished scale-in reads ok, not degraded
                "replicas": self.n - sum(self._retired),
                "retired": sum(self._retired),
                "queued": len(self._queue),
                "outstanding": sum(self._load(r) for r in self._alive()),
                "fenced": self._fenced_count,
                "max_queue": self.max_queue,
                # rolling deploy: /healthz reports every
                # replica's weight version, and `deploying` degrades
                # (never breaches) the rollup while a roll is live
                "deploying": self._deploying,
                "weight_versions": [eng.weight_version
                                    for eng in self.engines],
                "deploy_states": [eng.deploy_state
                                  for eng in self.engines],
            }
