"""FFConfig: the subset of the JAX package's configuration that the serving,
training, input-pipeline, fault-tolerance and deploy slices read.

Field names, defaults and validation follow the JAX package's
``config.py``, so a config written for one package means the same in the
other. ``not_ported`` is the error of a feature no slice has ported yet,
naming the ROADMAP item that ports it (the multi-device checkpoint
layouts and the elastic mesh refit, item 8; sequence parallelism and
the overlapped gradient sync, item 9; the search, its simulator and the
graph lint passes, item 10).

The mesh fields (``num_devices``, ``mesh_shape``, ``ici_mesh_shape``,
``dcn_mesh_shape``, ``fsdp_axis``, ``strategies`` and the strategy files)
follow the JAX package's with one departure: an unset ``mesh_shape``
stays None (the JAX config fills ``{"data": num_devices}``), which is how
the port tells the single-device path from the strategy path — a process
alone with no ``mesh_shape`` runs without DTensors, and
``FFModel.mesh_shape`` gives the mesh either path means.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from flexflow_tpu_torch.ops.sampling import validate_sampling

#: where the multi-device features are queued
ROADMAP_MULTI_DEVICE = ("ROADMAP.md queue 1, item 8 (multi-device training "
                        "and serving)")
#: where sequence parallelism, pipelines and placement are queued
ROADMAP_PARALLEL = ("ROADMAP.md queue 1, item 9 (parallel attention, "
                    "pipelines and placement)")
#: where the strategy search, its simulator and the graph lint are queued
ROADMAP_SEARCH = "ROADMAP.md queue 1, item 10 (the strategy search)"

#: fields of later items: (JAX default, the item that ports them); a
#: value other than the default raises ``not_ported`` naming the item
_LATER_FIELDS = {
    "sp_mode": ("ring", ROADMAP_PARALLEL),
    "overlap_grad_sync": (False, ROADMAP_PARALLEL),
    "search_budget": (0, ROADMAP_SEARCH),
    "search_alpha": (0.05, ROADMAP_SEARCH),
    "measure_search_costs": (False, ROADMAP_SEARCH),
    "cost_db_path": ("", ROADMAP_SEARCH),
    "simulator_workspace_size": (2 * 1024 * 1024 * 1024, ROADMAP_SEARCH),
    "taskgraph_file": ("", ROADMAP_SEARCH),
    "enable_parameter_parallel": (False, ROADMAP_SEARCH),
    "enable_attribute_parallel": (False, ROADMAP_SEARCH),
}


def not_ported(feature: str,
               where: str = ROADMAP_MULTI_DEVICE) -> NotImplementedError:
    """The error for a feature a later slice ports (``where``: its
    ROADMAP item)."""
    return NotImplementedError(f"{feature} is not ported to "
                               f"flexflow_tpu_torch yet ({where})")


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    epochs: int = 1
    seed: int = 0
    # ---- the mesh and the strategies (parallel/, runtime/executor.py) ----
    # devices of the mesh: the product of mesh_shape, else the world size
    # of the process group (1 without one)
    num_devices: Optional[int] = None
    # {axis: size}, e.g. {"data": 2, "model": 2}; None (and a world of one)
    # = the single-device path; set, or a world of several ranks, = the
    # strategy path (every weight a DTensor)
    mesh_shape: Optional[Dict[str, int]] = None
    ici_mesh_shape: Optional[Dict[str, int]] = None
    # axis -> the number of hosts it spans (checked against the mesh; the
    # search's two-tier machine model reads it, item 10)
    dcn_mesh_shape: Optional[Dict[str, int]] = None
    # FSDP / ZeRO-3: shard every weight (and its optimizer state) over
    # this mesh axis on top of its strategy — the largest divisible dim
    # not sharded yet; gathered at use, the gradient reduce-scattered.
    # "" = off
    fsdp_axis: str = ""
    # op name -> ParallelConfig; an op without one runs data-parallel on
    # "data" (replicated without a "data" axis)
    strategies: Dict[str, object] = dataclasses.field(default_factory=dict)
    # strategy files (parallel/strategy.py, shared with the JAX package):
    # imported at compile before the mesh is built; exported at compile
    import_strategy_file: str = ""
    export_strategy_file: str = ""
    # fields of later items (see _LATER_FIELDS): JAX's defaults, any other
    # value refused
    sp_mode: str = "ring"
    overlap_grad_sync: bool = False
    search_budget: int = 0
    search_alpha: float = 0.05
    measure_search_costs: object = False
    cost_db_path: str = ""
    simulator_workspace_size: int = 2 * 1024 * 1024 * 1024
    taskgraph_file: str = ""
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    # the graph lint over the strategy table: "off" | "warn" (the port has
    # no lint passes: nothing to warn of) | "strict" (item 10)
    strategy_lint: str = "warn"

    # "bfloat16" runs every op in bf16 (the serving default on the card);
    # "float32" is what the CPU parity tests use. Serving stores its
    # weights in this dtype.
    compute_dtype: str = "float32"

    # ---- training (model.py compile/fit, runtime/executor.py) ----
    # storage dtype of the trained weights (and the optimizer's state);
    # the update's arithmetic is f32 either way
    master_dtype: str = "float32"
    # residual add + LayerNorm as one fused op (models/transformer.py) —
    # the fused_add_layernorm kernel on the card
    use_fused_ln: bool = False
    # False sends the dense attention path to its einsum (or, past 4096
    # positions, blockwise) torch route instead of the flash kernels, as
    # in the JAX package
    use_flash_attention: bool = True
    # one update a dtype bucket (runtime/optimizer.py FusedUpdate): the
    # fused_update kernel on the card, bitwise the per-leaf update
    fused_optimizer: bool = False
    # multi-step training (FFModel.train_scanned): fit() runs up to this
    # many steps a dispatch — on the card one step captured as a CUDA
    # graph and replayed. 0 = one dispatch a step
    scan_steps: int = 0
    # gradient accumulation: each global batch splits into this many equal
    # microbatches, their gradients summed (f32 for bf16 weights) and ONE
    # update made. 1 = off
    grad_accum_steps: int = 1
    # divergence guard (runtime/executor.py guarded_train_step):
    #   "none"    — guard off
    #   "skip"    — a non-finite step leaves weights and optimizer state
    #               untouched
    #   "backoff" — skip, and halve the loss scale on a non-finite step;
    #               double it after loss_scale_growth_interval clean steps
    on_nonfinite: str = "none"
    loss_scale: float = 1.0  # initial loss scale ("backoff" mode)
    loss_scale_growth_interval: int = 200
    # fold each op's chain of weightless elementwise followers into one
    # FusedOp at compile (ops/fused.py apply_fusion); the math is unchanged
    perform_fusion: bool = False
    # label value left out of token-level accuracy (its count AND its
    # denominator) — the pad id of a padded causal-LM batch; None counts
    # every position
    metrics_ignore_index: Optional[int] = None
    # per-op record_function ranges in the step (runtime/profiler.py
    # attributes each kernel to its op); a running torch.profiler turns
    # them on too
    profiling: bool = False

    # ---- the input pipeline (runtime/dataloader.py, native_loader.py,
    # pipeline_loader.py) ----
    # the native threaded gather / prefetch loader (runtime/csrc/
    # dataloader.cc) for host-resident data; Python slicing without g++
    native_dataloader: bool = True
    dataloader_shuffle: bool = False  # one permutation an epoch, seeded
    dataloader_threads: int = 2
    dataloader_prefetch_slots: int = 3
    # keep a dataset on the device (next_batch = a slice of one staged
    # copy) when it fits this budget; over it, the data stays on the host
    device_resident_data: bool = True
    device_data_budget_bytes: int = 2 << 30
    # fit's prefetch worker for host-resident data: batches pulled and
    # copied to the device this many ahead of the step (0 = the
    # synchronous loop). Device-resident data bypasses it
    prefetch_depth: int = 2
    # steps in flight before fit waits on the OLDEST one's completion
    # (0 = wait on each step)
    dispatch_ahead: int = 2

    # ---- fault tolerance (runtime/resilience.py, runtime/checkpoint.py) ----
    # checkpoint directory for the TrainSupervisor / fit() auto-resume;
    # "" = no supervision (fit behaves exactly as before)
    checkpoint_dir: str = ""
    # periodic checkpoint cadence in steps (0 = only preemption / final
    # saves); atomic tmp-dir + rename writes
    checkpoint_every: int = 0
    keep_checkpoints: int = 3  # retention: newest K step dirs survive
    # a periodic save snapshots to host memory in the step and publishes
    # (payload, manifest, rename, retention) on one background thread
    async_checkpointing: bool = False
    # rewind to the last checkpoint after this many CONSECUTIVE non-finite
    # steps (0 = never; needs a checkpoint_dir supervisor and the guard)
    nonfinite_rewind_after: int = 0
    # wall-clock watchdog per train step: dump every thread's stack and
    # abort when a step's host fetch blocks longer than this (0 = off)
    step_timeout_s: float = 0.0
    # verify a checkpoint's content-hash manifest before restoring, and
    # fall back to the newest INTACT step when the latest one fails
    verify_checkpoints: bool = True
    # ---- elastic recovery (runtime/elastic.py) ----
    # a resume whose checkpoint recorded another device count:
    # "resume_resharded" | "research" refit the mesh (ROADMAP item 8:
    # refused on one device), "abort" raises TopologyChangedError
    on_topology_change: str = "resume_resharded"
    elastic_min_devices: int = 1

    # ---- serving (runtime/serving.py) ----
    # decode slots: the engine's batch; the host scheduler admits and
    # retires one request per slot
    serve_slots: int = 4
    # paged KV pool of (kv_pages, kv_page_size, KVH, Dh) pages shared by
    # every slot through per-slot page tables; kv_pages = 0 derives
    # 1 (scratch page 0) + serve_slots * ceil(max_seq_len / kv_page_size)
    kv_page_size: int = 128
    kv_pages: int = 0
    # prompt-length admission buckets (ascending); None = powers of two
    # from 8
    decode_buckets: Optional[List[int]] = None
    # the radix prefix cache (HBM tier): prompts sharing page-aligned
    # prefixes mount the cached pages read-only and prefill their tail
    serve_prefix_cache: bool = True
    # KV-pool storage: native (the compute dtype), bf16, or int8 / fp8 with
    # one f32 scale per (page, kv head); weight-only quantization of the
    # served weights: native, int8 or fp8 (per-output-channel scales)
    kv_cache_dtype: str = "native"
    serve_weight_dtype: str = "native"
    # decode attention route: "auto" / "pallas" the paged-attention
    # kernel, "einsum" the page gather + grouped einsum attention
    paged_attention_impl: str = "auto"
    # per-request sampling defaults (a request's submit() overrides them):
    # temperature 0 = greedy; top_p 1 and top_k 0 = no filter
    serve_temperature: float = 0.0
    serve_top_p: float = 1.0
    serve_top_k: int = 0
    # speculative decoding: a draft FFModel (same vocabulary) proposes this
    # many tokens a slot, one verify pass of the target scores them
    serve_speculate_k: int = 0
    draft_model: Optional[object] = None
    # chunk-interleaved admission: prefill chunks (of the engine's
    # prefill_chunk) run a tick between decode dispatches; 0 = off
    prefill_interleave_chunks: int = 0
    # the prefix cache's host-memory tier: pages evicted under pool
    # pressure demote to this many pinned host pages (0 = no host tier)
    host_kv_pages: int = 0
    # the paged LoRA adapter pool: device pages for concurrently resident
    # adapters (0 = no pool), each holding one adapter's (a, b) for every
    # targeted Linear op at rank serve_lora_rank
    serve_adapter_pool_pages: int = 0
    serve_lora_rank: int = 8

    # ---- the serving fleet (runtime/router.py ServingRouter) ----
    # bound on the router queue: submissions past it are rejected at once
    # (state "rejected"); 0 = unbounded
    serve_max_queue: int = 0
    # one role a replica, comma-separated ("prefill,decode,decode"):
    # prefill replicas hand finished prompt pages to decode replicas as
    # page slabs; "" = every replica "mixed"
    serve_replica_roles: str = ""
    # >= 2 splits a long prompt's page-aligned prefix into that many
    # contiguous shards across the prefill tier; 0 = off
    seq_parallel_shards: int = 0
    # a preempted replica's evacuation deadline (seconds)
    preempt_deadline_s: float = 5.0
    # ---- rolling deployment (runtime/deploy.py) ----
    # the weight-version registry's watch path ("" = pass one to
    # WeightArtifactRegistry directly); the canary's soak in full
    # slo_window_s windows (0 = no soak); one replica's drain ceiling
    deploy_watch_dir: str = ""
    deploy_canary_windows: int = 2
    deploy_drain_timeout_s: float = 120.0
    # ---- the autoscaler (runtime/autoscale.py AutoscalePolicy) ----
    # fleet bounds; scale out after this many consecutive capacity-SLO
    # breach windows, in after this many idle windows, never twice within
    # the cooldown
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 8
    autoscale_breach_windows: int = 2
    autoscale_idle_windows: int = 6
    autoscale_cooldown_s: float = 30.0

    # ---- the telemetry plane (runtime/telemetry.py) ----
    # "on": metrics registry and trace ring record; "off": every emit
    # short-circuits at one predicate
    telemetry: str = "on"
    # serve /metrics, /metrics.json, /trace.json, /healthz and /slo.json on
    # 127.0.0.1:<port> (0 = no server)
    metrics_port: int = 0
    # ---- the flight recorder and SLOs (runtime/flightrec.py) ----
    # post-mortem bundle directory ("" = automatic triggers off;
    # FF_FLIGHT_DIR is the env fallback), retention, cooldown, debounce
    # and the trace window a bundle captures
    flight_recorder_dir: str = ""
    flight_keep: int = 4
    flight_cooldown_s: float = 30.0
    flight_debounce_s: float = 1.0
    flight_window_s: float = 120.0
    # declarative SLOs over sliding windows (0 = that SLO off)
    slo_ttft_p99_s: float = 0.0          # ceiling: p99 TTFT per replica
    slo_queue_wait_p99_s: float = 0.0    # ceiling: engine queue wait p99
    slo_prefix_hit_rate_min: float = 0.0  # floor: prefix-cache hit rate
    slo_spec_accept_min: float = 0.0     # floor: speculative accept rate
    # ceilings over fit's step histogram and the supervisor's stall a save
    slo_step_time_p99_s: float = 0.0
    slo_checkpoint_stall_s: float = 0.0
    slo_window_s: float = 10.0           # sliding evaluation window
    slo_clear_windows: int = 2           # healthy windows to clear
    slo_trip_recorder: bool = False      # a breach also trips the recorder
    # the runtime sanitizer (runtime/locks.py): "" leaves FF_SANITIZE's
    # mode; "on" checks lock order and counts programs built after
    # warmup; "strict" raises on either; "off" disables
    sanitize: str = ""

    def __post_init__(self):
        for field, (default, where) in _LATER_FIELDS.items():
            if getattr(self, field) != default:
                raise not_ported(f"FFConfig.{field}={getattr(self, field)!r}",
                                 where)
        if self.strategy_lint not in ("off", "warn", "strict"):
            raise ValueError(
                f"strategy_lint={self.strategy_lint!r}: must be 'off', "
                f"'warn' or 'strict'")
        if self.strategy_lint == "strict":
            raise not_ported("FFConfig.strategy_lint='strict'",
                             ROADMAP_SEARCH)
        for field in ("mesh_shape", "ici_mesh_shape", "dcn_mesh_shape"):
            shape = getattr(self, field)
            if shape is not None and (not isinstance(shape, dict) or any(
                    not isinstance(v, int) or v < 1
                    for v in shape.values())):
                raise ValueError(f"{field}={shape!r}: must be a dict of "
                                 f"axis name -> positive int size")
        for field in ("ici_mesh_shape", "dcn_mesh_shape"):
            shape = getattr(self, field)
            if shape and self.mesh_shape is not None:
                bad = sorted(set(shape) - set(self.mesh_shape))
                if bad:
                    raise ValueError(f"{field} names axes {bad} absent "
                                     f"from mesh_shape {self.mesh_shape}")
        if self.num_devices is None:
            if self.mesh_shape is not None:
                n = 1
                for v in self.mesh_shape.values():
                    n *= v
                self.num_devices = n
            else:
                from flexflow_tpu_torch.parallel.mesh import world_size

                self.num_devices = world_size()
        for field in ("compute_dtype", "master_dtype"):
            if getattr(self, field) not in ("float32", "bfloat16"):
                raise ValueError(
                    f"{field}={getattr(self, field)!r}: must be 'float32' "
                    f"or 'bfloat16'")
        if self.epochs < 1 or self.grad_accum_steps < 1 \
                or self.scan_steps < 0:
            raise ValueError(
                f"epochs={self.epochs} (>= 1), grad_accum_steps="
                f"{self.grad_accum_steps} (>= 1), scan_steps="
                f"{self.scan_steps} (>= 0)")
        if self.batch_size % self.grad_accum_steps:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"grad_accum_steps {self.grad_accum_steps}")
        if self.on_nonfinite not in ("none", "skip", "backoff"):
            raise ValueError(
                f"on_nonfinite={self.on_nonfinite!r}: must be 'none', "
                f"'skip' or 'backoff'")
        if self.nonfinite_rewind_after < 0 or self.checkpoint_every < 0:
            raise ValueError(
                "nonfinite_rewind_after and checkpoint_every must be >= 0")
        if self.on_topology_change not in ("resume_resharded", "research",
                                           "abort"):
            raise ValueError(
                f"on_topology_change={self.on_topology_change!r}: must be "
                f"'resume_resharded', 'research' or 'abort'")
        if self.elastic_min_devices < 1:
            raise ValueError(
                f"elastic_min_devices={self.elastic_min_devices}: "
                f"must be >= 1")
        if self.prefetch_depth < 0 or self.dispatch_ahead < 0:
            raise ValueError(
                f"prefetch_depth={self.prefetch_depth} and dispatch_ahead="
                f"{self.dispatch_ahead} must be >= 0")
        if self.loss_scale <= 0:
            # 0 would make the guard divide by zero and classify every
            # step non-finite
            raise ValueError(f"loss_scale={self.loss_scale}: must be > 0")
        if self.loss_scale_growth_interval < 1:
            raise ValueError(
                f"loss_scale_growth_interval="
                f"{self.loss_scale_growth_interval}: must be >= 1")
        if self.serve_slots < 1 or self.kv_page_size < 1 \
                or self.kv_pages < 0:
            raise ValueError(
                f"serve_slots={self.serve_slots} (>= 1), "
                f"kv_page_size={self.kv_page_size} (>= 1), "
                f"kv_pages={self.kv_pages} (>= 0, 0 = derive)")
        if self.host_kv_pages < 0:
            raise ValueError(
                f"host_kv_pages={self.host_kv_pages}: must be >= 0 "
                f"(0 = no host tier)")
        if self.kv_page_size & (self.kv_page_size - 1):
            raise ValueError(
                f"kv_page_size={self.kv_page_size}: must be a power of two")
        if self.paged_attention_impl not in ("auto", "pallas", "einsum"):
            raise ValueError(
                f"paged_attention_impl={self.paged_attention_impl!r}: "
                f"must be 'auto', 'pallas' or 'einsum'")
        if self.kv_cache_dtype not in ("native", "bf16", "int8", "fp8"):
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r}: must be "
                f"'native', 'bf16', 'int8' or 'fp8' (exact spelling — a "
                f"typo here would silently serve the wrong KV precision)")
        if self.serve_weight_dtype not in ("native", "int8", "fp8"):
            raise ValueError(
                f"serve_weight_dtype={self.serve_weight_dtype!r}: must "
                f"be 'native', 'int8' or 'fp8'")
        if self.serve_speculate_k < 0:
            raise ValueError(
                f"serve_speculate_k={self.serve_speculate_k}: must be >= 0")
        if self.prefill_interleave_chunks < 0:
            raise ValueError(
                f"prefill_interleave_chunks="
                f"{self.prefill_interleave_chunks}: must be >= 0")
        validate_sampling(
            self.serve_temperature, self.serve_top_p, self.serve_top_k,
            "FFConfig (serve_temperature/serve_top_p/serve_top_k)")
        if self.serve_adapter_pool_pages < 0:
            raise ValueError(
                f"serve_adapter_pool_pages={self.serve_adapter_pool_pages}"
                f": must be >= 0 (0 = no adapter pool)")
        if self.serve_lora_rank < 1:
            raise ValueError(
                f"serve_lora_rank={self.serve_lora_rank}: must be >= 1")
        if self.seq_parallel_shards < 0 or self.seq_parallel_shards == 1:
            raise ValueError(
                f"seq_parallel_shards={self.seq_parallel_shards}: must "
                f"be 0 (off) or >= 2 (shard count)")
        if self.serve_max_queue < 0:
            raise ValueError(
                f"serve_max_queue={self.serve_max_queue}: must be >= 0 "
                f"(0 = unbounded router queue)")
        if self.serve_replica_roles:
            roles = [t.strip()
                     for t in self.serve_replica_roles.split(",")]
            bad = [t for t in roles
                   if t not in ("prefill", "decode", "mixed")]
            if bad or not all(roles):
                raise ValueError(
                    f"serve_replica_roles={self.serve_replica_roles!r}: "
                    f"comma-separated 'prefill'|'decode'|'mixed', one "
                    f"per replica (bad: {bad or 'empty entry'})")
        if self.preempt_deadline_s <= 0:
            raise ValueError(
                f"preempt_deadline_s={self.preempt_deadline_s}: must be "
                f"> 0 (the evacuation race needs a budget)")
        if self.sanitize not in ("", "off", "on", "strict"):
            raise ValueError(
                f"sanitize={self.sanitize!r}: must be '', 'off', "
                f"'on' or 'strict'")
        if self.telemetry not in ("on", "off"):
            raise ValueError(
                f"telemetry={self.telemetry!r}: must be 'on' or 'off'")
        if self.metrics_port < 0 or self.metrics_port > 65535:
            raise ValueError(
                f"metrics_port={self.metrics_port}: must be 0 (no "
                f"server) or a valid TCP port")
        if self.flight_keep < 1:
            raise ValueError(
                f"flight_keep={self.flight_keep}: must be >= 1 (the "
                f"bundle that just fired must survive its own retention)")
        if self.flight_cooldown_s < 0 or self.flight_debounce_s < 0:
            raise ValueError(
                f"flight_cooldown_s={self.flight_cooldown_s} and "
                f"flight_debounce_s={self.flight_debounce_s} must be "
                f">= 0")
        if self.flight_window_s <= 0:
            raise ValueError(
                f"flight_window_s={self.flight_window_s}: must be > 0")
        for knob in ("slo_ttft_p99_s", "slo_queue_wait_p99_s",
                     "slo_step_time_p99_s", "slo_checkpoint_stall_s"):
            if getattr(self, knob) < 0:
                raise ValueError(
                    f"{knob}={getattr(self, knob)}: must be >= 0 "
                    f"(0 = SLO off)")
        for knob in ("slo_prefix_hit_rate_min", "slo_spec_accept_min"):
            v = getattr(self, knob)
            if v < 0 or v > 1:
                raise ValueError(
                    f"{knob}={v}: must be in [0, 1] (0 = SLO off; it "
                    f"is a rate floor)")
        if self.slo_window_s <= 0:
            raise ValueError(
                f"slo_window_s={self.slo_window_s}: must be > 0")
        if self.slo_clear_windows < 1:
            raise ValueError(
                f"slo_clear_windows={self.slo_clear_windows}: must be "
                f">= 1 (a breach must be clearable)")
        if self.deploy_canary_windows < 0:
            raise ValueError(
                f"deploy_canary_windows={self.deploy_canary_windows}: "
                f"must be >= 0 (0 = no canary soak)")
        if self.deploy_drain_timeout_s <= 0:
            raise ValueError(
                f"deploy_drain_timeout_s={self.deploy_drain_timeout_s}: "
                f"must be > 0")
        if self.autoscale_min_replicas < 1:
            raise ValueError(
                f"autoscale_min_replicas={self.autoscale_min_replicas}: "
                f"must be >= 1 (the fleet must keep a survivor)")
        if self.autoscale_max_replicas < self.autoscale_min_replicas:
            raise ValueError(
                f"autoscale_max_replicas={self.autoscale_max_replicas}: "
                f"must be >= autoscale_min_replicas "
                f"({self.autoscale_min_replicas})")
        if self.autoscale_breach_windows < 1:
            raise ValueError(
                f"autoscale_breach_windows={self.autoscale_breach_windows}"
                f": must be >= 1")
        if self.autoscale_idle_windows < 1:
            raise ValueError(
                f"autoscale_idle_windows={self.autoscale_idle_windows}: "
                f"must be >= 1")
        if self.autoscale_cooldown_s < 0:
            raise ValueError(
                f"autoscale_cooldown_s={self.autoscale_cooldown_s}: "
                f"must be >= 0")
        if self.decode_buckets is not None:
            bs = [int(b) for b in self.decode_buckets]
            if not bs or any(b < 1 for b in bs) or sorted(set(bs)) != bs:
                raise ValueError(
                    f"decode_buckets={self.decode_buckets!r}: must be a "
                    f"strictly ascending list of positive ints")

