"""Coordinator configuration: TOML file + environment overrides.

Functional port of the reference's layered settings (reference:
rust/xaynet-server/src/settings/mod.rs): sections [log], [api], [pet],
[mask], [model], [metrics], [redis]/[storage], [restore]; env overrides use
``XAYNET__SECTION__KEY``; cross-field invariants are validated on load
(count min<=max with protocol floors, time min<=max, probability ranges —
settings/mod.rs:307-376).

The port's copy keeps every key the JAX package reads, so one config file
loads in both, and refuses with a ``SettingsError`` what the port does not
have (``Settings.validate_port``): any fold kernel other than ``auto``, and
the knobs of the shard-parallel pipeline. Every store of the JAX package is
served: ``memory``, ``file`` and ``redis`` for the coordinator's state,
``memory``, ``filesystem`` and ``s3`` for the global models.
"""

from __future__ import annotations

import os
import re

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: env/default settings still work
    tomllib = None
from dataclasses import dataclass, field
from typing import Any, Optional

from ..core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from ..core.message import SUM_COUNT_MIN, UPDATE_COUNT_MIN

# the fold kernel names the JAX package accepts (its ``utils/kernels.py``):
# they still parse here, so a JAX config is read through, but only ``auto``
# is served — the port has one fold per device type, K1 on CUDA and the
# plain version on the CPU
FOLD_KERNELS = ("auto", "xla", "pallas", "pallas-interpret", "native-u64")

# tenant ids: lowercase alphanumerics plus ``-``/``_``, at most 32 chars
_TENANT_ID_RE = re.compile(r"^[a-z0-9][a-z0-9_-]{0,31}$")


class SettingsError(ValueError):
    """Invalid or inconsistent configuration."""


@dataclass
class CountSettings:
    min: int
    max: int
    # liveness quorum (quorum <= min <= max): once time.min has elapsed and
    # arrivals stall, a phase with accepted >= quorum closes successfully in
    # DEGRADED mode instead of waiting for count.min and timing out. None
    # means quorum == min: no degraded completion for this phase.
    quorum: Optional[int] = None

    @property
    def effective_quorum(self) -> int:
        """The quorum actually enforced (clamped so quorum <= min always
        holds even after an adaptive controller shrank ``min``)."""
        return self.min if self.quorum is None else min(self.quorum, self.min)


@dataclass
class TimeSettings:
    min: float
    max: float


@dataclass
class PhaseSettings:
    prob: float
    count: CountSettings
    time: TimeSettings


@dataclass
class Sum2Settings:
    count: CountSettings
    time: TimeSettings


@dataclass
class PetSettings:
    sum: PhaseSettings
    update: PhaseSettings
    sum2: Sum2Settings

    def validate(self) -> None:
        for name, phase, floor in (
            ("sum", self.sum, SUM_COUNT_MIN),
            ("update", self.update, UPDATE_COUNT_MIN),
        ):
            if not (0.0 < phase.prob <= 1.0) if name == "sum" else not (0.0 <= phase.prob < 1.0):
                raise SettingsError(f"pet.{name}.prob out of range")
            if phase.count.min < floor:
                raise SettingsError(f"pet.{name}.count.min must be >= {floor}")
            if phase.count.max < phase.count.min:
                raise SettingsError(f"pet.{name}.count.max must be >= count.min")
            if phase.time.max < phase.time.min:
                raise SettingsError(f"pet.{name}.time.max must be >= time.min")
            self._validate_quorum(name, phase.count, floor)
        if self.sum2.count.min < SUM_COUNT_MIN:
            raise SettingsError("pet.sum2.count.min must be >= 1")
        if self.sum2.count.max < self.sum2.count.min:
            raise SettingsError("pet.sum2.count.max must be >= count.min")
        if self.sum2.time.max < self.sum2.time.min:
            raise SettingsError("pet.sum2.time.max must be >= time.min")
        self._validate_quorum("sum2", self.sum2.count, SUM_COUNT_MIN)

    @staticmethod
    def _validate_quorum(name: str, count: CountSettings, floor: int) -> None:
        if count.quorum is None:
            return
        if count.quorum < floor:
            raise SettingsError(f"pet.{name}.count.quorum must be >= {floor}")
        if count.quorum > count.min:
            raise SettingsError(f"pet.{name}.count.quorum must be <= count.min")


@dataclass
class MaskSettings:
    group_type: GroupType = GroupType.PRIME
    data_type: DataType = DataType.F32
    bound_type: BoundType = BoundType.B0
    model_type: ModelType = ModelType.M3
    # pre-mask quantization level (docs/DESIGN.md §17): level q divides the
    # fixed-point scale by 10^q, shrinking the group order — and with it
    # limb count, wire width, and every mask/fold/transfer byte — at the
    # price of 10^q coarser weights. 0 = the exact catalogue config. The
    # level rides in the round params' mask-config bytes, so participants
    # follow automatically; gate accuracy per workload (the cifar_lenet
    # example carries the reference gate).
    quant: int = 0

    def to_config(self) -> MaskConfig:
        return MaskConfig(
            self.group_type, self.data_type, self.bound_type, self.model_type, self.quant
        )


@dataclass
class ModelSettings:
    length: int = 4


@dataclass
class ApiSettings:
    bind_address: str = "127.0.0.1:8081"
    tls_certificate: Optional[str] = None
    tls_key: Optional[str] = None
    tls_client_auth: Optional[str] = None

    def validate(self) -> None:
        if (self.tls_certificate is None) != (self.tls_key is None):
            raise SettingsError("api TLS requires both certificate and key")


@dataclass
class StorageSettings:
    backend: str = "memory"  # memory | filesystem | s3 (models)
    model_dir: str = "./global_models"
    # coordinator dictionary backend: memory | file | redis
    coordinator: str = "memory"
    redis_host: str = "127.0.0.1"
    redis_port: int = 6379
    redis_db: int = 0
    # s3 backend (Minio/GCS-interop/AWS; reference settings/s3.rs)
    s3_endpoint: str = "http://127.0.0.1:9000"
    s3_bucket: str = "global-models"
    s3_access_key: str = ""
    s3_secret_key: str = ""
    s3_region: str = "us-east-1"


@dataclass
class RestoreSettings:
    enable: bool = False


@dataclass
class MetricsSettings:
    enable: bool = False
    sink: str = "log"  # log | jsonl | influx (file) | influx-http (network)
    path: str = "./metrics.jsonl"
    url: str = "http://127.0.0.1:8086"  # influx-http write endpoint
    database: str = "metrics"
    # per-round JSON report artifact (JSONL; empty disables). Independent of
    # `enable`: the in-process telemetry registry is always on — enable/sink
    # only control the external line-protocol export.
    round_report_path: str = ""
    # distributed round tracing (docs/DESIGN.md §16): "on" records spans
    # and exports one Chrome-trace JSON per round (when trace_dir is set);
    # "failure" keeps only the bounded flight-recorder ring (spans exist
    # for failure forensics, no per-round export); "off" makes spans no-ops.
    # "" (the default) defers to XAYNET_TRACE (default on) — an explicit
    # config value overrides the env
    trace: str = ""
    # per-round Chrome-trace export directory (empty disables the export;
    # the ring/flight recorder is unaffected)
    trace_dir: str = ""
    # flight-recorder dump directory ("" = XAYNET_FLIGHT_DIR, else the
    # system temp dir)
    flight_dir: str = ""


@dataclass
class LoggingSettings:
    filter: str = "info"


@dataclass
class AggregationSettings:
    # read for the JAX package's configs, where false picks its host fold;
    # the port has no host fold beside the device one and folds on the
    # device the runner resolved (CUDA unless the caller of serve() passes
    # another) either way. wire_ingest still requires true, as there
    device: bool = False
    batch_size: int = 64  # staged updates per device fold
    # the port serves only "auto" (K1 on CUDA, the plain version on the
    # CPU); the JAX package's xla, pallas, pallas-interpret and native-u64
    # are refused by validate_port
    kernel: str = "auto"
    # streaming pipeline: how many submitted fold batches may be in flight
    # behind the fold worker before flush() backpressures
    dispatch_ahead: int = 2
    # the pipeline's staging ring (each buffer batch_size x model-sized);
    # batch N+1 stages into one while batch N folds — >= dispatch_ahead + 1
    # for full overlap, minimum 2
    staging_buffers: int = 3
    # the JAX package's per-device fold workers on a multi-device mesh; the
    # port runs on one device, and validate_port refuses false
    shard_parallel: bool = True
    # the JAX package's per-shard native-u64 thread budget; the port has
    # neither shards nor that kernel, and validate_port refuses anything
    # but 0
    shard_threads: int = 0
    # packed byte-planar staging (docs/DESIGN.md §17): planar update
    # batches stage as ceil(log2(order)/8)-byte planes instead of full
    # uint32 limb planes — bpn/(4L) of the ring memory and host->device
    # bytes (75% for the standard 2-limb f32 configs), byte-identical
    # aggregate. Auto-skipped when the order fills its limbs exactly
    packed_staging: bool = True
    # device wire ingest (requires device=true): Update masked models are
    # parsed LAZILY (raw element block kept), and unpack + per-update
    # element validity + fold all run on the accelerator — the coordinator
    # never executes the host element parse. Rejection semantics: an
    # invalid element fails validate_aggregation (message rejected before
    # its seed-dict insert) instead of the eager parse's DecodeError — the
    # same update rejected, one pipeline stage later.
    wire_ingest: bool = False


@dataclass
class IngestSettings:
    """Admission-controlled batched ingest (``xaynet_tpu_torch.ingest``).

    Defaults keep single-node behavior identical to the direct path: the
    pipeline is off unless enabled, and when enabled the bounds are generous
    enough that an un-saturated coordinator never sheds.
    """

    enabled: bool = False
    # bounded intake topology: total capacity = shards * queue_bound
    shards: int = 2
    queue_bound: int = 1024  # per-shard ceiling (hard bound, never exceeded)
    # admission hysteresis as fractions of total capacity: shed at/above
    # high, resume below low (low <= high)
    high_watermark: float = 0.8
    low_watermark: float = 0.5
    # decrypt worker pool: drain up to max_batch messages per thread-pool
    # hop, waiting at most linger_ms for the batch to fill
    max_batch: int = 32
    linger_ms: float = 2.0
    # update coalescing: group verified UpdateRequests into micro-batches
    # submitted to the state machine (and folded) as one stacked dispatch
    coalesce: bool = True
    coalesce_max_batch: int = 32
    coalesce_linger_ms: float = 2.0
    # Retry-After floor handed to shed clients (seconds)
    retry_after_seconds: float = 1.0
    # upload wire format advertised in the round params: "legacy" keeps the
    # v1 interleaved element blocks, "packed" advertises the v2 byte-planar
    # layout (core.mask.serialization.WIRE_PLANAR_FLAG). The server parse
    # auto-detects per message, so either setting ACCEPTS both formats —
    # this only steers what well-behaved participants send.
    wire_format: str = "legacy"

    def validate(self) -> None:
        if self.wire_format not in ("legacy", "packed"):
            raise SettingsError("ingest.wire_format must be legacy | packed")
        if self.shards < 1:
            raise SettingsError("ingest.shards must be >= 1")
        if self.queue_bound < 1:
            raise SettingsError("ingest.queue_bound must be >= 1")
        if not (0.0 < self.low_watermark <= self.high_watermark <= 1.0):
            raise SettingsError(
                "ingest watermarks must satisfy 0 < low <= high <= 1"
            )
        if self.max_batch < 1 or self.coalesce_max_batch < 1:
            raise SettingsError("ingest batch sizes must be >= 1")
        if self.linger_ms < 0 or self.coalesce_linger_ms < 0:
            raise SettingsError("ingest linger must be >= 0")
        if self.retry_after_seconds <= 0:
            raise SettingsError("ingest.retry_after_seconds must be > 0")


@dataclass
class LoadgenSettings:
    """Sim-fed load generation (``xaynet_tpu.loadgen``, docs/DESIGN.md §21).

    Consumed by the loadgen runner / bench harness, not the coordinator —
    it lives in the same TOML so one config file describes a whole soak
    (coordinator + traffic source), like ``[edge]`` does for the edge tier.
    """

    participants: int = 2000  # simulated update participants per round
    drivers: int = 1  # process-sharded replay drivers (participant ranges)
    block_size: int = 512  # participants per jitted population block
    tenants: str = ""  # csv tenant ids to spread across ("" = root routes)
    wire: str = "auto"  # auto (follow round params) | packed | legacy
    sum_participants: int = 1  # seed-dict width (sum-task population)
    dropout_rate: float = 0.0  # fraction that never uploads
    stragglers: int = 0  # participants delayed by straggle_delay_ms
    straggle_delay_ms: float = 0.0
    concurrency: int = 64  # in-flight uploads per driver
    seed: int = 1  # churn/arrival schedule seed

    def validate(self) -> None:
        if self.participants < 1:
            raise SettingsError("loadgen.participants must be >= 1")
        if self.drivers < 1:
            raise SettingsError("loadgen.drivers must be >= 1")
        if self.block_size < 1:
            raise SettingsError("loadgen.block_size must be >= 1")
        if self.wire not in ("auto", "packed", "legacy"):
            raise SettingsError("loadgen.wire must be auto | packed | legacy")
        if self.sum_participants < 1:
            raise SettingsError("loadgen.sum_participants must be >= 1")
        if not (0.0 <= self.dropout_rate < 1.0):
            raise SettingsError("loadgen.dropout_rate must be in [0, 1)")
        if self.stragglers < 0 or self.straggle_delay_ms < 0:
            raise SettingsError("loadgen straggler settings must be >= 0")
        if self.concurrency < 1:
            raise SettingsError("loadgen.concurrency must be >= 1")


@dataclass
class ResilienceSettings:
    """Retry/breaker policy for storage calls, mid-round checkpoints, and
    fault injection (``xaynet_tpu_torch.resilience``).

    Defaults are safe for every deployment: transient storage faults retry
    in place with bounded backoff, the breaker stops retry pile-ups during
    a real outage, and checkpointing/fault-injection stay off until
    explicitly enabled.
    """

    enabled: bool = True  # wrap the store in retry + circuit breaker
    # retry policy (decorrelated jitter): attempts counts calls, so 1 = no
    # retry; the deadline caps total in-place blocking per storage call
    retry_max_attempts: int = 4
    retry_base_ms: float = 25.0
    retry_max_ms: float = 2000.0
    retry_deadline_s: float = 30.0
    # circuit breaker: consecutive failures before fail-fast, seconds until
    # the half-open probe window, concurrent half-open probes allowed
    breaker_threshold: int = 5
    breaker_reset_s: float = 10.0
    breaker_half_open_max: int = 1
    # durable mid-round aggregate checkpoints (update phase): persist every
    # N fold batches or T seconds, whichever comes first; 0 disables the
    # time trigger
    checkpoint_enabled: bool = False
    checkpoint_every_batches: int = 8
    checkpoint_every_s: float = 30.0
    # Failure-phase round resume: how many times one round may re-enter
    # Update from its checkpoint before falling back to a round restart
    max_resume_attempts: int = 2
    # deterministic fault plan spec ("" = off); see resilience.faults
    fault_plan: str = ""

    def validate(self) -> None:
        if self.retry_max_attempts < 1:
            raise SettingsError("resilience.retry_max_attempts must be >= 1")
        if self.retry_base_ms <= 0 or self.retry_max_ms < self.retry_base_ms:
            raise SettingsError("resilience retry delays need 0 < base <= max")
        if self.retry_deadline_s <= 0:
            raise SettingsError("resilience.retry_deadline_s must be > 0")
        if self.breaker_threshold < 1:
            raise SettingsError("resilience.breaker_threshold must be >= 1")
        if self.breaker_reset_s <= 0:
            raise SettingsError("resilience.breaker_reset_s must be > 0")
        if self.breaker_half_open_max < 1:
            raise SettingsError("resilience.breaker_half_open_max must be >= 1")
        if self.checkpoint_every_batches < 1:
            raise SettingsError("resilience.checkpoint_every_batches must be >= 1")
        if self.checkpoint_every_s < 0:
            raise SettingsError("resilience.checkpoint_every_s must be >= 0")
        if self.max_resume_attempts < 0:
            raise SettingsError("resilience.max_resume_attempts must be >= 0")
        if self.fault_plan:
            from ..resilience.faults import FaultPlan

            try:
                FaultPlan.parse(self.fault_plan)
            except ValueError as e:
                raise SettingsError(f"resilience.fault_plan: {e}") from e


@dataclass
class LivenessSettings:
    """Round liveness under participant churn (docs/DESIGN.md §10).

    Two independent mechanisms: quorum completion (a stalled phase with
    ``accepted >= count.quorum`` closes DEGRADED instead of timing out —
    armed per phase by setting ``pet.<phase>.count.quorum``), and the
    adaptive :class:`~xaynet_tpu.server.round_controller.RoundController`
    (off by default) that re-sizes ``count.min``/``time.max`` across rounds
    with hysteresis when the offered participant load does not match the
    configured window.
    """

    # quorum completion: after time.min, a phase at/above quorum closes
    # degraded once no message has been ACCEPTED for this many seconds
    stall_grace_s: float = 5.0
    # adaptive count windows (RoundController)
    adaptive: bool = False
    shrink_after: int = 2  # consecutive degraded/failed rounds before a shrink
    grow_after: int = 2  # consecutive full rounds before a regrow
    shrink_factor: float = 0.5  # count.min multiplier on shrink (then clamped
    # down to the arrivals actually observed, and up to the protocol floor)
    grow_factor: float = 1.5  # count.min multiplier on regrow (capped at the
    # configured min and the observed arrivals)
    time_relax_factor: float = 1.5  # time.max multiplier on shrink; regrows
    # decay it back toward the configured value
    time_max_ceil_s: float = 3600.0  # absolute ceiling for relaxed time.max
    window: int = 8  # rounds of per-phase arrival history kept

    def validate(self) -> None:
        if self.stall_grace_s <= 0:
            raise SettingsError("liveness.stall_grace_s must be > 0")
        if self.shrink_after < 1 or self.grow_after < 1:
            raise SettingsError("liveness shrink_after/grow_after must be >= 1")
        if not (0.0 < self.shrink_factor < 1.0):
            raise SettingsError("liveness.shrink_factor must be in (0, 1)")
        if self.grow_factor <= 1.0:
            raise SettingsError("liveness.grow_factor must be > 1")
        if self.time_relax_factor < 1.0:
            raise SettingsError("liveness.time_relax_factor must be >= 1")
        if self.time_max_ceil_s <= 0:
            raise SettingsError("liveness.time_max_ceil_s must be > 0")
        if self.window < 1:
            raise SettingsError("liveness.window must be >= 1")


@dataclass
class EdgeSettings:
    """Hierarchical edge pre-aggregation tier (``xaynet_tpu_torch.edge``,
    docs/DESIGN.md §11). One section, two roles:

    - on the COORDINATOR, ``enabled = true`` serves the edge endpoints
      (``GET /edge/round`` — round params + round keys for the trusted
      edge tier, ``POST /edge/envelope`` — partial-aggregate intake);
    - on an EDGE process (``python -m xaynet_tpu_torch.edge.runner``),
      ``upstream_url`` names the coordinator and the window knobs bound
      how much an edge batches before shipping one envelope upstream.

    ``token``, when set on both sides, must match (``X-Edge-Token``) —
    edges sit inside the coordinator's trust domain (they decrypt
    participant uploads with the round keys), so the endpoint is never
    served to anonymous callers unless the operator explicitly leaves the
    token empty on a closed network.
    """

    enabled: bool = False  # coordinator: serve /edge/round + /edge/envelope
    token: str = ""  # shared secret for the edge endpoints ("" = open)
    # edge-runner role
    upstream_url: str = ""  # coordinator base URL (required for the runner)
    edge_id: str = ""  # stable identity; "" derives host:port at startup
    max_members: int = 64  # seal the window at this many folded updates
    linger_s: float = 0.5  # seal a non-empty window after this much time
    poll_s: float = 0.25  # upstream round/phase poll cadence

    def validate(self) -> None:
        if self.max_members < 1:
            raise SettingsError("edge.max_members must be >= 1")
        if self.linger_s < 0:
            raise SettingsError("edge.linger_s must be >= 0")
        if self.poll_s <= 0:
            raise SettingsError("edge.poll_s must be > 0")

    def validate_runner(self) -> None:
        """Extra invariants for the edge runner entrypoint."""
        self.validate()
        if not self.upstream_url:
            raise SettingsError("edge.upstream_url is required to run an edge")


@dataclass
class TenancySettings:
    """``[tenancy]`` — multi-tenant coordinator over the paged accumulator
    pool (docs/DESIGN.md §19).

    With ``enabled = true`` one coordinator process runs one full round
    pipeline per id in ``tenants`` — each with its own mask config, model
    length and liveness policy (per-tenant override TOML in
    ``config_dir/<tenant>.toml``, loaded through the normal settings
    loader) — sharing the device, the page pool and the REST listener. The
    FIRST id doubles as the default tenant serving the bare legacy routes;
    every tenant is also reachable under ``/t/<tenant>/...``.

    Pool knobs size the shared arena (pages of ``page_kib`` KiB; 0 caps =
    uncapped, the host arena grows by ``slab_pages``-page slabs);
    ``max_inflight_folds`` bounds fold batches in flight across ALL
    tenants (the scheduler's backpressure); ``ingest_capacity`` and
    ``max_share`` shape the per-tenant admission budget layered on each
    tenant's AdmissionController.
    """

    enabled: bool = False
    tenants: list = field(default_factory=list)  # validated tenant ids
    config_dir: str = ""  # per-tenant override TOMLs: <dir>/<tenant>.toml
    page_kib: int = 1024  # pool page size (multiple of 4 KiB)
    slab_pages: int = 64  # host-arena growth granularity
    host_pages: int = 0  # 0 = uncapped
    device_pages: int = 0  # 0 = uncapped
    max_inflight_folds: int = 8  # cross-tenant fold-batch bound
    ingest_capacity: int = 4096  # process-wide admission budget (messages)
    max_share: float = 0.6  # one tenant's ceiling of that budget
    # -- elastic lifecycle (docs/DESIGN.md §23) -----------------------------
    admin_token: str = ""  # "" disables /admin/tenants entirely
    drain_timeout_s: float = 120.0  # graceful-drain budget before hard kill
    quarantine_failures: int = 3  # consecutive round failures tripping it
    quarantine_reset_s: float = 60.0  # open -> half-open probe delay
    defrag_enabled: bool = True  # between-round host-arena compaction
    defrag_threshold: float = 0.5  # fragmentation tripping a compaction
    weights: str = ""  # "tenant=weight,..." fair-share weights
    tiers: str = ""  # "tenant=tier,..." priority tiers (lower wins)

    def tenant_weights(self) -> dict:
        """Parsed ``weights``: ``{tenant: weight}`` (same string form as
        ``slo.tenant_round_wall_s`` — env-overridable, mini-TOML-safe)."""
        return {
            t: float(v) for t, v in _parse_tenant_pairs(self.weights)
        }

    def tenant_tiers(self) -> dict:
        """Parsed ``tiers``: ``{tenant: tier}`` (lower tier wins slots)."""
        return {t: int(float(v)) for t, v in _parse_tenant_pairs(self.tiers)}

    def validate(self) -> None:
        if self.enabled and not self.tenants:
            raise SettingsError("tenancy.enabled requires at least one tenant id")
        seen = set()
        for tid in self.tenants:
            if not _TENANT_ID_RE.match(str(tid)):
                raise SettingsError(
                    f"tenancy.tenants: invalid tenant id {str(tid)!r}: "
                    "want ^[a-z0-9][a-z0-9_-]{0,31}$"
                )
            if tid in seen:
                raise SettingsError(f"tenancy.tenants: duplicate id {tid!r}")
            seen.add(tid)
        if self.page_kib < 4 or self.page_kib % 4:
            raise SettingsError("tenancy.page_kib must be a multiple of 4 (>= 4)")
        if self.slab_pages < 1:
            raise SettingsError("tenancy.slab_pages must be >= 1")
        if self.host_pages < 0 or self.device_pages < 0:
            raise SettingsError("tenancy.host_pages/device_pages must be >= 0")
        if self.max_inflight_folds < 1:
            raise SettingsError("tenancy.max_inflight_folds must be >= 1")
        if self.ingest_capacity < 1:
            raise SettingsError("tenancy.ingest_capacity must be >= 1")
        if not (0.0 < self.max_share <= 1.0):
            raise SettingsError("tenancy.max_share must be in (0, 1]")
        if self.drain_timeout_s <= 0:
            raise SettingsError("tenancy.drain_timeout_s must be > 0")
        if self.quarantine_failures < 1:
            raise SettingsError("tenancy.quarantine_failures must be >= 1")
        if self.quarantine_reset_s <= 0:
            raise SettingsError("tenancy.quarantine_reset_s must be > 0")
        if not (0.0 < self.defrag_threshold <= 1.0):
            raise SettingsError("tenancy.defrag_threshold must be in (0, 1]")
        try:
            weights = self.tenant_weights()
        except ValueError as e:
            raise SettingsError("tenancy.weights must be 'tenant=weight,...'") from e
        for tenant, weight in weights.items():
            if not tenant or weight <= 0:
                raise SettingsError(
                    "tenancy.weights entries need a tenant id and a positive weight"
                )
        try:
            self.tenant_tiers()
        except ValueError as e:
            raise SettingsError("tenancy.tiers must be 'tenant=tier,...'") from e


def _parse_tenant_pairs(spec: str) -> list:
    """Split a ``tenant=value,tenant=value`` string into pairs (shared by
    the tenancy weight/tier parsers and kept string-typed at the settings
    layer for env-override compatibility)."""
    out = []
    for pair in spec.split(","):
        pair = pair.strip()
        if not pair:
            continue
        tenant, _, value = pair.partition("=")
        out.append((tenant.strip(), value.strip()))
    return out


@dataclass
class SloSettings:
    """``[slo]`` — per-tenant SLO targets and burn-rate alerting
    (``telemetry.slo``, docs/DESIGN.md §20).

    ``round_wall_s`` is the round-wall target every tenant inherits;
    ``tenant_round_wall_s`` overrides it per tenant as a comma-separated
    ``tenant=seconds`` string (strings keep the section env-overridable
    and mini-TOML-parseable, like ``tenancy.tenants``). The three budgets
    are the allowed BAD fractions (slow rounds / degraded rounds / shed
    ingress); burn rate 1.0 means spending exactly that budget. An alert
    needs BOTH the fast and the slow window burning — ``warn`` at
    ``warn_burn``, ``page`` at ``page_burn`` (a page also drops a flight
    bundle, trigger ``slo-page``).
    """

    enabled: bool = True
    round_wall_s: float = 600.0  # default per-round wall target
    tenant_round_wall_s: str = ""  # "tenant=seconds,..." overrides
    round_wall_budget: float = 0.05  # allowed fraction of slow rounds
    degraded_budget: float = 0.1  # allowed fraction of degraded rounds
    shed_budget: float = 0.05  # allowed shed fraction of admissions
    fast_window_s: float = 300.0  # prompt-detection window
    slow_window_s: float = 3600.0  # spike-suppression window
    warn_burn: float = 6.0  # burn rate tripping warn
    page_burn: float = 14.4  # burn rate tripping page (+ flight dump)

    def tenant_targets(self) -> dict:
        """The parsed per-tenant overrides: ``{tenant: seconds}``."""
        out: dict[str, float] = {}
        for pair in self.tenant_round_wall_s.split(","):
            pair = pair.strip()
            if not pair:
                continue
            tenant, _, seconds = pair.partition("=")
            out[tenant.strip()] = float(seconds)
        return out

    def validate(self) -> None:
        if self.round_wall_s <= 0:
            raise SettingsError("slo.round_wall_s must be > 0")
        try:
            targets = self.tenant_targets()
        except ValueError as e:
            raise SettingsError(
                "slo.tenant_round_wall_s must be 'tenant=seconds,...'"
            ) from e
        for tenant, seconds in targets.items():
            if not tenant or seconds <= 0:
                raise SettingsError(
                    "slo.tenant_round_wall_s entries need a tenant id and a "
                    "positive target"
                )
        for name in ("round_wall_budget", "degraded_budget", "shed_budget"):
            if not (0.0 < getattr(self, name) <= 1.0):
                raise SettingsError(f"slo.{name} must be in (0, 1]")
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise SettingsError("slo windows must be > 0")
        if self.fast_window_s > self.slow_window_s:
            raise SettingsError("slo.fast_window_s must be <= slow_window_s")
        if self.warn_burn <= 0 or self.page_burn < self.warn_burn:
            raise SettingsError("slo burn thresholds need 0 < warn_burn <= page_burn")


@dataclass
class OverlapSettings:
    """``[overlap]`` — round-phase overlap & speculation (docs/DESIGN.md §22).

    The PET phase chain is serial by protocol, not by data dependency:
    the sum2 mask derivation needs only the sealed sum dict, the fold
    drain needs only staged updates, and each shard's unmask slice needs
    only that shard's folds. Each flag opts one overlap out independently
    (the ``[liveness]`` idiom — mechanisms are orthogonal); ``enabled =
    false`` forces the fully serial pre-overlap behaviour regardless of
    the per-feature flags. Every overlap is byte-identity preserving: a
    disabled or mis-speculated fast path falls back to the on-demand
    serial path.
    """

    enabled: bool = True
    # the speculative sum2 derive (``ops.speculation``; bench/sim rounds
    # where the sum participant is in-process). This key and ``spec_group``
    # are parsed and validated for parity with the JAX package's config
    # files, but no coordinator path reads them: unlike the keys in
    # ``validate_port``'s ``unread`` list, a non-default value is accepted
    # and changes nothing until a path opens a ``SpeculativeMaskSession``
    # from them
    speculative_derive: bool = True
    # subtract each shard's mask slice as soon as ITS last fold commits
    # at the drain barrier (instead of global drain + a separate pass)
    eager_unmask: bool = True
    # let the update-phase fold drain ride into the sum2 request window
    # instead of blocking the phase transition on it
    sum2_drain: bool = True
    # seeds per speculative derive group (``SpeculativeMaskSession(group=)``)
    spec_group: int = 8

    def feature(self, name: str) -> bool:
        """Effective per-feature switch (master ``enabled`` gates all)."""
        return self.enabled and bool(getattr(self, name))

    def validate(self) -> None:
        if self.spec_group < 1:
            raise SettingsError("overlap.spec_group must be >= 1")


@dataclass
class Settings:
    pet: PetSettings
    mask: MaskSettings = field(default_factory=MaskSettings)
    model: ModelSettings = field(default_factory=ModelSettings)
    api: ApiSettings = field(default_factory=ApiSettings)
    storage: StorageSettings = field(default_factory=StorageSettings)
    restore: RestoreSettings = field(default_factory=RestoreSettings)
    metrics: MetricsSettings = field(default_factory=MetricsSettings)
    log: LoggingSettings = field(default_factory=LoggingSettings)
    aggregation: AggregationSettings = field(default_factory=AggregationSettings)
    ingest: IngestSettings = field(default_factory=IngestSettings)
    resilience: ResilienceSettings = field(default_factory=ResilienceSettings)
    liveness: LivenessSettings = field(default_factory=LivenessSettings)
    edge: EdgeSettings = field(default_factory=EdgeSettings)
    tenancy: TenancySettings = field(default_factory=TenancySettings)
    slo: SloSettings = field(default_factory=SloSettings)
    loadgen: LoadgenSettings = field(default_factory=LoadgenSettings)
    overlap: OverlapSettings = field(default_factory=OverlapSettings)

    def validate(self) -> None:
        self.pet.validate()
        self.api.validate()
        self.tenancy.validate()
        self.slo.validate()
        self.overlap.validate()
        try:
            self.mask.to_config()  # quant level vs data/bound-type ceiling
        except ValueError as e:
            raise SettingsError(f"mask.quant: {e}") from e
        self.ingest.validate()
        self.loadgen.validate()
        self.resilience.validate()
        self.liveness.validate()
        self.edge.validate()
        if self.model.length < 1:
            raise SettingsError("model.length must be >= 1")
        if self.aggregation.batch_size < 1:
            raise SettingsError("aggregation.batch_size must be >= 1")
        if self.aggregation.dispatch_ahead < 1:
            raise SettingsError("aggregation.dispatch_ahead must be >= 1")
        if self.aggregation.staging_buffers < 2:
            raise SettingsError("aggregation.staging_buffers must be >= 2")
        if self.aggregation.kernel not in FOLD_KERNELS:
            raise SettingsError(
                "aggregation.kernel must be one of: " + " | ".join(FOLD_KERNELS)
            )
        if self.aggregation.wire_ingest and not self.aggregation.device:
            raise SettingsError("aggregation.wire_ingest requires aggregation.device = true")
        if self.aggregation.shard_threads < 0:
            raise SettingsError("aggregation.shard_threads must be >= 0 (0 = auto split)")
        if self.metrics.trace not in ("", "on", "failure", "off"):
            raise SettingsError(
                "metrics.trace must be on | failure | off (or omitted to "
                "defer to XAYNET_TRACE)"
            )
        self.validate_port()

    def validate_port(self) -> None:
        """Refuse what the JAX package serves and the port does not have;
        each message names the ROADMAP item that would add it. A
        multi-tenant coordinator loads each tenant's file through the same
        loader, so a per-tenant file is refused for the same keys."""
        if self.aggregation.kernel != "auto":
            raise SettingsError(
                f"aggregation.kernel = {self.aggregation.kernel!r} names a TPU "
                "or host kernel of the JAX package; xaynet_tpu_torch has one "
                "fold per device type (K1 on CUDA, the plain version on the "
                "CPU) and accepts only \"auto\" (ROADMAP Queue 2)"
            )
        unread = (
            ("aggregation", "shard_parallel", "item 10, several GPUs"),
            ("aggregation", "shard_threads", "item 10, several GPUs"),
        )
        for section, key, item in unread:
            value = getattr(self, section)
            default = getattr(type(value)(), key)
            if getattr(value, key) != default:
                raise SettingsError(
                    f"{section}.{key} configures what xaynet_tpu_torch does not "
                    f"have; leave it at {default!r} (ROADMAP Queue 1 {item})"
                )

    @classmethod
    def default(cls) -> "Settings":
        return cls(
            pet=PetSettings(
                sum=PhaseSettings(
                    prob=0.01,
                    count=CountSettings(min=1, max=100),
                    time=TimeSettings(min=0.0, max=600.0),
                ),
                update=PhaseSettings(
                    prob=0.1,
                    count=CountSettings(min=3, max=10000),
                    time=TimeSettings(min=0.0, max=600.0),
                ),
                sum2=Sum2Settings(
                    count=CountSettings(min=1, max=100),
                    time=TimeSettings(min=0.0, max=600.0),
                ),
            )
        )

    @classmethod
    def load(cls, path: Optional[str] = None, env: Optional[dict] = None) -> "Settings":
        """Load from TOML (optional) with ``XAYNET__SECTION__KEY`` env overrides."""
        raw: dict[str, Any] = {}
        if path is not None:
            if tomllib is not None:
                with open(path, "rb") as f:
                    raw = tomllib.load(f)
            else:
                with open(path, "r", encoding="utf-8") as f:
                    raw = _mini_toml(f.read())
        env = dict(os.environ if env is None else env)
        for key, value in env.items():
            if not key.startswith("XAYNET__"):
                continue
            parts = [p.lower() for p in key.split("__")[1:]]
            node = raw
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _coerce(value)
        settings = cls._from_raw(raw)
        settings.validate()
        return settings

    @classmethod
    def _from_raw(cls, raw: dict) -> "Settings":
        base = cls.default()
        pet = raw.get("pet", {})

        def phase(name: str, default: PhaseSettings | Sum2Settings):
            section = pet.get(name, {})
            count = section.get("count", {})
            time_ = section.get("time", {})
            quorum = count.get("quorum", default.count.quorum)
            kwargs = dict(
                count=CountSettings(
                    min=int(count.get("min", default.count.min)),
                    max=int(count.get("max", default.count.max)),
                    quorum=None if quorum is None else int(quorum),
                ),
                time=TimeSettings(
                    min=float(time_.get("min", default.time.min)),
                    max=float(time_.get("max", default.time.max)),
                ),
            )
            if isinstance(default, PhaseSettings):
                return PhaseSettings(prob=float(section.get("prob", default.prob)), **kwargs)
            return Sum2Settings(**kwargs)

        mask_raw = raw.get("mask", {})
        model_raw = raw.get("model", {})
        api_raw = raw.get("api", {})
        storage_raw = raw.get("storage", {})
        restore_raw = raw.get("restore", {})
        metrics_raw = raw.get("metrics", {})
        log_raw = raw.get("log", {})
        agg_raw = raw.get("aggregation", {})
        ingest_raw = raw.get("ingest", {})
        res_raw = raw.get("resilience", {})
        res_base = base.resilience
        live_raw = raw.get("liveness", {})
        live_base = base.liveness
        edge_raw = raw.get("edge", {})
        edge_base = base.edge
        ten_raw = raw.get("tenancy", {})
        ten_base = base.tenancy
        slo_raw = raw.get("slo", {})
        slo_base = base.slo
        lg_raw = raw.get("loadgen", {})
        lg_base = base.loadgen
        ov_raw = raw.get("overlap", {})
        ov_base = base.overlap

        return cls(
            pet=PetSettings(
                sum=phase("sum", base.pet.sum),
                update=phase("update", base.pet.update),
                sum2=phase("sum2", base.pet.sum2),
            ),
            mask=MaskSettings(
                group_type=_enum(GroupType, mask_raw.get("group_type", "prime")),
                data_type=_enum(DataType, mask_raw.get("data_type", "f32")),
                bound_type=_enum(BoundType, mask_raw.get("bound_type", "b0")),
                model_type=_enum(ModelType, mask_raw.get("model_type", "m3")),
                quant=int(mask_raw.get("quant", base.mask.quant)),
            ),
            model=ModelSettings(length=int(model_raw.get("length", base.model.length))),
            api=ApiSettings(
                bind_address=str(api_raw.get("bind_address", base.api.bind_address)),
                tls_certificate=api_raw.get("tls_certificate"),
                tls_key=api_raw.get("tls_key"),
                tls_client_auth=api_raw.get("tls_client_auth"),
            ),
            storage=StorageSettings(
                backend=str(storage_raw.get("backend", base.storage.backend)),
                model_dir=str(storage_raw.get("model_dir", base.storage.model_dir)),
                coordinator=str(storage_raw.get("coordinator", base.storage.coordinator)),
                redis_host=str(storage_raw.get("redis_host", base.storage.redis_host)),
                redis_port=int(storage_raw.get("redis_port", base.storage.redis_port)),
                redis_db=int(storage_raw.get("redis_db", base.storage.redis_db)),
                s3_endpoint=str(storage_raw.get("s3_endpoint", base.storage.s3_endpoint)),
                s3_bucket=str(storage_raw.get("s3_bucket", base.storage.s3_bucket)),
                s3_access_key=str(storage_raw.get("s3_access_key", base.storage.s3_access_key)),
                s3_secret_key=str(storage_raw.get("s3_secret_key", base.storage.s3_secret_key)),
                s3_region=str(storage_raw.get("s3_region", base.storage.s3_region)),
            ),
            restore=RestoreSettings(enable=bool(restore_raw.get("enable", False))),
            metrics=MetricsSettings(
                enable=bool(metrics_raw.get("enable", False)),
                sink=str(metrics_raw.get("sink", base.metrics.sink)),
                path=str(metrics_raw.get("path", base.metrics.path)),
                url=str(metrics_raw.get("url", base.metrics.url)),
                database=str(metrics_raw.get("database", base.metrics.database)),
                round_report_path=str(
                    metrics_raw.get("round_report_path", base.metrics.round_report_path)
                ),
                trace=str(metrics_raw.get("trace", base.metrics.trace)),
                trace_dir=str(metrics_raw.get("trace_dir", base.metrics.trace_dir)),
                flight_dir=str(metrics_raw.get("flight_dir", base.metrics.flight_dir)),
            ),
            log=LoggingSettings(filter=str(log_raw.get("filter", base.log.filter))),
            aggregation=AggregationSettings(
                device=bool(agg_raw.get("device", False)),
                batch_size=int(agg_raw.get("batch_size", base.aggregation.batch_size)),
                kernel=str(agg_raw.get("kernel", base.aggregation.kernel)),
                dispatch_ahead=int(
                    agg_raw.get("dispatch_ahead", base.aggregation.dispatch_ahead)
                ),
                staging_buffers=int(
                    agg_raw.get("staging_buffers", base.aggregation.staging_buffers)
                ),
                wire_ingest=bool(agg_raw.get("wire_ingest", base.aggregation.wire_ingest)),
                shard_parallel=bool(
                    agg_raw.get("shard_parallel", base.aggregation.shard_parallel)
                ),
                shard_threads=int(
                    agg_raw.get("shard_threads", base.aggregation.shard_threads)
                ),
                packed_staging=bool(
                    agg_raw.get("packed_staging", base.aggregation.packed_staging)
                ),
            ),
            ingest=IngestSettings(
                enabled=bool(ingest_raw.get("enabled", base.ingest.enabled)),
                shards=int(ingest_raw.get("shards", base.ingest.shards)),
                queue_bound=int(ingest_raw.get("queue_bound", base.ingest.queue_bound)),
                high_watermark=float(
                    ingest_raw.get("high_watermark", base.ingest.high_watermark)
                ),
                low_watermark=float(
                    ingest_raw.get("low_watermark", base.ingest.low_watermark)
                ),
                max_batch=int(ingest_raw.get("max_batch", base.ingest.max_batch)),
                linger_ms=float(ingest_raw.get("linger_ms", base.ingest.linger_ms)),
                coalesce=bool(ingest_raw.get("coalesce", base.ingest.coalesce)),
                coalesce_max_batch=int(
                    ingest_raw.get("coalesce_max_batch", base.ingest.coalesce_max_batch)
                ),
                coalesce_linger_ms=float(
                    ingest_raw.get("coalesce_linger_ms", base.ingest.coalesce_linger_ms)
                ),
                retry_after_seconds=float(
                    ingest_raw.get("retry_after_seconds", base.ingest.retry_after_seconds)
                ),
                wire_format=str(
                    ingest_raw.get("wire_format", base.ingest.wire_format)
                ),
            ),
            resilience=ResilienceSettings(
                enabled=bool(res_raw.get("enabled", res_base.enabled)),
                retry_max_attempts=int(
                    res_raw.get("retry_max_attempts", res_base.retry_max_attempts)
                ),
                retry_base_ms=float(res_raw.get("retry_base_ms", res_base.retry_base_ms)),
                retry_max_ms=float(res_raw.get("retry_max_ms", res_base.retry_max_ms)),
                retry_deadline_s=float(
                    res_raw.get("retry_deadline_s", res_base.retry_deadline_s)
                ),
                breaker_threshold=int(
                    res_raw.get("breaker_threshold", res_base.breaker_threshold)
                ),
                breaker_reset_s=float(
                    res_raw.get("breaker_reset_s", res_base.breaker_reset_s)
                ),
                breaker_half_open_max=int(
                    res_raw.get("breaker_half_open_max", res_base.breaker_half_open_max)
                ),
                checkpoint_enabled=bool(
                    res_raw.get("checkpoint_enabled", res_base.checkpoint_enabled)
                ),
                checkpoint_every_batches=int(
                    res_raw.get("checkpoint_every_batches", res_base.checkpoint_every_batches)
                ),
                checkpoint_every_s=float(
                    res_raw.get("checkpoint_every_s", res_base.checkpoint_every_s)
                ),
                max_resume_attempts=int(
                    res_raw.get("max_resume_attempts", res_base.max_resume_attempts)
                ),
                fault_plan=str(res_raw.get("fault_plan", res_base.fault_plan)),
            ),
            liveness=LivenessSettings(
                stall_grace_s=float(live_raw.get("stall_grace_s", live_base.stall_grace_s)),
                adaptive=bool(live_raw.get("adaptive", live_base.adaptive)),
                shrink_after=int(live_raw.get("shrink_after", live_base.shrink_after)),
                grow_after=int(live_raw.get("grow_after", live_base.grow_after)),
                shrink_factor=float(live_raw.get("shrink_factor", live_base.shrink_factor)),
                grow_factor=float(live_raw.get("grow_factor", live_base.grow_factor)),
                time_relax_factor=float(
                    live_raw.get("time_relax_factor", live_base.time_relax_factor)
                ),
                time_max_ceil_s=float(
                    live_raw.get("time_max_ceil_s", live_base.time_max_ceil_s)
                ),
                window=int(live_raw.get("window", live_base.window)),
            ),
            edge=EdgeSettings(
                enabled=bool(edge_raw.get("enabled", edge_base.enabled)),
                token=str(edge_raw.get("token", edge_base.token)),
                upstream_url=str(edge_raw.get("upstream_url", edge_base.upstream_url)),
                edge_id=str(edge_raw.get("edge_id", edge_base.edge_id)),
                max_members=int(edge_raw.get("max_members", edge_base.max_members)),
                linger_s=float(edge_raw.get("linger_s", edge_base.linger_s)),
                poll_s=float(edge_raw.get("poll_s", edge_base.poll_s)),
            ),
            tenancy=TenancySettings(
                enabled=bool(ten_raw.get("enabled", ten_base.enabled)),
                # a TOML array, or a comma-separated string (env overrides
                # and the mini-TOML fallback deliver strings)
                tenants=(
                    [t.strip() for t in ten_raw["tenants"].split(",") if t.strip()]
                    if isinstance(ten_raw.get("tenants"), str)
                    else [str(t) for t in ten_raw.get("tenants", ten_base.tenants)]
                ),
                config_dir=str(ten_raw.get("config_dir", ten_base.config_dir)),
                page_kib=int(ten_raw.get("page_kib", ten_base.page_kib)),
                slab_pages=int(ten_raw.get("slab_pages", ten_base.slab_pages)),
                host_pages=int(ten_raw.get("host_pages", ten_base.host_pages)),
                device_pages=int(ten_raw.get("device_pages", ten_base.device_pages)),
                max_inflight_folds=int(
                    ten_raw.get("max_inflight_folds", ten_base.max_inflight_folds)
                ),
                ingest_capacity=int(
                    ten_raw.get("ingest_capacity", ten_base.ingest_capacity)
                ),
                max_share=float(ten_raw.get("max_share", ten_base.max_share)),
                admin_token=str(ten_raw.get("admin_token", ten_base.admin_token)),
                drain_timeout_s=float(
                    ten_raw.get("drain_timeout_s", ten_base.drain_timeout_s)
                ),
                quarantine_failures=int(
                    ten_raw.get("quarantine_failures", ten_base.quarantine_failures)
                ),
                quarantine_reset_s=float(
                    ten_raw.get("quarantine_reset_s", ten_base.quarantine_reset_s)
                ),
                defrag_enabled=bool(
                    ten_raw.get("defrag_enabled", ten_base.defrag_enabled)
                ),
                defrag_threshold=float(
                    ten_raw.get("defrag_threshold", ten_base.defrag_threshold)
                ),
                weights=str(ten_raw.get("weights", ten_base.weights)),
                tiers=str(ten_raw.get("tiers", ten_base.tiers)),
            ),
            slo=SloSettings(
                enabled=bool(slo_raw.get("enabled", slo_base.enabled)),
                round_wall_s=float(slo_raw.get("round_wall_s", slo_base.round_wall_s)),
                tenant_round_wall_s=str(
                    slo_raw.get("tenant_round_wall_s", slo_base.tenant_round_wall_s)
                ),
                round_wall_budget=float(
                    slo_raw.get("round_wall_budget", slo_base.round_wall_budget)
                ),
                degraded_budget=float(
                    slo_raw.get("degraded_budget", slo_base.degraded_budget)
                ),
                shed_budget=float(slo_raw.get("shed_budget", slo_base.shed_budget)),
                fast_window_s=float(
                    slo_raw.get("fast_window_s", slo_base.fast_window_s)
                ),
                slow_window_s=float(
                    slo_raw.get("slow_window_s", slo_base.slow_window_s)
                ),
                warn_burn=float(slo_raw.get("warn_burn", slo_base.warn_burn)),
                page_burn=float(slo_raw.get("page_burn", slo_base.page_burn)),
            ),
            loadgen=LoadgenSettings(
                participants=int(lg_raw.get("participants", lg_base.participants)),
                drivers=int(lg_raw.get("drivers", lg_base.drivers)),
                block_size=int(lg_raw.get("block_size", lg_base.block_size)),
                tenants=str(lg_raw.get("tenants", lg_base.tenants)),
                wire=str(lg_raw.get("wire", lg_base.wire)),
                sum_participants=int(
                    lg_raw.get("sum_participants", lg_base.sum_participants)
                ),
                dropout_rate=float(lg_raw.get("dropout_rate", lg_base.dropout_rate)),
                stragglers=int(lg_raw.get("stragglers", lg_base.stragglers)),
                straggle_delay_ms=float(
                    lg_raw.get("straggle_delay_ms", lg_base.straggle_delay_ms)
                ),
                concurrency=int(lg_raw.get("concurrency", lg_base.concurrency)),
                seed=int(lg_raw.get("seed", lg_base.seed)),
            ),
            overlap=OverlapSettings(
                enabled=bool(ov_raw.get("enabled", ov_base.enabled)),
                speculative_derive=bool(
                    ov_raw.get("speculative_derive", ov_base.speculative_derive)
                ),
                eager_unmask=bool(ov_raw.get("eager_unmask", ov_base.eager_unmask)),
                sum2_drain=bool(ov_raw.get("sum2_drain", ov_base.sum2_drain)),
                spec_group=int(ov_raw.get("spec_group", ov_base.spec_group)),
            ),
        )


def _mini_toml(text: str) -> dict:
    """TOML-subset parser for Python < 3.11 (no ``tomllib``).

    Covers exactly what the coordinator configs use: ``[dotted.section]``
    headers, ``key = value`` with string/bool/int/float scalars, comments
    and blank lines. Anything fancier (arrays, inline tables, multi-line
    strings) raises — better a loud error than silently dropped settings.
    """
    root: dict[str, Any] = {}
    node = root
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith("[") and stripped.endswith("]"):
            header = stripped[1:-1].strip()
            if header.startswith("[") or header.endswith("]"):
                raise SettingsError(
                    f"config line {lineno}: arrays of tables ({stripped!r}) are "
                    "not supported by the tomllib fallback parser"
                )
            node = root
            for part in header.split("."):
                node = node.setdefault(part.strip(), {})
            continue
        key, eq, value = stripped.partition("=")
        if not eq:
            raise SettingsError(f"config line {lineno}: expected 'key = value'")
        value = value.strip()
        # strip a trailing comment (quote-aware for string values)
        if value.startswith('"'):
            end = value.find('"', 1)
            if end < 0:
                raise SettingsError(f"config line {lineno}: unterminated string")
            trailing = value[end + 1 :].split("#", 1)[0].strip()
            if trailing:
                raise SettingsError(
                    f"config line {lineno}: unexpected content after string: {trailing!r}"
                )
            node[key.strip()] = value[1:end]
            continue
        value = value.split("#", 1)[0].strip()
        coerced = _coerce(value)  # same bool/int/float ladder as env overrides
        if isinstance(coerced, str):
            # unquoted non-scalar (array, inline table, bareword): loud error
            raise SettingsError(f"config line {lineno}: unsupported value {value!r}")
        node[key.strip()] = coerced
    return root


def _coerce(value: str):
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def _enum(enum_cls, name):
    if isinstance(name, enum_cls):
        return name
    try:
        if isinstance(name, int):
            return enum_cls(name)
        return enum_cls[str(name).upper()]
    except KeyError as e:
        raise SettingsError(f"invalid {enum_cls.__name__}: {name}") from e
