"""Streaming aggregation: a bounded producer/consumer over the device fold.

Port of the single-worker half of ``xaynet_tpu/parallel/streaming.py``. A
synchronous flush serializes host staging (the byte-plane pack), the
host-to-device copy and the fold, so host and device take turns idling.
Here:

- **staging ring** — host buffers, leased as the traffic needs them from
  the shared page pool (``tenancy.pool``) under the pipeline's tenant,
  page-locked on CUDA so the copy to the device is asynchronous; batch
  N+1 is packed into one, straight from the wire rows, while batch N
  crosses to the device and folds. A batch of ``k`` rows stages through a
  buffer of ``bucket(k)`` rows: ``k`` rounded up to a power of two, capped
  at ``max_batch``, so a short flush (the Update phase's last) does not
  lease and pin a full batch's buffer. Each buffer is one lease. Each
  bucket holds up to ``staging_buffers`` buffers; the buckets of one kind
  (packed or planar) are 1, 2, 4, ... rows and ``max_batch``, so together
  they hold fewer than ``2 * max_batch * staging_buffers`` rows, which
  bounds what one pipeline stages. A buffer goes back to the ring only
  once its batch's fold has completed on the device (a CUDA event
  recorded after the fold); on the CPU the fold reads the ring buffer
  itself and has finished when it returns. ``close()`` releases the
  leases. The pool keeps its slabs page-locked, so the next ring's leases
  land in pinned pages and a process pins each slab once, not once per
  round.
- **dispatch-ahead** — up to ``dispatch_ahead`` batches queue to one fold
  worker thread, which enters the accumulator's own CUDA stream
  (``DeviceAggregator.on_stream``) and launches K1 there, while the
  producer stages ahead.
- **tenant fold-batch slots** — every batch holds one slot of the shared
  ``tenancy.scheduler`` from dispatch until its fold has completed on the
  device, and a caller-thread fold of device rows holds one per chunk, so
  tenants sharing the card interleave their folds fairly and the slots
  bound the folds queued on it.

Fold order is FIFO (one worker) and the fold is an exact modular sum, so
the aggregate is byte-identical to sequential ``add_batch`` calls however
far the pipeline runs ahead.

**Degradation ladder (streaming -> sync -> fail).** The JAX fold returns a
new accumulator, so the JAX pipeline may retry any failed fold. K1 folds
IN PLACE, so here only a failure raised before the fold's launch may be
retried: the fault site ``streaming.fold``, the device allocation and the
host-to-device copy. Such a failure retries the batch once synchronously
and, on success, switches the pipeline to folding on the caller's thread
for the rest of the round (``degraded``): the round completes with the same
aggregate, without overlap. Anything raised by the fold seam or after it
(a launch error, a sticky CUDA error, the copy's completion wait, the
drain barrier) is ``_UnsafeFoldError``: the accumulator may already hold
the batch, so the pipeline is poisoned without a retry. A failed retry
poisons too. Poison is permanent: every later ``submit``/``drain`` raises
:class:`StreamingError` naming the batch and the cause.

**Raw wire batches** (``submit_wire_batch``): v1 element blocks
``uint8[K, n*bpn]`` stage through a ``"wire"`` ring and fold by kernel K6
(``DeviceAggregator.dispatch_staged_bytes``), which leaves out every
member with an element >= the order. Acceptance is deferred: the batch's
device ``ok`` vector waits on its :class:`StreamTicket`, and the next
``drain()`` fetches every pending vector at once, resolves the tickets and
credits ``nb_models``. In the degraded (synchronous) mode a ticket
resolves at submit time.

Rows that device wire ingest already validated on the card
(``DeviceAggregator.validate_wire_updates`` / ``validate_planar_updates``)
are not queued: ``fold_planar_rows_now`` / ``fold_packed_rows_now`` fold
them on the caller's thread, on the accumulator's stream.

**Telemetry.** The pipeline sets the JAX package's registry families under
the same names: ``xaynet_streaming_staging_depth`` (ring buffers owned by
in-flight batches), ``xaynet_streaming_inflight_folds`` (batches queued to
the fold worker), ``xaynet_streaming_overlap_ratio`` (the last drain
window's), ``xaynet_streaming_batches_total{stage}`` (staged, folded,
folded-degraded, failed), ``xaynet_streaming_degraded`` and
``xaynet_streaming_degradations_total``, and
``xaynet_bytes_staged_total{layout}`` (packed or unpacked ring bytes); the
REST ``/healthz`` ``pipeline`` section, the console and the round report
read them. It records the spans ``stream.stage``, ``stream.fold`` and
``stream.drain``. The drain window's legs are also plain attributes
(``last_window``).

One device has no shards, so the JAX package's shard plan, per-shard
workers, per-shard gauges and eager per-shard unmask have no counterpart
here (ROADMAP item 10), nor have the flight dumps.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time
import weakref

import numpy as np
import torch

from ..ops import limbs as host_limbs
from ..ops.fold import MAX_LAZY_BATCH
from ..resilience.faults import maybe_fail
from ..telemetry import tracing as trace
from ..telemetry.registry import get_registry
from ..tenancy.pool import LOCAL_TENANT, PagePool, get_pool
from ..tenancy.scheduler import TenantScheduler, get_scheduler
from .aggregator import BYTES_STAGED, DeviceAggregator

logger = logging.getLogger(__name__)

SPAN_STAGE = trace.declare_span("stream.stage")
SPAN_FOLD = trace.declare_span("stream.fold")
SPAN_DRAIN = trace.declare_span("stream.drain")

_registry = get_registry()
STAGING_DEPTH = _registry.gauge(
    "xaynet_streaming_staging_depth",
    "Staging ring buffers currently owned by in-flight batches.",
)
INFLIGHT_FOLDS = _registry.gauge(
    "xaynet_streaming_inflight_folds",
    "Fold batches submitted to the streaming pipeline and not yet folded.",
)
OVERLAP_RATIO = _registry.gauge(
    "xaynet_streaming_overlap_ratio",
    "Fraction of the shorter pipeline leg (staging vs folding) that ran "
    "concurrently with the other leg during the last drain window "
    "(1 = perfect overlap, 0 = fully serialized).",
)
BATCHES_TOTAL = _registry.counter(
    "xaynet_streaming_batches_total",
    "Streaming pipeline batches, by stage (staged = submitted, "
    "folded = fold completed).",
    ("stage",),
)
DEGRADED = _registry.gauge(
    "xaynet_streaming_degraded",
    "1 while the streaming pipeline has degraded to the synchronous fold "
    "path after a fold failure (resets with the next pipeline).",
)
DEGRADATIONS = _registry.counter(
    "xaynet_streaming_degradations_total",
    "Times a streaming pipeline degraded to the synchronous fold path.",
)

_SHUTDOWN = object()


class StreamingError(RuntimeError):
    """The fold pipeline failed; the aggregate is unusable."""


class StreamTicket:
    """Handle for one submitted wire batch.

    ``accepted`` resolves at the next ``drain()``: the ``bool[K]``
    per-member acceptance vector (in the degraded mode, at submit time)."""

    __slots__ = ("k", "accepted", "_ok")

    def __init__(self, k: int):
        self.k = k
        self.accepted: np.ndarray | None = None
        self._ok: torch.Tensor | None = None  # the device vector, until drain


class _UnsafeFoldError(Exception):
    """A fold failed where the accumulator may already hold the batch (K1
    folds in place): no consistent retry exists, the pipeline must poison.
    ``__cause__`` is the real failure. ``settled`` is True when the batch's
    in-flight count was already handed off (``_credit`` ran), so the poison
    handler must not subtract it again."""

    def __init__(self, settled: bool = False):
        super().__init__()
        self.settled = settled


def _release_ring_leases(pool: PagePool, leases: list) -> None:
    """Module-level so a ring's GC finalizer holds no ring reference."""
    for lease in leases:
        pool.release(lease)


def _ring_migrator(view) -> None:
    """Compaction swap hook for a QUIESCENT ring lease: the pool already
    rewrote ``lease.array`` to the migrated view under its lock, and the
    ring's free queue holds the lease object, not the array, so there is
    no ring state left to fix up. Module-level so a lease never strongly
    references its ring."""


def bucket_rows(k: int, max_rows: int) -> int:
    """The rows of the buffer a batch of ``k`` rows stages through: ``k``
    rounded up to a power of two, at most ``max_rows``."""
    return min(1 << (k - 1).bit_length(), max_rows)


class _StagingRing:
    """Bounded pool of host staging buffers, leased from the page pool as
    the traffic needs them, in buckets by rows.

    ``acquire(k)`` takes a free buffer of ``bucket_rows(k)`` rows, leases
    one more for that bucket while it holds fewer than ``size``, and
    otherwise blocks until an in-flight batch gives one of them back: the
    producer runs at most ``size`` batches of one bucket ahead of the fold
    worker, which is the pipeline's memory bound (the buckets' rows sum to
    less than ``2 * shape[0]``, so the ring holds fewer than ``2 *
    shape[0] * size`` rows). A pipeline whose folds keep up holds one
    buffer per bucket its batches need, not ``size``.

    Each buffer is one lease of the pool under the ring's tenant, zeroed
    by the pool. With ``pin`` (a CUDA device) the lease lands in a
    page-locked slab, so the copy to the device runs asynchronously at the
    bus's rate: the pool locks a slab once, so a lease in a slab an
    earlier ring already locked costs no pinning (``reused``); a slab that
    cannot be locked raises with its size (there is no pageable ring).
    ``nbytes`` is what the ring holds, ``pin_seconds`` what locking slabs
    for its leases took, ``buffer_rows`` the rows of each buffer.

    Free buffers opt into the pool's compaction: while a lease sits in the
    free queue it carries a migrator, so a between-round defrag may slide
    it; ``acquire`` clears the migrator through the pool lock BEFORE
    reading the array, making every in-flight buffer an immovable
    barrier, and ``release`` (called once the batch's fold, and so the
    copy out of the buffer, has completed) registers it again.
    ``close()`` releases the leases; a GC finalizer does the same for
    abandoned pipelines.
    """

    def __init__(self, size: int, shape: tuple, dtype, pin: bool,
                 pool: PagePool | None = None, tenant: str = LOCAL_TENANT):
        self.size = size
        self._shape, self._dtype, self._pin = tuple(shape), np.dtype(dtype), pin
        self._pool = pool if pool is not None else get_pool()
        self._tenant = tenant
        self._free: dict[int, queue_mod.Queue] = {}  # rows -> free leases  # guarded-by: _lock
        self._inflight: dict[int, object] = {}  # id(buf) -> lease  # guarded-by: _lock
        self._lock = threading.Lock()
        self._leases: list = []  # guarded-by: _lock
        self.buffer_rows: list[int] = []  # guarded-by: _lock
        # abandoned pipelines give their pages back when the ring is
        # collected: by then nothing can alias them
        weakref.finalize(self, _release_ring_leases, self._pool, self._leases)
        self.nbytes = 0
        self.pin_seconds = 0.0
        self.reused = 0

    def _grow(self, rows: int):
        """One more lease of ``rows`` rows, or None when that bucket holds
        ``size``. The lease is in flight from here (no migrator)."""
        with self._lock:
            if self.buffer_rows.count(rows) >= self.size:
                return None
            shape = (rows, *self._shape[1:])
            try:
                lease = self._pool.lease_host(self._tenant, shape, self._dtype, pinned=self._pin)
            except RuntimeError as e:
                raise RuntimeError(
                    f"cannot lease a pinned staging buffer of shape {shape} (the ring "
                    f"holds up to {self.size} per bucket of rows, at most "
                    f"{self._shape[0]} rows, {self.nbytes} bytes held so far); lower "
                    "staging_buffers or the batch size"
                ) from e
            self._leases.append(lease)
            self.buffer_rows.append(rows)
            self.nbytes += lease.array.nbytes
            self.pin_seconds += lease.pin_seconds
            if self._pin and lease.pin_seconds == 0.0:
                self.reused += 1
            return lease

    def close(self) -> None:
        """Release the ring's leases (idempotent; none may still be in
        flight: the pipeline drains and waits for its folds before it
        closes)."""
        _release_ring_leases(self._pool, self._leases)

    def _free_of(self, rows: int) -> queue_mod.Queue:
        with self._lock:
            return self._free.setdefault(rows, queue_mod.Queue())

    def acquire(self, k: int) -> np.ndarray:
        """A buffer of ``bucket_rows(k)`` rows for a batch of ``k``."""
        rows = bucket_rows(k, self._shape[0])
        free = self._free_of(rows)
        try:
            lease = free.get_nowait()
        except queue_mod.Empty:
            lease = self._grow(rows)
            if lease is None:
                lease = free.get()
        # pin first, read second: set_migrator takes the pool lock, so a
        # compaction mid-flight either finished (lease.array is the new
        # view) or will now skip this lease entirely
        self._pool.set_migrator(lease, None)
        buf = lease.array
        with self._lock:
            self._inflight[id(buf)] = lease
        STAGING_DEPTH.inc()
        return buf

    def release(self, buf: np.ndarray) -> None:
        with self._lock:
            lease = self._inflight.pop(id(buf), None)
        if lease is None:
            return
        STAGING_DEPTH.dec()
        self._pool.set_migrator(lease, _ring_migrator)
        self._free_of(len(buf)).put(lease)

    @property
    def in_use(self) -> int:
        """Buffers currently owned by in-flight batches."""
        with self._lock:
            return len(self._inflight)

    @property
    def allocated(self) -> int:
        """Buffers the ring holds (at most ``size`` per bucket of rows)."""
        with self._lock:
            return len(self._leases)


def _worker_main(ref: "weakref.ref[StreamingAggregator]", q: queue_mod.Queue) -> None:
    """Fold worker loop. Holds no strong reference to the pipeline between
    items, so an abandoned pipeline is collected normally and its
    ``weakref.finalize`` wakes this thread with the shutdown sentinel."""
    while True:
        item = q.get()
        try:
            if item is _SHUTDOWN:
                return
            self = ref()
            if self is None:
                return
            self._process(item)
            del self
        finally:
            q.task_done()


class StreamingAggregator:
    """Bounded streaming front end over a :class:`DeviceAggregator`.

    One fold worker consumes staged batches FIFO; the caller's thread only
    stages. ``submit_batch`` may block — on the staging ring when the
    producer is ``staging_buffers`` batches ahead, on the dispatch queue
    when it is ``dispatch_ahead`` folds ahead — which is the pipeline's
    backpressure. ``drain()`` waits for every in-flight fold, including the
    device's.

    Not thread-safe for concurrent producers: submits come from one thread
    at a time. ``close()`` may come from any thread, a submit in progress
    on another one included.

    ``tenant`` labels the pipeline's page leases and scheduler slots (a
    coordinator's rounds pass theirs; the default, ``LOCAL_TENANT``, is no
    coordinator's); ``pool`` and ``scheduler`` default to the process-wide
    ones, which every tenant and the single-tenant path share.
    """

    def __init__(
        self,
        agg: DeviceAggregator,
        staging_buffers: int = 3,
        dispatch_ahead: int = 2,
        max_batch: int = 64,
        packed: bool | None = None,
        tenant: str = LOCAL_TENANT,
        pool: PagePool | None = None,
        scheduler: TenantScheduler | None = None,
    ):
        if staging_buffers < 2:
            raise ValueError("staging_buffers must be >= 2 (no overlap below that)")
        if dispatch_ahead < 1:
            raise ValueError("dispatch_ahead must be >= 1")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.agg = agg
        self.staging_buffers = staging_buffers
        self.dispatch_ahead = dispatch_ahead
        self.max_batch = min(max_batch, MAX_LAZY_BATCH)
        # packed staging (on wherever it shrinks anything): the ring holds
        # byte-planar uint8[K, bpn, n] planes, bpn/(4L) of the planar bytes,
        # and K1's packed variant assembles the limbs inside the fold
        self._packed = (
            agg.packed_staging_usable() if packed is None
            else bool(packed) and agg.packed_staging_usable()
        )
        # multi-tenant seam: the tenant labels this pipeline's page leases
        # and scheduler slots; the shared pool backs the staging rings; the
        # scheduler interleaves this tenant's fold batches with other
        # tenants' on the one device
        self.tenant = tenant
        self._pool = pool if pool is not None else get_pool()
        self._sched = scheduler if scheduler is not None else get_scheduler()
        self._sched_owner = self._sched.new_owner()
        # abandoned pipelines give their slots back at collection time
        weakref.finalize(self, self._sched.release_owner, self._sched_owner)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=dispatch_ahead)
        self._rings: dict[str, _StagingRing] = {}  # lazy: planar / packed / wire  # guarded-by: _lock
        self._pending: list[StreamTicket] = []  # wire tickets awaiting drain  # guarded-by: _lock
        self._in_flight_models = 0  # submitted, not yet folded  # guarded-by: _lock
        self._error: BaseException | None = None  # guarded-by: _lock
        self._poison_seq: int | None = None  # poisoning batch index  # guarded-by: _lock
        self._degraded = False  # sync path for the rest of the round  # guarded-by: _lock
        self._batch_seq = 0  # submit-order index: producer-thread confined
        self._worker: threading.Thread | None = None
        # a producer holds _produce_lock from its closed check to its
        # dispatch, and close() takes it to mark the pipeline closed: once
        # close() has had it, no producer touches a ring again
        self._produce_lock = threading.Lock()
        self._closed = False  # guarded-by: _produce_lock
        self._shut = threading.Event()  # set when close() has finished
        self._lock = threading.Lock()
        # the drain window's legs: per batch (seq, start, end) on the
        # monotonic clock; stage on the producer, fold on the worker
        self._stage_log: list[tuple] = []
        self._fold_log: list[tuple] = []  # guarded-by: _lock
        self._window_start: float | None = None
        self.last_window: dict | None = None
        # a fresh pipeline is never degraded: a degraded one abandoned on a
        # phase failure must not leave the gauge at 1 for later rounds
        DEGRADED.set(0)

    # -- lifecycle ---------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=_worker_main,
                args=(weakref.ref(self), self._queue),
                name="xn-stream-fold",
                daemon=True,
            )
            self._worker.start()
            # wake the worker if this pipeline is dropped without close()
            weakref.finalize(self, self._queue.put, _SHUTDOWN)

    def close(self) -> None:
        """Drain, stop the fold worker, release the ring's page leases and
        return any scheduler slot still held. Safe from any thread: it
        waits for a submit in progress on another thread (a flush that a
        cancelled round left running), after which every submit raises,
        and returns once every queued fold, and so every copy out of a
        ring buffer, has completed. Idempotent: a second caller waits for
        the first to finish. A poisoned pipeline still shuts down (its
        error has surfaced, or will, through ``drain``/``submit``)."""
        with self._produce_lock:
            first, self._closed = not self._closed, True
        if not first:
            self._shut.wait()
            return
        try:
            self._shut_down()
        finally:
            self._shut.set()

    def _shut_down(self) -> None:
        try:
            self.drain()
        except StreamingError:
            logger.warning("closing poisoned streaming pipeline")
            # a poisoned drain raised before its barrier: wait out the fold
            # stream before a copy out of a ring buffer could still be read
            if self.agg.stream is not None:
                try:
                    self.agg.stream.synchronize()
                except Exception:  # noqa: BLE001 - surfaced through drain already
                    logger.warning("fold stream failed while closing", exc_info=True)
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(_SHUTDOWN)
            self._worker.join(timeout=60.0)
        with self._lock:
            rings = list(self._rings.values())
            self._rings.clear()
        for ring in rings:
            ring.close()
        self._sched.release_owner(self._sched_owner)
        if self.degraded:
            DEGRADED.set(0)

    # -- producer side -----------------------------------------------------

    @property
    def in_flight_models(self) -> int:
        """Submitted, not yet folded update count."""
        with self._lock:
            return self._in_flight_models

    def counted_models(self) -> int:
        """``in_flight + agg.nb_models`` read atomically with the worker's
        per-batch handoff, so a capacity check never sees a batch twice or
        not at all."""
        with self._lock:
            return self._in_flight_models + self.agg.nb_models

    @property
    def degraded(self) -> bool:
        """True once a fold failure switched the pipeline to the
        synchronous fold path (the round still completes)."""
        with self._lock:
            return self._degraded

    def _ring(self, kind: str) -> _StagingRing:
        with self._lock:
            ring = self._rings.get(kind)
            if ring is None:
                agg = self.agg
                if kind == "planar":
                    shape, dtype = (self.max_batch, agg.n_limbs, agg.padded_length), np.uint32
                elif kind == "wire":  # raw v1 element blocks
                    shape, dtype = (self.max_batch, agg.padded_length * agg.packed_width), np.uint8
                else:  # byte-planar packed planes: bpn/(4L) of the planar ring
                    shape, dtype = (self.max_batch, agg.packed_width, agg.padded_length), np.uint8
                # one ring per kind, made at its first submit; its buffers
                # (of max_batch rows or fewer) are leased as the traffic
                # needs them
                ring = self._rings[kind] = _StagingRing(
                    self.staging_buffers, shape, dtype, pin=agg.device.type == "cuda",
                    pool=self._pool, tenant=self.tenant,
                )
            return ring

    def _poison_error(self) -> StreamingError:
        """The sticky error, naming the poisoning batch and its cause."""
        with self._lock:
            cause, seq = self._error, self._poison_seq
        where = f"batch {seq}" if seq is not None else "the drain barrier"
        return StreamingError(
            f"streaming pipeline poisoned at {where}: {type(cause).__name__}: {cause}"
        )

    def _poisoned(self) -> BaseException | None:
        with self._lock:
            return self._error

    def _poison(self, cause: BaseException, seq: int | None, k: int, settled: bool) -> None:
        """Record the sticky error; the batch leaves flight unless its count
        was already handed off."""
        with self._lock:
            self._error = cause
            self._poison_seq = seq
            if not settled:
                self._in_flight_models -= k

    def _check(self, k: int) -> None:
        if self._closed:
            raise StreamingError("pipeline is closed")
        err = self._poisoned()
        if err is not None:
            raise self._poison_error() from err
        if k > self.max_batch:
            raise ValueError(f"batch of {k} exceeds max_batch={self.max_batch}")
        if self._window_start is None:
            self._window_start = time.monotonic()

    # -- tenant fold-batch slots ------------------------------------------
    #
    # Every batch holds ONE scheduler slot from dispatch until its fold has
    # completed on the device (the worker's event wait, or the degraded
    # path's finally). The slot is the cross-tenant interleave point: the
    # scheduler grants it fairly across tenants and bounds the device-wide
    # in-flight total, which is the multi-tenant backpressure.

    def _slot_acquire(self) -> None:
        self._sched.acquire(self.tenant, self._sched_owner)

    def _slot_release(self) -> None:
        self._sched.release(self._sched_owner)

    def _dispatch(self, item: tuple) -> None:
        """Queue to the fold worker, or, once degraded, fold synchronously
        on the caller's thread (same math, no overlap)."""
        buf, payload, kind, k, seq, ticket = item
        self._slot_acquire()  # released when the fold settles (_process)
        with self._lock:
            self._in_flight_models += k
            degraded = self._degraded
        BATCHES_TOTAL.labels(stage="staged").inc()
        if not degraded:
            self._ensure_worker()
            INFLIGHT_FOLDS.inc()
            self._queue.put(item)
            return
        t0 = time.monotonic()
        try:
            # batches queued before the degradation must finish before a
            # caller-thread fold touches agg.acc
            self._queue.join()
            err = self._poisoned()
            if err is not None:
                raise self._poison_error() from err
            self._fold_payload(payload, kind, k, ticket, defer=False)
        except StreamingError:
            with self._lock:  # already poisoned: this batch just leaves flight
                self._in_flight_models -= k
            BATCHES_TOTAL.labels(stage="failed").inc()
            raise
        except Exception as e:
            unsafe = isinstance(e, _UnsafeFoldError)
            cause = (e.__cause__ or e) if unsafe else e
            self._poison(cause, seq, k, settled=unsafe and e.settled)
            BATCHES_TOTAL.labels(stage="failed").inc()
            raise self._poison_error() from cause
        finally:
            self._slot_release()
            self._ring(kind).release(buf)
            with self._lock:
                self._fold_log.append((seq, t0, time.monotonic()))
        BATCHES_TOTAL.labels(stage="folded").inc()

    def submit_batch(self, rows) -> None:
        """Stage and stream-fold ``K`` wire-layout updates (pre-validated:
        every member counts), given as a ``uint32[K, model_len, L]`` stack
        or as a sequence of ``uint32[model_len, L]`` rows. Each row is
        packed straight into a ring buffer (byte planes, or the planar
        transpose), so the caller may reuse its arrays once this returns."""
        k = len(rows)
        if k == 0:
            raise ValueError("empty batch")
        want = (self.agg.model_length, self.agg.n_limbs)
        for row in rows:
            if np.shape(row) != want:
                raise ValueError(f"expected wire rows uint32{list(want)}, got {np.shape(row)}")
        with self._produce_lock:
            self._check(k)
            kind = "packed" if self._packed else "planar"
            t0 = time.monotonic()
            buf = self._ring(kind).acquire(k)
            view = buf[:k]
            for i, row in enumerate(rows):
                if self._packed:
                    # the first bpn wire bytes of each element, straight into the ring
                    host_limbs.pack_wire(row, self.agg.packed_width, out=view[i])
                else:
                    view[i] = np.asarray(row, dtype=np.uint32).T
            BYTES_STAGED.labels(layout="packed" if self._packed else "unpacked").inc(view.nbytes)
            self._staged_dispatch(buf, view, kind, k, t0, None)

    def _staged_dispatch(self, buf, view, kind: str, k: int, t0: float, ticket) -> None:
        """Log the batch's staging leg (producer side) and dispatch it."""
        self._batch_seq += 1
        t1 = time.monotonic()
        self._stage_log.append((self._batch_seq, t0, t1))
        trace.get_tracer().record_span(SPAN_STAGE, start=t0, duration=t1 - t0,
                                       batch=self._batch_seq, kind=kind, k=k)  # fmt: skip
        self._dispatch((buf, view, kind, k, self._batch_seq, ticket))

    def submit_wire_batch(self, raw) -> StreamTicket:
        """Stage and stream-fold RAW v1 wire element blocks ``uint8[K,
        model_len * bpn]`` through K6. Acceptance is deferred: the
        per-member ``bool[K]`` lands on the returned ticket at the next
        ``drain()`` (the fold leaves the invalid members out either way).
        The rows are copied into a ring buffer, so the caller may reuse
        ``raw`` once this returns."""
        raw = self.agg._check_raw(raw)
        k = raw.shape[0]
        if k == 0:
            raise ValueError("empty batch")
        with self._produce_lock:
            self._check(k)
            t0 = time.monotonic()
            buf = self._ring("wire").acquire(k)
            view = buf[:k]
            view[:] = raw
            BYTES_STAGED.labels(layout="wire").inc(view.nbytes)
            ticket = StreamTicket(k)
            self._staged_dispatch(buf, view, "wire", k, t0, ticket)
        return ticket

    def fold_planar_rows_now(self, rows: list) -> None:
        """Fold device-resident, validity-checked planar ``uint32[L, n]``
        rows (v1 wire ingest) on the CALLER's thread, in chunks of 8.

        Not queued: the rows already occupy device memory, so parking them
        behind ``dispatch_ahead`` would hold several batches on the card at
        once. Queued work finishes first (``agg.acc`` has one mutator at a
        time); each chunk is stacked and folded by K1 on the accumulator's
        stream, after the caller's stream, and the references to it are
        dropped, so the card holds the staged rows plus one chunk's copy.
        Each chunk holds a scheduler slot until its fold has completed on
        the device, so this fast path cannot starve other tenants."""
        self._fold_rows_now(rows, packed=False)

    def fold_packed_rows_now(self, rows: list) -> None:
        """Fold device-resident, validity-checked PACKED byte-planar
        ``uint8[bpn, n]`` rows (v2 wire ingest) on the CALLER's thread
        through K1's packed variant: same rationale and accounting as
        :meth:`fold_planar_rows_now`, and no uint32 planar ever exists."""
        self._fold_rows_now(rows, packed=True)

    def _fold_rows_now(self, rows: list, packed: bool) -> None:
        if not rows:
            return
        with self._produce_lock:
            if self._closed:
                raise StreamingError("pipeline is closed")
            self._fold_rows_locked(rows, packed)

    def _fold_rows_locked(self, rows: list, packed: bool) -> None:
        self._queue.join()
        err = self._poisoned()
        if err is not None:
            raise self._poison_error() from err
        agg = self.agg
        fold = agg._packed_fold_fn if packed else agg._fold_fn
        rows = list(rows)
        while rows:
            piece, rows = rows[:8], rows[8:]
            self._slot_acquire()
            try:
                with agg.on_stream(*piece):
                    staged = torch.stack(piece)
                    try:
                        fold(agg.acc, staged)
                        if agg.stream is not None:
                            folded = torch.cuda.Event()
                            folded.record()
                            folded.synchronize()
                    except Exception as e:
                        # K1 folds in place: acc may hold part of the chunk
                        self._poison(e, None, 0, settled=True)
                        raise self._poison_error() from e
                    del staged
            finally:
                self._slot_release()
            with self._lock:
                agg.nb_models += len(piece)

    # -- fold worker -------------------------------------------------------

    def _upload(self, payload: np.ndarray) -> torch.Tensor:
        """The staged ring view as a tensor on the device: an asynchronous
        copy out of the pinned buffer on the current (fold) stream; on the
        CPU the fold reads the ring view itself."""
        u32 = payload.dtype == np.uint32
        t = torch.from_numpy(payload.view(np.int32) if u32 else payload)
        if self.agg.device.type == "cuda":
            t = t.to(self.agg.device, non_blocking=True)
        return t.view(torch.uint32) if u32 else t

    def _credit(self, staged: torch.Tensor, k: int, packed: bool) -> None:
        """Fold a staged batch and hand its count over atomically: the
        ``nb_models`` credit and the in-flight drop happen under one lock, so
        ``counted_models()`` never sees the batch twice or not at all. The
        fold is in place: whatever the seam raises may leave the batch
        (partly) folded, so it is never retried."""
        agg = self.agg
        fold = agg._packed_fold_fn if packed else agg._fold_fn
        try:
            fold(agg.acc, staged)
        except Exception as e:
            raise _UnsafeFoldError() from e
        with self._lock:
            agg.nb_models += k
            self._in_flight_models -= k

    def _fold_wire(self, staged: torch.Tensor, k: int, ticket: StreamTicket,
                   defer: bool) -> None:
        """K6 over a staged raw batch. ``defer`` (the worker) leaves the
        acceptance vector on the device for the drain's one fetch, and the
        ticket's count with it; otherwise (the degraded path) the vector is
        fetched now, the ticket resolved and the accepted members
        credited."""
        agg = self.agg
        try:
            ok = agg._wire_fold_fn(agg.acc, staged)
        except Exception as e:
            raise _UnsafeFoldError() from e
        # -- acc now holds this batch: no retry beyond this line --
        if defer:
            ticket._ok = ok
            with self._lock:
                self._pending.append(ticket)  # the drain owns its count now
            return
        try:
            ok_host = ok.cpu().numpy()  # the acceptance fetch, a fold barrier
        except Exception as e:
            raise _UnsafeFoldError() from e
        ticket.accepted = ok_host
        with self._lock:
            agg.nb_models += int(ok_host.sum())
            self._in_flight_models -= k

    def _fold_payload(self, payload: np.ndarray, kind: str, k: int,
                      ticket: StreamTicket | None = None, defer: bool = True) -> None:
        """Fold one staged batch out of its ring view, on the fold stream.
        Returns once the fold has completed on the device (or, if it did
        not launch, once the copy out of the ring buffer has), so the
        buffer may be reused and the batch's scheduler slot returned: a
        slot released at the launch would bound nothing on the card. A
        wire batch defers its acceptance to the drain when ``defer``."""
        agg = self.agg
        with agg.on_stream():
            # retry-safe up to here: the allocation and the copy's enqueue
            staged = self._upload(payload)
            copied = None
            if agg.stream is not None:
                copied = torch.cuda.Event()
                copied.record()
            settled = False
            try:
                if kind == "wire":
                    self._fold_wire(staged, k, ticket, defer)
                else:
                    self._credit(staged, k, packed=kind == "packed")
                settled = True
            finally:
                # freed into the fold stream's pool: reused only in its order
                del staged
                if copied is not None:
                    done = copied
                    if settled:  # behind the fold: the copy and the fold ran
                        done = torch.cuda.Event()
                        done.record()
                    try:
                        done.synchronize()
                    except Exception as e:
                        raise _UnsafeFoldError(settled=settled) from e

    def _degrade_and_retry(self, payload, kind: str, k: int, seq: int, ticket,
                           first: Exception) -> str:
        """First fold failure before the launch: switch the pipeline to the
        synchronous path and retry the batch once; a second failure poisons
        permanently. Returns the batch's outcome label."""
        logger.warning(
            "streaming fold failed at batch %d (%s: %s); retrying on the "
            "synchronous path and degrading the pipeline",
            seq, type(first).__name__, first,
        )  # fmt: skip
        with self._lock:
            self._degraded = True
        DEGRADED.set(1)
        DEGRADATIONS.inc()
        try:
            self._fold_payload(payload, kind, k, ticket, defer=False)
            return "folded-degraded"
        except Exception as second:
            # the batch is lost: the accumulator matches no consistent
            # update set any more
            unsafe = isinstance(second, _UnsafeFoldError)
            cause = (second.__cause__ or second) if unsafe else second
            cause.__context__ = first
            self._poison(cause, seq, k, settled=unsafe and second.settled)
            logger.exception("streaming fold batch %d lost; pipeline poisoned", seq)
            return "failed"

    def _process(self, item: tuple) -> None:
        """Worker-side fold with the degradation ladder: streaming fold ->
        one synchronous retry (pre-launch failures only) -> sticky poison."""
        buf, payload, kind, k, seq, ticket = item
        t0 = time.monotonic()
        outcome = "folded"
        with trace.get_tracer().span(SPAN_FOLD, batch=seq, kind=kind, k=k) as fold_span:
            try:
                maybe_fail("streaming.fold")
                self._fold_payload(payload, kind, k, ticket)
            except _UnsafeFoldError as e:
                # acc may already hold the batch: retrying would fold it twice
                self._poison(e.__cause__ or e, seq, k, settled=e.settled)
                outcome = "failed"
                logger.exception("streaming fold batch %d failed at or after launch; "
                                 "pipeline poisoned", seq)
            except Exception as first:
                outcome = self._degrade_and_retry(payload, kind, k, seq, ticket, first)
            finally:
                self._slot_release()
                self._ring(kind).release(buf)
                with self._lock:
                    self._fold_log.append((seq, t0, time.monotonic()))
                INFLIGHT_FOLDS.dec()
                # a failed fold is not folded: staged against folded shows the loss
                BATCHES_TOTAL.labels(stage=outcome).inc()
                fold_span.set(outcome=outcome)

    # -- drain -------------------------------------------------------------

    def drain(self) -> int:
        """Wait for every in-flight fold: the worker's queue, then the fold
        stream (a true completion barrier: the worker waits only for its
        copies, so the last folds may still run on the device, and their
        errors surface here); then the ONE deferred acceptance fetch:
        every pending wire ticket resolves and its accepted members are
        credited to ``nb_models``. Returns the members accepted from
        deferred wire batches in this window. A poisoned pipeline raises
        here every time, so no aggregate with lost updates escapes as a
        round result."""
        with trace.get_tracer().span(SPAN_DRAIN):
            return self._drain()

    def _drop_pending(self) -> list:
        """Discard the deferred tickets (once): their counts leave flight
        and they never resolve."""
        with self._lock:
            stale, self._pending = self._pending, []
            self._in_flight_models -= sum(t.k for t in stale)
        for ticket in stale:
            ticket._ok = None
        return stale

    def _drain(self) -> int:
        self._queue.join()
        err = self._poisoned()
        if err is not None:
            self._drop_pending()
            raise self._poison_error() from err
        with self._lock:
            pending = list(self._pending)
        accepted = 0
        try:
            if self.agg.stream is not None:
                self.agg.stream.synchronize()
            oks = [t._ok.cpu().numpy() for t in pending]
        except Exception as e:
            # a fold failed on the device: acc may hold part of it
            with self._lock:
                if self._error is None:
                    self._error = e
            self._drop_pending()
            raise self._poison_error() from e
        for ticket, ok_host in zip(pending, oks):
            ticket._ok = None
            ticket.accepted = ok_host
            accepted += int(ok_host.sum())
        if pending:
            # the one deferred credit: the accepted count lands and the
            # in-flight count drops in one locked step
            with self._lock:
                self._pending = self._pending[len(pending):]
                self.agg.nb_models += accepted
                self._in_flight_models -= sum(t.k for t in pending)
        self._publish_overlap()
        return accepted

    def _publish_overlap(self) -> None:
        """Close the drain window: ``last_window`` holds its wall seconds,
        each batch's stage and fold (start, end) on the monotonic clock,
        and the overlap ratio, the share of the shorter leg (staging or
        folding, summed over the window) that ran while the other did: 1
        is perfect overlap, 0 fully serialized (or a window whose wall the
        producer spent on other work)."""
        if self._window_start is None:
            return
        wall = max(time.monotonic() - self._window_start, 1e-9)
        with self._lock:
            stage, self._stage_log = self._stage_log, []
            fold, self._fold_log = self._fold_log, []
        stage_s = sum(e - s for _, s, e in stage)
        fold_s = sum(e - s for _, s, e in fold)
        shorter = min(stage_s, fold_s)
        ratio = max(0.0, min(1.0, (stage_s + fold_s - wall) / shorter)) if shorter > 0 else None
        if ratio is not None:
            OVERLAP_RATIO.set(ratio)
        self.last_window = {
            "start": self._window_start, "wall_seconds": wall,
            "stage_seconds": stage_s, "fold_seconds": fold_s, "overlap_ratio": ratio,
            "stage": stage, "fold": fold,
        }  # fmt: skip
        self._window_start = None
