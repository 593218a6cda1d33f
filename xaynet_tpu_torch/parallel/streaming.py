"""Streaming aggregation: a bounded producer/consumer over the device fold.

Port of the single-worker half of ``xaynet_tpu/parallel/streaming.py``. A
synchronous flush serializes host staging (the byte-plane pack), the
host-to-device copy and the fold, so host and device take turns idling.
Here:

- **staging ring** — host buffers, allocated as the traffic needs them
  and page-locked on CUDA so the copy to the device is asynchronous; batch
  N+1 is packed into one, straight from the wire rows, while batch N
  crosses to the device and folds. A batch of ``k`` rows stages through a
  buffer of ``bucket(k)`` rows: ``k`` rounded up to a power of two, capped
  at ``max_batch``, so a short flush (the Update phase's last) does not
  allocate and pin a full batch's buffer. Each bucket holds up to
  ``staging_buffers`` buffers; the buckets of one kind (packed or planar)
  are 1, 2, 4, ... rows and ``max_batch``, so together they hold fewer
  than ``2 * max_batch * staging_buffers`` rows, which bounds what one
  pipeline stages (and pins). A buffer goes back to the ring only once the
  copy out of it has completed (a CUDA event recorded after the copy); on
  the CPU the fold reads the ring buffer itself and has finished when it
  returns. Page-locked buffers outlive their ring: a closed ring hands
  them to a process-wide pool keyed by shape, and the next ring takes them
  from there, so a process pins each buffer once, not once per round.
- **dispatch-ahead** — up to ``dispatch_ahead`` batches queue to one fold
  worker thread, which enters the accumulator's own CUDA stream
  (``DeviceAggregator.on_stream``) and launches K1 there, while the
  producer stages ahead.

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

Rows that device wire ingest already validated on the card
(``DeviceAggregator.validate_wire_updates`` / ``validate_planar_updates``)
are not queued: ``fold_planar_rows_now`` / ``fold_packed_rows_now`` fold
them on the caller's thread, on the accumulator's stream.

One device has no shards, so the JAX package's shard plan, per-shard
workers and eager per-shard unmask have no counterpart here. Raw wire
batches with deferred acceptance (``submit_wire_batch``) are not ported
yet; the JAX package's registry gauges, spans, flight dumps, tenant page
pool and scheduler slots are not part of the port: stage and fold seconds
and the overlap ratio of the last drain window are plain attributes
(``last_window``).
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
from .aggregator import DeviceAggregator

logger = logging.getLogger(__name__)

_SHUTDOWN = object()
_PAGE = 4096

# Page-locked staging buffers free for the next ring, by (shape, dtype).
# Pinning runs at about 1.4 GB/s on the host (PERF.md §5), so buffers stay
# pinned for the life of the process and every later round reuses them.
_PINNED_FREE: dict[tuple, list[np.ndarray]] = {}  # guarded-by: _PINNED_LOCK
_PINNED_LOCK = threading.Lock()


class StreamingError(RuntimeError):
    """The fold pipeline failed; the aggregate is unusable."""


class _UnsafeFoldError(Exception):
    """A fold failed where the accumulator may already hold the batch (K1
    folds in place): no consistent retry exists, the pipeline must poison.
    ``__cause__`` is the real failure. ``settled`` is True when the batch's
    in-flight count was already handed off (``_credit`` ran), so the poison
    handler must not subtract it again."""

    def __init__(self, settled: bool = False):
        super().__init__()
        self.settled = settled


def _page_aligned_empty(shape: tuple, dtype) -> np.ndarray:
    """``np.empty`` whose data starts and ends on page boundaries (what
    ``cudaHostRegister`` page-locks)."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    raw = np.empty(nbytes + 2 * _PAGE, dtype=np.uint8)
    off = (-raw.ctypes.data) % _PAGE
    return raw[off : off + nbytes].view(dtype).reshape(shape)


def _pool_key(shape: tuple, dtype) -> tuple:
    return tuple(shape), np.dtype(dtype).str


def _give_back_pinned(bufs: list) -> None:
    """Hand a ring's pinned buffers to the process-wide pool, each under its
    own shape. Module-level so a ring's finalizer holds no reference to the
    ring."""
    with _PINNED_LOCK:
        for buf in bufs:
            _PINNED_FREE.setdefault(_pool_key(buf.shape, buf.dtype), []).append(buf)


def bucket_rows(k: int, max_rows: int) -> int:
    """The rows of the buffer a batch of ``k`` rows stages through: ``k``
    rounded up to a power of two, at most ``max_rows``."""
    return min(1 << (k - 1).bit_length(), max_rows)


class _StagingRing:
    """Bounded pool of host staging buffers, allocated as the traffic needs
    them, in buckets by rows.

    ``acquire(k)`` takes a free buffer of ``bucket_rows(k)`` rows, adds one
    more to that bucket while it holds fewer than ``size``, and otherwise
    blocks until an in-flight batch gives one of them back: the producer
    runs at most ``size`` batches of one bucket ahead of the fold worker,
    which is the pipeline's memory bound (the buckets' rows sum to less
    than ``2 * shape[0]``, so the ring holds fewer than ``2 * shape[0] *
    size`` rows). A pipeline whose folds keep up holds one buffer per
    bucket its batches need, not ``size``. With ``pin`` (a CUDA device)
    each buffer is page-locked, so the copy to the device runs
    asynchronously at the bus's rate: taken from the process-wide pool when
    one of its shape is free there (``reused``), else allocated and pinned
    with ``cudaHostRegister``; a buffer that cannot be pinned raises with
    the bytes asked for (there is no pageable ring). ``close()`` returns
    the pinned buffers to the pool; a GC finalizer does the same for
    abandoned pipelines. ``nbytes`` is what the ring holds, ``pin_seconds``
    what allocating and pinning its new buffers took.
    """

    def __init__(self, size: int, shape: tuple, dtype, pin: bool):
        self.size = size
        self._shape, self._dtype, self._pin = tuple(shape), np.dtype(dtype), pin
        self._free: dict[int, queue_mod.Queue] = {}  # rows -> free buffers  # guarded-by: _lock
        self._inflight: dict[int, np.ndarray] = {}  # id(buf) -> buf  # guarded-by: _lock
        self._lock = threading.Lock()
        self._bufs: list[np.ndarray] = []  # guarded-by: _lock
        self._finalizer = (
            weakref.finalize(self, _give_back_pinned, self._bufs) if pin else None
        )
        self.nbytes = 0
        self.pin_seconds = 0.0
        self.reused = 0

    def _take_pinned(self, shape: tuple) -> np.ndarray:
        with _PINNED_LOCK:
            free = _PINNED_FREE.get(_pool_key(shape, self._dtype))
            if free:
                self.reused += 1
                return free.pop()
        t0 = time.perf_counter()
        buf = _page_aligned_empty(shape, self._dtype)
        cudart = torch.cuda.cudart()
        try:
            torch.cuda.check_error(cudart.cudaHostRegister(buf.ctypes.data, buf.nbytes, 0))
        except torch.cuda.CudaError as e:
            raise RuntimeError(
                f"cannot page-lock a {buf.nbytes}-byte staging buffer of shape {shape} "
                f"(the ring holds up to {self.size} per bucket of rows, at most "
                f"{self._shape[0]} rows, {self.nbytes} bytes held so far); lower "
                "staging_buffers or the batch size"
            ) from e
        self.pin_seconds += time.perf_counter() - t0
        return buf

    def _grow(self, rows: int) -> np.ndarray | None:
        """One more buffer of ``rows`` rows, or None when that bucket holds
        ``size``."""
        with self._lock:
            if sum(len(b) == rows for b in self._bufs) >= self.size:
                return None
            shape = (rows, *self._shape[1:])
            if self._pin:
                buf = self._take_pinned(shape)
            else:
                buf = _page_aligned_empty(shape, self._dtype)
            self._bufs.append(buf)
            self.nbytes += buf.nbytes
            return buf

    def close(self) -> None:
        """Give the pinned buffers to the process-wide pool (idempotent;
        none may still be in flight: the pipeline drains and waits for its
        copies before it closes)."""
        if self._finalizer is not None:
            self._finalizer()

    def _free_of(self, rows: int) -> queue_mod.Queue:
        with self._lock:
            return self._free.setdefault(rows, queue_mod.Queue())

    def acquire(self, k: int) -> np.ndarray:
        """A buffer of ``bucket_rows(k)`` rows for a batch of ``k``."""
        rows = bucket_rows(k, self._shape[0])
        free = self._free_of(rows)
        try:
            buf = free.get_nowait()
        except queue_mod.Empty:
            buf = self._grow(rows)
            if buf is None:
                buf = free.get()
        with self._lock:
            self._inflight[id(buf)] = buf
        return buf

    def release(self, buf: np.ndarray) -> None:
        with self._lock:
            if self._inflight.pop(id(buf), None) is None:
                return
        self._free_of(len(buf)).put(buf)

    @property
    def in_use(self) -> int:
        """Buffers currently owned by in-flight batches."""
        with self._lock:
            return len(self._inflight)

    @property
    def allocated(self) -> int:
        """Buffers the ring holds (at most ``size`` per bucket of rows)."""
        with self._lock:
            return len(self._bufs)


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
    at a time.
    """

    def __init__(
        self,
        agg: DeviceAggregator,
        staging_buffers: int = 3,
        dispatch_ahead: int = 2,
        max_batch: int = 64,
        packed: bool | None = None,
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
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=dispatch_ahead)
        self._rings: dict[str, _StagingRing] = {}  # lazy: planar / packed  # guarded-by: _lock
        self._in_flight_models = 0  # submitted, not yet folded  # guarded-by: _lock
        self._error: BaseException | None = None  # guarded-by: _lock
        self._poison_seq: int | None = None  # poisoning batch index  # guarded-by: _lock
        self._degraded = False  # sync path for the rest of the round  # guarded-by: _lock
        self._batch_seq = 0  # submit-order index: producer-thread confined
        self._worker: threading.Thread | None = None
        self._closed = False
        self._lock = threading.Lock()
        # the drain window's legs: per batch (seq, start, end) on the
        # monotonic clock; stage on the producer, fold on the worker
        self._stage_log: list[tuple] = []
        self._fold_log: list[tuple] = []  # guarded-by: _lock
        self._window_start: float | None = None
        self.last_window: dict | None = None

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
        """Drain, stop the fold worker and hand the pinned ring buffers back
        to the process-wide pool. Idempotent; a poisoned pipeline still
        shuts down (its error has surfaced, or will, through
        ``drain``/``submit``)."""
        if self._closed:
            return
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
        self._closed = True
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(_SHUTDOWN)
            self._worker.join(timeout=60.0)
        with self._lock:
            rings = list(self._rings.values())
            self._rings.clear()
        for ring in rings:
            ring.close()

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
                else:  # byte-planar packed planes: bpn/(4L) of the planar ring
                    shape, dtype = (self.max_batch, agg.packed_width, agg.padded_length), np.uint8
                # one ring per kind, made at its first submit; its buffers
                # (of max_batch rows or fewer) are added, and pinned or
                # reused pinned, as the traffic needs them
                ring = self._rings[kind] = _StagingRing(
                    self.staging_buffers, shape, dtype, pin=agg.device.type == "cuda"
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

    def _dispatch(self, item: tuple) -> None:
        """Queue to the fold worker, or, once degraded, fold synchronously
        on the caller's thread (same math, no overlap)."""
        buf, payload, kind, k, seq = item
        with self._lock:
            self._in_flight_models += k
            degraded = self._degraded
        if not degraded:
            self._ensure_worker()
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
            self._fold_payload(payload, kind, k)
        except StreamingError:
            with self._lock:  # already poisoned: this batch just leaves flight
                self._in_flight_models -= k
            raise
        except Exception as e:
            unsafe = isinstance(e, _UnsafeFoldError)
            cause = (e.__cause__ or e) if unsafe else e
            self._poison(cause, seq, k, settled=unsafe and e.settled)
            raise self._poison_error() from cause
        finally:
            self._ring(kind).release(buf)
            with self._lock:
                self._fold_log.append((seq, t0, time.monotonic()))

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
        self._batch_seq += 1
        self._stage_log.append((self._batch_seq, t0, time.monotonic()))
        self._dispatch((buf, view, kind, k, self._batch_seq))

    def fold_planar_rows_now(self, rows: list) -> None:
        """Fold device-resident, validity-checked planar ``uint32[L, n]``
        rows (v1 wire ingest) on the CALLER's thread, in chunks of 8.

        Not queued: the rows already occupy device memory, so parking them
        behind ``dispatch_ahead`` would hold several batches on the card at
        once. Queued work finishes first (``agg.acc`` has one mutator at a
        time); each chunk is stacked and folded by K1 on the accumulator's
        stream, after the caller's stream, and the references to it are
        dropped, so the card holds the staged rows plus one chunk's copy."""
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
        self._queue.join()
        err = self._poisoned()
        if err is not None:
            raise self._poison_error() from err
        if self._closed:
            raise StreamingError("pipeline is closed")
        agg = self.agg
        fold = agg._packed_fold_fn if packed else agg._fold_fn
        rows = list(rows)
        while rows:
            piece, rows = rows[:8], rows[8:]
            with agg.on_stream(*piece):
                staged = torch.stack(piece)
                try:
                    fold(agg.acc, staged)
                except Exception as e:
                    # K1 folds in place: acc may hold part of the chunk
                    self._poison(e, None, 0, settled=True)
                    raise self._poison_error() from e
                del staged
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

    def _fold_payload(self, payload: np.ndarray, kind: str, k: int) -> None:
        """Fold one staged batch out of its ring view, on the fold stream.
        Returns once the copy out of the ring buffer has completed, whether
        the fold launched or failed, so the buffer may be reused; the fold
        itself may still run on the device (``drain`` waits for it)."""
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
                self._credit(staged, k, packed=kind == "packed")
                settled = True
            finally:
                # freed into the fold stream's pool: reused only in its order
                del staged
                if copied is not None:
                    try:
                        copied.synchronize()
                    except Exception as e:
                        raise _UnsafeFoldError(settled=settled) from e

    def _degrade_and_retry(self, payload, kind: str, k: int, seq: int,
                           first: Exception) -> None:
        """First fold failure before the launch: switch the pipeline to the
        synchronous path and retry the batch once; a second failure poisons
        permanently."""
        logger.warning(
            "streaming fold failed at batch %d (%s: %s); retrying on the "
            "synchronous path and degrading the pipeline",
            seq, type(first).__name__, first,
        )  # fmt: skip
        with self._lock:
            self._degraded = True
        try:
            self._fold_payload(payload, kind, k)
        except Exception as second:
            # the batch is lost: the accumulator matches no consistent
            # update set any more
            unsafe = isinstance(second, _UnsafeFoldError)
            cause = (second.__cause__ or second) if unsafe else second
            cause.__context__ = first
            self._poison(cause, seq, k, settled=unsafe and second.settled)
            logger.exception("streaming fold batch %d lost; pipeline poisoned", seq)

    def _process(self, item: tuple) -> None:
        """Worker-side fold with the degradation ladder: streaming fold ->
        one synchronous retry (pre-launch failures only) -> sticky poison."""
        buf, payload, kind, k, seq = item
        t0 = time.monotonic()
        try:
            maybe_fail("streaming.fold")
            self._fold_payload(payload, kind, k)
        except _UnsafeFoldError as e:
            # acc may already hold the batch: retrying would fold it twice
            self._poison(e.__cause__ or e, seq, k, settled=e.settled)
            logger.exception("streaming fold batch %d failed at or after launch; "
                             "pipeline poisoned", seq)
        except Exception as first:
            self._degrade_and_retry(payload, kind, k, seq, first)
        finally:
            self._ring(kind).release(buf)
            with self._lock:
                self._fold_log.append((seq, t0, time.monotonic()))

    # -- drain -------------------------------------------------------------

    def drain(self) -> None:
        """Wait for every in-flight fold: the worker's queue, then the fold
        stream (a true completion barrier: the worker waits only for its
        copies, so the last folds may still run on the device, and their
        errors surface here). A poisoned pipeline raises here every time,
        so no aggregate with lost updates escapes as a round result."""
        self._queue.join()
        err = self._poisoned()
        if err is not None:
            raise self._poison_error() from err
        if self.agg.stream is not None:
            try:
                self.agg.stream.synchronize()
            except Exception as e:
                # a fold failed on the device: acc may hold part of it
                with self._lock:
                    if self._error is None:
                        self._error = e
                raise self._poison_error() from e
        self._publish_overlap()

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
        self.last_window = {
            "start": self._window_start, "wall_seconds": wall,
            "stage_seconds": stage_s, "fold_seconds": fold_s, "overlap_ratio": ratio,
            "stage": stage, "fold": fold,
        }  # fmt: skip
        self._window_start = None
