"""Paged accumulator pool: fixed-size limb-plane pages under lease accounting.

The port's copy of ``xaynet_tpu/tenancy/pool.py``. The Ragged Paged
Attention idiom (PAPERS.md) applied to aggregation accumulators instead of
KV cache: tenants' variable-length masked models pack into one shared
memory arena as runs of fixed-size pages, so many models of different
lengths coexist without per-tenant worst-case reservations and without
allocator fragmentation across rounds — a released run coalesces back
into the free list and the next tenant's lease reuses the same physical
pages.

Two arenas, one accounting discipline:

- **host arena** — real paging: a set of page-aligned uint8 slabs; a
  lease carves a *contiguous page run* out of a slab and hands back a
  typed numpy view. Contiguity per lease is the design point: the staging
  ring packs a batch into the view and the host-to-device copy reads it
  as one plain C-contiguous buffer. Leased memory is ZEROED before
  handoff — a page run previously owned by another tenant must never leak
  that tenant's masked bytes. A lease asked for ``pinned`` (a staging
  ring that feeds a CUDA device) lands in a page-locked slab: a slab is
  page-locked with ``cudaHostRegister`` once, when a pinned lease first
  lands in it (a slab grown for a pinned lease is locked as it is
  created) — outside the pool lock, so locking a large slab stalls no
  other lease, release or read of the pool — and stays locked for as
  long as the pool holds it; the
  compaction's trim of free trailing slabs unlocks a slab before it drops
  it, and a slab the pool no longer holds unlocks when its memory is
  freed. So a process pays the pinning once per slab, not once per round.
- **device arena** — a capacity ledger: what multi-tenant admission needs
  from device memory is the *budget*: the ledger tracks pages leased per
  tenant (each round's accumulator, ``parallel.aggregator``) against the
  configured capacity and fails fast when a new tenant's accumulator
  would not fit. It does not back tensors with device pages.

Accounting invariant (checked at round boundaries): **leases == releases
at round end** — every page run leased for a round's accumulator and
staging rings is released when the round's accumulator dies. The clean
path releases explicitly (`StagedAggregator.release_pool`, ring close);
`reclaim()` is the crash-path backstop the next round's Idle phase runs,
counting every straggler it had to force-release.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..telemetry.registry import get_registry

logger = logging.getLogger("xaynet.tenancy")

_registry = get_registry()
POOL_PAGES = _registry.gauge(
    "xaynet_pool_pages",
    "Pool pages currently leased, by arena (host | device) and tenant.",
    ("arena", "tenant"),
)
POOL_LEASES = _registry.counter(
    "xaynet_pool_leases_total",
    "Page-run leases granted, by arena and tenant.",
    ("arena", "tenant"),
)
POOL_RELEASES = _registry.counter(
    "xaynet_pool_releases_total",
    "Page-run leases released, by arena and tenant (reclaimed releases "
    "count here too).",
    ("arena", "tenant"),
)
POOL_RECLAIMED = _registry.counter(
    "xaynet_pool_reclaimed_total",
    "Leases force-released by the round-boundary reclaim (a crashed or "
    "abandoned round leaked them past its unmask release).",
    ("tenant",),
)
POOL_FRAGMENTATION = _registry.gauge(
    "xaynet_pool_fragmentation",
    "Host-arena fragmentation: 1 - largest free run / total free pages "
    "(0 when the free space is one contiguous run or the arena is full).",
)
POOL_COMPACTIONS = _registry.counter(
    "xaynet_pool_compactions_total",
    "Between-round host-arena compaction passes run by the Idle phase.",
)
POOL_PAGES_MIGRATED = _registry.counter(
    "xaynet_pool_pages_migrated_total",
    "Host pages moved by compaction (memmove under the lease lock, page "
    "tables rewritten atomically).",
)

# the label of pages leased outside any coordinator (a script, a helper,
# a test): no tenant id validates to it, so no coordinator's round-boundary
# reclaim ever takes them
LOCAL_TENANT = "_local"

DEFAULT_PAGE_BYTES = 1 << 20  # 1 MiB: a few limb-plane columns per page
DEFAULT_SLAB_PAGES = 64
_OS_PAGE = 4096


def page_aligned_empty(shape: tuple, dtype) -> np.ndarray:
    """``np.empty`` whose data starts and ends on page boundaries (what
    ``cudaHostRegister`` page-locks)."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    raw = np.empty(nbytes + 2 * _OS_PAGE, dtype=np.uint8)
    off = (-raw.ctypes.data) % _OS_PAGE
    return raw[off : off + nbytes].view(dtype).reshape(shape)


def _host_unregister(ptr: int) -> None:
    """Unlock a page-locked slab (its finalizer: runs once, before the
    slab's memory is freed)."""
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(ptr))


class PoolExhausted(RuntimeError):
    """The arena's configured page capacity cannot satisfy the lease."""


@dataclass
class PageLease:
    """One granted page run. ``array`` is the typed view for host leases
    (None for device-ledger leases). Release is idempotent.

    ``migrator`` opts the lease into compaction: when set, ``compact()``
    may move the run to a lower offset and calls ``migrator(new_view)``
    so the holder swaps its reference. Migrators run under the pool lock
    and must be non-blocking reference swaps — holders register one only
    while their buffers are quiescent (between rounds). Leases without a
    migrator are immovable barriers."""

    tenant: str
    arena: str  # "host" | "device"
    lease_id: int
    pages: int
    slab: int = -1  # host: owning slab index
    offset: int = -1  # host: first page within the slab
    array: Optional[np.ndarray] = None
    released: bool = field(default=False, repr=False)
    migrator: Optional[object] = field(default=None, repr=False)
    # host: the seconds this lease spent page-locking its slab (0.0 when
    # the slab was locked already or the lease is not pinned)
    pin_seconds: float = 0.0
    # device: the card whose memory the ledger charges ("" = unnamed)
    device: str = ""


class _Slab:
    """One page-aligned host slab with a sorted free-run list."""

    def __init__(self, n_pages: int, page_bytes: int):
        self.n_pages = n_pages
        self.page_bytes = page_bytes
        # page-aligned (what cudaHostRegister locks); a lease zeroes its
        # run before handoff, so the slab itself need not be
        self.buf = page_aligned_empty((n_pages * page_bytes,), np.uint8)
        self.free: list[tuple[int, int]] = [(0, n_pages)]  # (start, length)
        self._unpin: Optional[weakref.finalize] = None
        # set while one lease page-locks the slab outside the pool lock;
        # other pinned leases in the slab wait on it
        self.pinning: Optional[threading.Event] = None

    @property
    def pinned(self) -> bool:
        return self._unpin is not None and self._unpin.alive

    def pin(self) -> float:
        """Page-lock the slab (once); returns the seconds it took. The
        unlock is tied to the memory's owner, so it runs before the memory
        is freed even when views of a dropped slab outlive it."""
        if self.pinned:
            return 0.0
        t0 = time.perf_counter()
        ptr = self.buf.ctypes.data
        try:
            torch.cuda.check_error(
                torch.cuda.cudart().cudaHostRegister(ptr, self.buf.nbytes, 0)
            )
        except torch.cuda.CudaError as e:
            raise RuntimeError(
                f"cannot page-lock a {self.buf.nbytes}-byte pool slab"
            ) from e
        self._unpin = weakref.finalize(self.buf.base, _host_unregister, ptr)
        return time.perf_counter() - t0

    def unpin(self) -> None:
        if self._unpin is not None:
            self._unpin()

    def take(self, pages: int) -> Optional[int]:
        """First-fit contiguous run; returns the start page or None."""
        for i, (start, length) in enumerate(self.free):
            if length >= pages:
                if length == pages:
                    del self.free[i]
                else:
                    self.free[i] = (start + pages, length - pages)
                return start
        return None

    def give(self, start: int, pages: int) -> None:
        """Return a run, coalescing with its neighbours."""
        runs = self.free
        runs.append((start, pages))
        runs.sort()
        merged: list[tuple[int, int]] = []
        for s, l in runs:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + l)
            else:
                merged.append((s, l))
        self.free[:] = merged

    @property
    def free_pages(self) -> int:
        return sum(l for _, l in self.free)


class PagePool:
    """Host-slab page allocator + device capacity ledger with per-tenant
    page tables and lease/release accounting (docs/DESIGN.md §19)."""

    def __init__(
        self,
        page_bytes: int = DEFAULT_PAGE_BYTES,
        slab_pages: int = DEFAULT_SLAB_PAGES,
        host_pages: int = 0,
        device_pages: int = 0,
    ):
        if page_bytes < 4096 or page_bytes % 4096:
            raise ValueError("page_bytes must be a positive multiple of 4096")
        if slab_pages < 1:
            raise ValueError("slab_pages must be >= 1")
        self.page_bytes = page_bytes
        self.slab_pages = slab_pages
        # 0 = uncapped (the arena grows by slabs on demand); a cap makes
        # lease() raise PoolExhausted instead of over-committing
        self.host_pages = host_pages
        self.device_pages = device_pages
        self._lock = threading.Lock()
        self._slabs: list[_Slab] = []  # guarded-by: _lock
        self._leases: dict[int, PageLease] = {}  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._in_use = {"host": 0, "device": 0}  # pages  # guarded-by: _lock
        # device pages by card: each card has its own memory, so the cap
        # holds per card (a mesh over several cards leases a slice on each)
        self._device_in_use: dict[str, int] = {}  # guarded-by: _lock
        # leases a GC finalizer handed back while a pool call held the lock
        # (a collection may run inside any allocation): released by the next
        # pool call (deque: appends and pops are atomic)
        self._deferred: deque = deque()
        self.pin_seconds = 0.0  # every slab's page-locking, summed  # guarded-by: _lock

    # -- leasing ------------------------------------------------------------

    def pages_for(self, nbytes: int) -> int:
        return max(1, -(-int(nbytes) // self.page_bytes))

    def lease_host(self, tenant: str, shape: tuple, dtype, pinned: bool = False) -> PageLease:
        """Lease a contiguous page run and return it as a ZEROED
        C-contiguous ``dtype[shape]`` view. Raises :class:`PoolExhausted`
        only when a configured ``host_pages`` cap cannot fit the run. With
        ``pinned`` the run's slab is page-locked (once per slab; the
        lease's ``pin_seconds`` is what locking took). The run is reserved
        under the pool lock and the slab locked after it is let go, so
        other tenants' leases and releases go on meanwhile. Page placement
        is the same either way."""
        self._release_deferred()
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        pages = self.pages_for(nbytes)
        with self._lock:
            if self.host_pages and self._in_use["host"] + pages > self.host_pages:
                raise PoolExhausted(
                    f"host arena: {pages} pages requested, "
                    f"{self.host_pages - self._in_use['host']} of "
                    f"{self.host_pages} available"
                )
            slab_idx, start = -1, None
            for i, slab in enumerate(self._slabs):
                start = slab.take(pages)
                if start is not None:
                    slab_idx = i
                    break
            if start is None:
                # no run fits: grow the arena by one slab sized for the
                # request (large models get a dedicated slab; small ones
                # share the default slab granularity)
                slab = _Slab(max(self.slab_pages, pages), self.page_bytes)
                self._slabs.append(slab)
                slab_idx = len(self._slabs) - 1
                start = slab.take(pages)
            slab = self._slabs[slab_idx]
            lease = self._grant_locked(tenant, "host", pages, slab_idx, start)
        if pinned:
            try:
                lease.pin_seconds = self._pin_slab(slab)
            except RuntimeError:
                self.release(lease)
                raise
        raw = slab.buf[start * self.page_bytes : start * self.page_bytes + nbytes]
        view = raw.view(dtype).reshape(shape)
        view.fill(0)  # cross-tenant hygiene: never hand over another
        # tenant's masked bytes
        lease.array = view
        return lease

    def _pin_slab(self, slab: _Slab) -> float:
        """Page-lock ``slab`` unless it is locked already; returns the
        seconds this call spent locking it. ``cudaHostRegister`` of a large
        slab takes up to a second, so it runs outside the pool lock: the
        first caller marks the slab as being locked, and another pinned
        lease in it waits for that, not for the pool."""
        while True:
            with self._lock:
                if slab.pinned:
                    return 0.0
                event = slab.pinning
                if event is None:
                    event = slab.pinning = threading.Event()
                    break
            event.wait()
        seconds = 0.0
        try:
            seconds = slab.pin()
        finally:
            with self._lock:
                slab.pinning = None
                self.pin_seconds += seconds
            event.set()
        return seconds

    def lease_device(self, tenant: str, nbytes: int, device: str = "") -> PageLease:
        """Ledger-only device lease: accounts ``nbytes`` of ``device``'s
        memory as pages against the device capacity, which holds per card
        (the accumulator is a torch tensor of its own; the ledger carries
        its budget, not its pages)."""
        self._release_deferred()
        pages = self.pages_for(nbytes)
        with self._lock:
            used = self._device_in_use.get(device, 0)
            if self.device_pages and used + pages > self.device_pages:
                raise PoolExhausted(
                    f"device arena{' of ' + device if device else ''}: {pages} pages "
                    f"requested, {self.device_pages - used} of {self.device_pages} available"
                )
            self._device_in_use[device] = used + pages
            lease = self._grant_locked(tenant, "device", pages, -1, -1)
            lease.device = device
            return lease

    def device_pages_by_device(self) -> dict[str, int]:
        """Device-ledger pages in use, by card."""
        self._release_deferred()
        with self._lock:
            return {d: n for d, n in self._device_in_use.items() if n}

    def _grant_locked(
        self, tenant: str, arena: str, pages: int, slab: int, offset: int
    ) -> PageLease:
        self._next_id += 1
        lease = PageLease(
            tenant=tenant,
            arena=arena,
            lease_id=self._next_id,
            pages=pages,
            slab=slab,
            offset=offset if offset is not None else -1,
        )
        self._leases[lease.lease_id] = lease
        self._in_use[arena] += pages
        POOL_PAGES.labels(arena=arena, tenant=tenant).inc(pages)
        POOL_LEASES.labels(arena=arena, tenant=tenant).inc()
        return lease

    def release_soon(self, leases: list) -> None:
        """Release ``leases`` from a GC finalizer (the backstop of an
        aggregator, shard plan or staging ring dropped without its explicit
        release). A collection can run inside any pool call on this very
        thread, with the pool lock held, so the finalizer must not wait for
        that lock: the leases are queued, released here at once if no pool
        call is in progress, else by the next pool call."""
        self._deferred.extend(leases)
        if self._lock.acquire(blocking=False):
            self._lock.release()
            self._release_deferred()

    def _release_deferred(self) -> None:
        while True:
            try:
                lease = self._deferred.popleft()
            except IndexError:
                return
            self.release(lease)

    def release(self, lease: PageLease) -> bool:
        """Return a lease's pages (idempotent: the GC finalizer backstop
        and the explicit unmask-path release may both run). Returns True
        only for the call that actually released — callers that account
        per-release (reclaim) key off this instead of assuming they won
        the race."""
        with self._lock:
            if lease.released or lease.lease_id not in self._leases:
                return False
            lease.released = True
            del self._leases[lease.lease_id]
            self._in_use[lease.arena] -= lease.pages
            if lease.arena == "device":
                self._device_in_use[lease.device] -= lease.pages
            if lease.arena == "host" and 0 <= lease.slab < len(self._slabs):
                self._slabs[lease.slab].give(lease.offset, lease.pages)
        lease.array = None
        lease.migrator = None
        POOL_PAGES.labels(arena=lease.arena, tenant=lease.tenant).dec(lease.pages)
        POOL_RELEASES.labels(arena=lease.arena, tenant=lease.tenant).inc()
        return True

    def set_migrator(self, lease: PageLease, migrator) -> None:
        """Register (or clear, with ``None``) a lease's compaction
        migrator ATOMICALLY with respect to :meth:`compact`: the toggle
        takes the lease lock, so a holder that clears the migrator before
        touching its buffer can never observe a half-migrated run — either
        a concurrent compaction already finished (``lease.array`` is the
        new view) or it will treat the lease as an immovable barrier.
        No-op on released leases."""
        with self._lock:
            if not lease.released:
                lease.migrator = migrator

    # -- accounting ---------------------------------------------------------

    def outstanding(self, tenant: Optional[str] = None) -> list[PageLease]:
        self._release_deferred()
        with self._lock:
            return [
                l
                for l in self._leases.values()
                if tenant is None or l.tenant == tenant
            ]

    def balanced(self, tenant: str) -> bool:
        """True when the tenant holds zero leases (the round-end invariant:
        every lease was released)."""
        return not self.outstanding(tenant)

    def reclaim(self, tenant: str) -> int:
        """Force-release every lease the tenant still holds — the
        round-boundary backstop for rounds that died before their unmask
        release. Returns the number reclaimed (0 on the healthy path).

        Idempotent per lease id: a GC finalizer may release a straggler
        between our ``outstanding()`` snapshot and the force-release, so
        only leases *this* call actually released count on
        ``xaynet_pool_reclaimed_total`` (counting the snapshot length
        double-counted those races)."""
        won = [lease for lease in self.outstanding(tenant) if self.release(lease)]
        if won:
            POOL_RECLAIMED.labels(tenant=tenant).inc(len(won))
            logger.warning(
                "pool: reclaimed %d leaked lease(s) (%d pages) from tenant %s",
                len(won),
                sum(l.pages for l in won),
                tenant,
            )
        return len(won)

    def page_table(self, tenant: str) -> dict[int, dict]:
        """The tenant's logical->physical mapping: lease id -> arena, slab,
        page offset, run length (host leases; device leases carry -1)."""
        with self._lock:
            return {
                l.lease_id: {
                    "arena": l.arena,
                    "slab": l.slab,
                    "offset": l.offset,
                    "pages": l.pages,
                }
                for l in self._leases.values()
                if l.tenant == tenant
            }

    def fragmentation(self) -> float:
        """Host-arena fragmentation in [0, 1): ``1 - largest free run /
        total free pages``. 0 means every free page is reachable as one
        contiguous run (or there is nothing free to fragment); values near
        1 mean the free space is shredded into runs too small to serve a
        large lease. Exported on ``xaynet_pool_fragmentation`` each call
        (the Idle phase samples it to decide whether to compact)."""
        with self._lock:
            frag = self._fragmentation_locked()
        POOL_FRAGMENTATION.set(frag)
        return frag

    def _fragmentation_locked(self) -> float:
        total = sum(s.free_pages for s in self._slabs)  # lint: guarded-ok: _locked suffix — every caller holds _lock
        if not total:
            return 0.0
        largest = max(
            (length for s in self._slabs for _, length in s.free),  # lint: guarded-ok: _locked suffix
            default=0,
        )
        return 1.0 - largest / total

    def compact(self) -> int:
        """Between-round host-arena compaction: slide migratable leases
        (those carrying a ``migrator``) toward page 0 of their slab so the
        free runs behind them coalesce, then drop fully-free trailing
        slabs. Returns the number of pages moved.

        The whole pass runs under the lease lock: bytes memmove to the new
        run, the page table (lease.slab/offset and the slab free lists) is
        rewritten atomically, and each holder's ``migrator(new_view)``
        swaps its reference before the lock drops — no thread can observe
        a half-migrated lease. Leases without a migrator (a round's live
        fold buffers) are immovable barriers; compaction never crosses
        them, so leases==releases accounting is untouched (no lease is
        released or granted here)."""
        moved_pages = 0
        with self._lock:
            by_slab: dict[int, list[PageLease]] = {}
            for lease in self._leases.values():
                if lease.arena == "host" and 0 <= lease.slab < len(self._slabs):
                    by_slab.setdefault(lease.slab, []).append(lease)
            for slab_idx, leases in by_slab.items():
                slab = self._slabs[slab_idx]
                cursor = 0
                for lease in sorted(leases, key=lambda l: l.offset):
                    if lease.migrator is None or lease.offset <= cursor:
                        # immovable barrier, or already packed: skip past it
                        cursor = max(cursor, lease.offset + lease.pages)
                        continue
                    src = lease.offset * self.page_bytes
                    dst = cursor * self.page_bytes
                    nbytes = (
                        lease.array.nbytes
                        if lease.array is not None
                        else lease.pages * self.page_bytes
                    )
                    # copy through a temp: src and dst runs may overlap
                    slab.buf[dst : dst + nbytes] = slab.buf[src : src + nbytes].copy()
                    moved_pages += lease.pages
                    lease.offset = cursor
                    if lease.array is not None:
                        raw = slab.buf[dst : dst + nbytes]
                        view = raw.view(lease.array.dtype).reshape(lease.array.shape)
                        lease.array = view
                        lease.migrator(view)
                    cursor += lease.pages
                # rewrite the free list as the complement of the (now
                # packed) occupied runs
                occupied = sorted(
                    (l.offset, l.pages)
                    for l in self._leases.values()
                    if l.arena == "host" and l.slab == slab_idx
                )
                free: list[tuple[int, int]] = []
                edge = 0
                for start, length in occupied:
                    if start > edge:
                        free.append((edge, start - edge))
                    edge = start + length
                if edge < slab.n_pages:
                    free.append((edge, slab.n_pages - edge))
                slab.free[:] = free
            # trim fully-free trailing slabs (mid-list slabs stay: lease
            # slab indices are positional)
            while self._slabs and self._slabs[-1].free_pages == self._slabs[-1].n_pages:
                self._slabs.pop().unpin()
            frag = self._fragmentation_locked()
        POOL_COMPACTIONS.inc()
        if moved_pages:
            POOL_PAGES_MIGRATED.inc(moved_pages)
            logger.info("pool: compaction migrated %d page(s)", moved_pages)
        POOL_FRAGMENTATION.set(frag)
        return moved_pages

    def pinned_bytes(self) -> int:
        """Bytes of the host arena that are page-locked."""
        with self._lock:
            return sum(s.buf.nbytes for s in self._slabs if s.pinned)

    def stats(self) -> dict:
        self._release_deferred()
        with self._lock:
            tenant_leases: dict[str, int] = {}
            for lease in self._leases.values():
                tenant_leases[lease.tenant] = tenant_leases.get(lease.tenant, 0) + 1
            return {
                "page_bytes": self.page_bytes,
                "slabs": len(self._slabs),
                "host_pages_in_use": self._in_use["host"],
                "host_pages_free": sum(s.free_pages for s in self._slabs),
                "device_pages_in_use": self._in_use["device"],
                "leases": len(self._leases),
                "tenant_leases": tenant_leases,
                "fragmentation": self._fragmentation_locked(),
            }


_pool_lock = threading.Lock()
_pool: Optional[PagePool] = None


def get_pool() -> PagePool:
    """The process-wide accumulator pool (configured from ``[tenancy]`` by
    the runner; defaults are fine for tests and single-tenant use)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = PagePool()
        return _pool


def configure_pool(
    page_kib: int, slab_pages: int, host_pages: int, device_pages: int
) -> PagePool:
    """Install the configured process pool (runner startup). Replaces the
    default instance; existing leases on the old pool keep their slabs'
    memory alive through their own views (a page-locked slab unlocks when
    that memory is freed)."""
    global _pool
    pool = PagePool(
        page_bytes=page_kib * 1024,
        slab_pages=slab_pages,
        host_pages=host_pages,
        device_pages=device_pages,
    )
    with _pool_lock:
        _pool = pool
    return pool
