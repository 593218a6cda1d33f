"""Speculative Sum2 mask derivation, with the accumulator on the device.

Port of ``xaynet_tpu/ops/speculation.py``. The Sum2 mask aggregate depends
only on the mask seeds, and a seed is known long before the Sum2 phase
opens: the sum dictionary seals at the Sum -> Update transition, and each
accepted update's mask seed arrives during the update window. A
:class:`SpeculativeMaskSession` derives and folds offered seeds in a
background worker while the update-phase folds still run, so by the time
Sum2 needs the mask aggregate most of the derive work is done and
``settle()`` reduces to reconciliation.

Byte-identity holds whatever the worker reached, because mask aggregation
is a modular sum over a finite group, order-independent and exactly
invertible:

- a **hit** (an offered seed that did arrive) is already folded;
- a **miss** (a seed never offered, or one the worker did not reach) is
  derived on demand at settle time, in offer order, the serial path;
- a **discard** (an offered seed whose participant dropped before Sum2) is
  derived again and subtracted back (``mod_sub_planar``, the group
  inverse), leaving the accumulator as if it had never been folded.

The worker takes *idle* scheduler slots only (``TenantScheduler.
try_acquire_idle``), so speculation never delays a real fold batch, and
every derive group is recorded as an ``overlap.spec_derive`` span (home
phase ``update``).

Where the JAX session keeps a host numpy accumulator, this one keeps the
vector accumulator on the device as a planar ``uint32[L, n]`` tensor: each
group is derived by ``sum_masks_planar`` (K5, then K2 per seed) and folded
into it by K1 planar; discards are subtracted on the device; the
accumulator is downloaded once, at ``settle``. The unit accumulator (one
element) stays on the host. Every method that reaches the device sets it
first, the worker thread's included (CUDA's current device is per thread).

A group whose derive fails is not fatal: its seeds become misses at
``settle`` (the serial path), as in the JAX session. The first such
exception is kept as :attr:`SpeculativeMaskSession.worker_error`, so a
caller can tell a run of misses from a broken derive.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext

import numpy as np
import torch

from ..core.mask.config import MaskConfigPair
from ..device import resolve_device
from ..telemetry import tracing as trace
from ..telemetry.timeline import record_overlap, record_spec_outcomes
from . import limbs as host_limbs
from .fold import fold_planar_batch, mod_sub_planar, planar_to_wire, to_numpy_u32, zeros_u32
from .masking import sum_masks, sum_masks_planar

SPAN_SPEC_DERIVE = trace.declare_span("overlap.spec_derive")


class SpeculativeMaskSession:
    """Background derive and fold of Sum2 masks for seeds offered early.

    One session per (tenant, round). ``offer()`` enqueues seeds the moment
    they are known; ``settle(actual_seeds)`` stops the worker, reconciles
    hits, misses and discards and returns ``(unit limbs, vector wire
    limbs)`` byte-identical to ``masking.sum_masks(actual_seeds, ...)``.
    ``close()`` abandons the session (all work discarded). Runs on
    ``cuda`` unless given a device.
    """

    def __init__(
        self,
        length: int,
        config: MaskConfigPair,
        group: int = 8,
        tenant: str = "default",
        scheduler=None,
        seed_batch: int = 8,
        device=None,
    ):
        self.length = length
        self.config = config
        self.group = max(1, group)
        self.tenant = tenant
        self.seed_batch = seed_batch
        self.device = resolve_device(device)
        self._sched = scheduler
        self._owner = scheduler.new_owner() if scheduler is not None else None
        self._ol_u = host_limbs.order_limbs_for(config.unit.order)
        n_limb_v = host_limbs.n_limbs_for_order(config.vect.order)
        n_limb_u = host_limbs.n_limbs_for_order(config.unit.order)
        with self._on_device():
            self._vect_acc = zeros_u32((n_limb_v, length), self.device)
        self._unit_acc = np.zeros(n_limb_u, dtype=np.uint32)
        self._lock = threading.Lock()
        self._queue: list[bytes] = []  # guarded-by: _lock
        self._queued: set[bytes] = set()  # guarded-by: _lock
        self._folded: set[bytes] = set()  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._wake = threading.Event()
        self._derive_seconds = 0.0  # guarded-by: _lock
        self._worker: threading.Thread | None = None
        self.worker_error: BaseException | None = None  # guarded-by: _lock

    def _on_device(self):
        """Make the session's device current on this thread (CUDA only)."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else nullcontext()

    # -- producer side -----------------------------------------------------

    def offer(self, seeds) -> None:
        """Enqueue seeds for speculative derivation (idempotent per seed)."""
        start_worker = False
        with self._lock:
            if self._closed:
                return
            for seed in seeds:
                if seed not in self._queued:
                    self._queued.add(seed)
                    self._queue.append(seed)
            start_worker = self._worker is None and bool(self._queue)
            if start_worker:
                self._worker = threading.Thread(
                    target=self._run, name="xn-spec-derive", daemon=True
                )
        self._wake.set()
        if start_worker:
            self._worker.start()

    def speculated(self) -> int:
        """Seeds folded into the speculative accumulator so far."""
        with self._lock:
            return len(self._folded)

    # -- worker ------------------------------------------------------------

    def _take_group(self) -> list[bytes] | None:
        with self._lock:
            if self._closed:
                return None
            if not self._queue:
                return []
            group, self._queue = self._queue[: self.group], self._queue[self.group :]
            return group

    def _run(self) -> None:
        while True:
            group = self._take_group()
            if group is None:
                return
            if not group:
                # idle: wait for more offers (settle/close wakes us too)
                self._wake.clear()
                self._wake.wait(timeout=0.05)
                with self._lock:
                    if self._closed and not self._queue:
                        return
                continue
            granted = True
            if self._sched is not None:
                # an IDLE slot only: never delay a real fold batch. A denied
                # slot requeues the group; its seeds become misses at settle
                # if the card stays busy, which is the serial path
                granted = self._sched.try_acquire_idle(self.tenant, self._owner)
            if not granted:
                with self._lock:
                    closing = self._closed
                    if not closing:
                        self._queue = group + self._queue
                if closing:
                    return
                self._wake.clear()
                self._wake.wait(timeout=0.02)
                continue
            try:
                self._derive_group(group)
            except BaseException as err:  # noqa: BLE001 - kept on worker_error
                # fail-soft: the group's seeds fall back to the on-demand
                # path at settle; speculation must never fail a round
                with self._lock:
                    self._queued.difference_update(group)
                    if self.worker_error is None:
                        self.worker_error = err
            finally:
                if self._sched is not None:
                    self._sched.release(self._owner)

    def _derive_group(self, group: list[bytes]) -> None:
        t0 = time.monotonic()
        with self._on_device():
            unit, vect = sum_masks_planar(
                group, self.length, self.config, seed_batch=self.seed_batch, device=self.device
            )
            with self._lock:
                if self._closed:
                    return
                # K1 planar: the group's mask sum as a batch of one, in place
                fold_planar_batch(self._vect_acc, vect[None], self.config.vect.order)
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                self._unit_acc = host_limbs.mod_add(
                    self._unit_acc[None, :], np.asarray(unit)[None, :], self._ol_u
                )[0]
                self._folded.update(group)
                dt = time.monotonic() - t0
                self._derive_seconds += dt
        trace.get_tracer().record_span(
            SPAN_SPEC_DERIVE,
            start=t0,
            duration=dt,
            phase="update",
            tenant=self.tenant,
            seeds=len(group),
        )

    # -- consumer side -----------------------------------------------------

    def _stop_worker(self) -> None:
        with self._lock:
            self._closed = True
        self._wake.set()
        worker = self._worker
        if worker is not None:
            worker.join()

    def close(self) -> None:
        """Abandon the session; all speculative work is discarded."""
        self._stop_worker()
        if self._sched is not None:
            self._sched.release_owner(self._owner)

    def settle(self, seeds: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
        """Reconcile against the ACTUAL Sum2 seed set and return the mask
        aggregate ``(unit limbs, vector wire limbs [length, L])``,
        byte-identical to the non-speculative ``sum_masks(seeds, ...)``."""
        if not seeds:
            raise ValueError("no seeds to aggregate")
        self._stop_worker()
        try:
            with self._on_device():
                return self._settle(seeds)
        finally:
            if self._sched is not None:
                self._sched.release_owner(self._owner)

    def _settle(self, seeds: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
        wanted = set(seeds)
        if len(wanted) != len(seeds):
            # duplicate seeds (the protocol's seed dict never has them, but
            # sum_masks accepts them): speculation folded each seed once, so
            # take the serial path outright
            record_spec_outcomes(misses=len(seeds))
            return sum_masks(
                seeds, self.length, self.config, seed_batch=self.seed_batch, device=self.device
            )
        with self._lock:
            folded = set(self._folded)
            vect_acc, unit_acc = self._vect_acc, self._unit_acc
            spec_seconds = self._derive_seconds
        hits = wanted & folded
        discards = sorted(folded - wanted)
        misses = [s for s in seeds if s not in folded]  # keep offer order
        order_v = self.config.vect.order
        for group, sub in ((discards, True), (misses, False)):
            if not group:
                continue
            unit, vect = sum_masks_planar(
                group, self.length, self.config, seed_batch=self.seed_batch, device=self.device
            )
            if sub:
                vect_acc = mod_sub_planar(vect_acc, vect, order_v)
                unit_acc = host_limbs.mod_sub(
                    unit_acc[None, :], np.asarray(unit)[None, :], self._ol_u
                )[0]
            else:
                fold_planar_batch(vect_acc, vect[None], order_v)
                unit_acc = host_limbs.mod_add(
                    unit_acc[None, :], np.asarray(unit)[None, :], self._ol_u
                )[0]
        record_spec_outcomes(hits=len(hits), misses=len(misses), discards=len(discards))
        if spec_seconds > 0:
            record_overlap(
                "spec_derive",
                spec_seconds,
                tenant=self.tenant,
                hits=len(hits),
                misses=len(misses),
                discards=len(discards),
            )
        # the one download of the session
        return unit_acc, planar_to_wire(to_numpy_u32(vect_acc))
