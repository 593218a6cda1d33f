"""Process-sharded loadgen entry point: ``python -m xaynet_tpu_torch.loadgen.runner``.

Port of ``xaynet_tpu/loadgen/runner.py``. ``cfg`` (and the CLI) gain
``device``: where the drivers derive their populations' masks, CUDA
unless given; the parent resolves it first (without a card a run raises
``DeviceUnavailable`` before anything is spawned) and builds the kernels
once, so the drivers only load them. Each driver also reports the kernel
launches it made (``launches``) and its forge seconds (``forge_s``); the
run reports the accepted POSTs' seconds (``post_s``: p50, p99, max), and
a driver that fails or exits without reporting fails it. Tenant and edge
targets stay plain URLs; the port's coordinator serves the root routes
only (ROADMAP items 16 and 18). ``ground_truth`` rebuilds what a
one-target run forged, for a control round.

One run = one round's worth of forged update traffic against a live
coordinator. The parent only does bookkeeping; every DRIVER is a spawned
process that independently (no cross-process pickling of round state):

1. fetches ``GET /params`` and polls ``GET /sums`` over the same REST
   boundary a participant uses, so the forge sees exactly the negotiated
   round (wire format included);
2. forges its participant range — the signing-key search space is
   partitioned by cumulative participant offset (``key_start + offset *
   key_spacing``, same rule as ``sdk.flood``) so shards never collide;
3. replays the shard through the event-driven driver against its target
   set (coordinator root, ``/t/<tenant>/`` routes, or edge-runner URLs);
4. reports a ``DriverStats`` dict back through a queue.

Defaults mirror the ``[loadgen]`` section of the coordinator TOML
(``server.settings.LoadgenSettings``) so one config file describes a
whole soak; every knob is also a CLI flag for ad-hoc runs.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import multiprocessing as mp
import sys
import queue as queue_mod
import time
from fractions import Fraction

import numpy as np

from .build import forge_population, population_inputs
from .driver import DriverStats, ReplayDriver
from .schedule import ChurnSpec, ReplaySchedule

# forge key-space stride per participant (sdk.flood's spacing): wide
# enough that the per-participant signing-key search never runs past its
# neighbour's range
KEY_SPACING = 1000


def shard_sizes(participants: int, drivers: int) -> list[int]:
    """Participant count per driver: near-even, deterministic, sums to n."""
    base, extra = divmod(participants, drivers)
    return [base + (1 if d < extra else 0) for d in range(drivers)]


def ground_truth(cfg: dict) -> tuple[list[bytes], np.ndarray, Fraction]:
    """The mask seeds, local models ``float32[P, n]`` and scalar a run of
    ``cfg`` against ONE target forges, in shard order: what a control round
    (``sim.SimRound``) replays to hold the coordinator's model against.
    Every forged participant must upload, so a run with dropouts is refused
    (stragglers upload late and are covered)."""
    if len(list(cfg.get("targets") or ()) or targets_for(cfg["url"], cfg["tenants"])) != 1:
        raise ValueError("ground_truth covers a run against one target")
    if cfg["dropout_rate"] > 0:
        raise ValueError(
            "ground_truth covers a run in which every participant uploads; "
            f"dropout_rate = {cfg['dropout_rate']} leaves some out"
        )
    if cfg["model_length"] is None:
        raise ValueError("ground_truth needs the model length in cfg")
    seeds, weights = [], []
    for shard, n in enumerate(shard_sizes(cfg["participants"], cfg["drivers"])):
        if n:
            w, s = population_inputs(n, cfg["model_length"], cfg["seed"] + shard)
            seeds += s
            weights.append(w)
    return seeds, np.concatenate(weights), Fraction(1, cfg["participants"])


def targets_for(url: str, tenants: str) -> list[str]:
    """Target URLs for a run: tenant routes if given, else the root."""
    names = [t.strip() for t in tenants.split(",") if t.strip()]
    return [f"{url.rstrip('/')}/t/{t}" for t in names] if names else [url]


async def _fetch_round(target: str, timeout: float, sum_wait_s: float):
    """GET /params + poll /sums over the participant REST boundary — each
    driver sees exactly the negotiated round, wire format included."""
    from ..sdk.client import HttpClient

    client = HttpClient(target, timeout=timeout)
    try:
        params = await client.get_round_params()
        deadline = time.monotonic() + sum_wait_s
        while True:
            sums = await client.get_sums()
            if sums:
                return params, sums
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"{target}: no sum dict before deadline — is the "
                    "coordinator in the update phase?"
                )
            await asyncio.sleep(0.25)
    finally:
        client.close()


async def _shard_main(shard: int, cfg: dict) -> dict:
    """One driver's whole life: fetch round(s), forge the shard, replay.

    Every TARGET (tenant route or edge endpoint pointing at a distinct
    coordinator round) is its own PET round with its own params, sum dict
    and signing-key population — so the shard forges one sub-population
    per target against that target's negotiated round, then replays them
    concurrently under one shared pacing clock. Global participant ``g``
    belongs to target ``g % T`` and signing-key range ``key_start + g *
    KEY_SPACING`` — the assignment depends only on (participants,
    drivers, targets), so re-sharding the tier never collides keys and a
    control run can rebuild any slice."""
    from ..ops import kernels

    sizes = shard_sizes(cfg["participants"], cfg["drivers"])
    shard_n = sizes[shard]
    if shard_n == 0:
        return {**DriverStats().to_dict(), "launches": dict(kernels.LAUNCHES)}
    # participants before this shard -> this shard's global index offset
    offset = sum(sizes[:shard])
    # explicit target list (edge-runner URLs) beats the tenant expansion
    targets = list(cfg.get("targets") or ()) or targets_for(
        cfg["url"], cfg["tenants"]
    )
    n_t = len(targets)
    # shared_round: every target fronts the SAME coordinator round (edge
    # fan-in) — one population, one scalar; unshared targets (tenant
    # routes) are each their own round with their own sub-population
    shared = bool(cfg.get("shared_round"))
    wire = {"auto": None, "packed": True, "legacy": False}[cfg["wire"]]

    async def one_target(t_idx: int, target: str) -> DriverStats:
        # this target's global indices within the shard: g ≡ t_idx (mod T)
        first = offset + ((t_idx - offset) % n_t)
        count = len(range(first, offset + shard_n, n_t))
        if count == 0:
            return DriverStats()
        params, sums = await _fetch_round(
            target, cfg["timeout"], cfg["sum_wait_s"]
        )
        forge_t0 = time.monotonic()
        population = forge_population(
            params,
            sums,
            count,
            # the scalar is a POPULATION property of the target's round:
            # 1/(that round's total updaters across ALL drivers), never
            # 1/shard — a shard-local default would change the aggregate
            # whenever the tier is re-sharded
            scalar=Fraction(
                1,
                cfg["participants"]
                if shared
                else len(range(t_idx, cfg["participants"], n_t)),
            ),
            model_length=cfg["model_length"],
            block_size=cfg["block_size"],
            key_start=cfg["key_start"] + first * KEY_SPACING,
            key_spacing=n_t * KEY_SPACING,
            rng_seed=cfg["seed"] + shard * n_t + t_idx,
            wire_planar=wire,
            device=cfg["device"],
        )
        forge_s = time.monotonic() - forge_t0
        schedule = ReplaySchedule(
            count,
            ChurnSpec(
                dropout_rate=cfg["dropout_rate"],
                stragglers=cfg["stragglers"],
                straggle_delay_s=cfg["straggle_delay_ms"] / 1000.0,
                seed=cfg["seed"] + shard * n_t + t_idx,
            ),
            ramp_s=cfg["ramp_s"],
        )
        driver = ReplayDriver(
            [target],
            concurrency=max(1, cfg["concurrency"] // n_t),
            timeout=cfg["timeout"],
            max_shed_retries=cfg["max_shed_retries"],
        )
        t0 = time.time()
        try:
            return await driver.replay(population.messages, schedule), t0, time.time(), forge_s
        finally:
            driver.close()

    results = [r for r in await asyncio.gather(
        *(one_target(i, t) for i, t in enumerate(targets))
    ) if isinstance(r, tuple)]
    merged = DriverStats()
    for r, *_ in results:
        merged.merge(r)
    out = merged.to_dict()
    out["forge_s"] = sum(f for *_, f in results)
    # epoch replay window (forge time excluded) so the parent can compute
    # the TIER's replay wall — drivers overlap; summing or walling the
    # whole parent run would fold forge/kernel-build time into the rate
    if results:
        out["replay_start"] = min(t0 for _, t0, _, _ in results)
        out["replay_end"] = max(t1 for _, _, t1, _ in results)
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def _shard_entry(shard: int, cfg: dict, queue) -> None:
    """Spawned-process entry (top level so the spawn context can pickle
    it); ships a result or an error marker — the parent never hangs."""
    try:
        queue.put((shard, _run_shard(shard, cfg), None))
    except BaseException as exc:  # noqa: BLE001 - report, don't swallow
        queue.put((shard, None, f"{type(exc).__name__}: {exc}"))


def _run_shard(shard: int, cfg: dict) -> dict:
    return asyncio.run(_shard_main(shard, cfg))


def _post_quantiles(post_s: list) -> dict:
    if not post_s:
        return {"n": 0}
    x = np.asarray(post_s)
    return {"n": len(x), "p50": float(np.quantile(x, 0.5)), "p99": float(np.quantile(x, 0.99)),
            "max": float(x.max())}  # fmt: skip


def _collect(procs, queue) -> list:
    """One ``(shard, stats, error)`` per driver; a driver that exits without
    reporting (killed, crashed in native code) is an error, not a hang."""
    got: dict = {}
    while len(got) < len(procs):
        try:
            shard, stats, err = queue.get(timeout=1.0)
            got[shard] = (shard, stats, err)
        except queue_mod.Empty:
            for shard, p in enumerate(procs):
                if shard not in got and p.exitcode is not None:
                    try:  # its report may have landed just before it exited
                        shard_, stats, err = queue.get(timeout=5.0)
                        got[shard_] = (shard_, stats, err)
                    except queue_mod.Empty:
                        got[shard] = (shard, None, f"exited with code {p.exitcode} "
                                                   "without reporting")  # fmt: skip
    return [got[s] for s in sorted(got)]


def run(cfg: dict) -> dict:
    """Run the whole driver tier; returns the merged stats dict.

    Always process-sharded (spawn context): each driver owns its own CUDA
    context and socket pool, so forging scales across cores and a driver
    crash cannot take the parent down. A driver that fails fails the run.
    """
    from ..device import resolve_device
    from ..ops import kernels

    if resolve_device(cfg["device"]).type == "cuda":
        kernels.build()  # once, before the drivers load the libraries
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [
        ctx.Process(target=_shard_entry, args=(shard, cfg, queue), daemon=True)
        for shard in range(cfg["drivers"])
    ]
    start = time.monotonic()
    for p in procs:
        p.start()
    merged = DriverStats()
    failures = []
    per_shard = {}
    window = []
    launches: dict = {}
    for shard, stats, err in _collect(procs, queue):
        if err is not None:
            failures.append(f"driver {shard}: {err}")
        else:
            per_shard[shard] = stats
            if "replay_start" in stats:
                window.append((stats["replay_start"], stats["replay_end"]))
            for k, v in stats["launches"].items():
                launches[k] = launches.get(k, 0) + v
            partial = DriverStats(
                **{
                    k: v
                    for k, v in stats.items()
                    if k not in ("accepted_per_s", "replay_start", "replay_end", "launches",
                                 "forge_s")
                }
            )
            merged.merge(partial)
            stats["post_s"] = _post_quantiles(stats["post_s"])
    for p in procs:
        p.join()
    if failures:
        raise RuntimeError("; ".join(failures))
    # the headline rate is accepted / TIER replay wall: the union of the
    # drivers' replay windows (they overlap), NOT the parent wall — that
    # would fold per-driver forge and set-up time into the REST rate
    if window:
        merged.wall_s = max(t1 for _, t1 in window) - min(t0 for t0, _ in window)
    else:
        merged.wall_s = time.monotonic() - start
    out = merged.to_dict()
    out["post_s"] = _post_quantiles(merged.post_s)
    out["launches"] = launches
    out["total_wall_s"] = round(time.monotonic() - start, 3)
    out["drivers"] = {str(k): per_shard[k] for k in sorted(per_shard)}
    return out


def default_cfg() -> dict:
    """The CLI defaults, importable by harnesses (``tools/loadgen_soak``)."""
    from ..server.settings import LoadgenSettings

    s = LoadgenSettings()
    return {
        "url": "http://127.0.0.1:8080",
        "participants": s.participants,
        "drivers": s.drivers,
        "block_size": s.block_size,
        "tenants": s.tenants,
        "wire": s.wire,
        "dropout_rate": s.dropout_rate,
        "stragglers": s.stragglers,
        "straggle_delay_ms": s.straggle_delay_ms,
        "concurrency": s.concurrency,
        "seed": s.seed,
        "ramp_s": 0.0,
        "model_length": None,
        "key_start": 0,
        "timeout": 30.0,
        "sum_wait_s": 120.0,
        "max_shed_retries": 3,
        "targets": None,
        "shared_round": False,
        "device": "cuda",
    }


def main(argv=None) -> int:
    d = default_cfg()
    ap = argparse.ArgumentParser(
        prog="xaynet_tpu_torch.loadgen.runner",
        description="replay forged PET update traffic against a coordinator",
    )
    ap.add_argument("--url", default=d["url"], help="coordinator base URL")
    ap.add_argument("--participants", type=int, default=d["participants"])
    ap.add_argument("--drivers", type=int, default=d["drivers"])
    ap.add_argument("--block-size", type=int, default=d["block_size"])
    ap.add_argument(
        "--tenants",
        default=d["tenants"],
        help="csv tenant ids; spread across /t/<tenant>/ routes",
    )
    ap.add_argument("--wire", choices=("auto", "packed", "legacy"), default=d["wire"])
    ap.add_argument("--dropout", type=float, default=d["dropout_rate"])
    ap.add_argument("--stragglers", type=int, default=d["stragglers"])
    ap.add_argument(
        "--straggle-delay-ms", type=float, default=d["straggle_delay_ms"]
    )
    ap.add_argument("--ramp-s", type=float, default=d["ramp_s"])
    ap.add_argument("--concurrency", type=int, default=d["concurrency"])
    ap.add_argument("--seed", type=int, default=d["seed"])
    ap.add_argument(
        "--model-length",
        type=int,
        default=None,
        help="override the round's model length (mismatch tests only)",
    )
    ap.add_argument("--key-start", type=int, default=d["key_start"])
    ap.add_argument("--timeout", type=float, default=d["timeout"])
    ap.add_argument("--sum-wait-s", type=float, default=d["sum_wait_s"])
    ap.add_argument(
        "--max-shed-retries",
        type=int,
        default=d["max_shed_retries"],
        help="per-upload 429 retries before abandoning (soaks that must "
        "land every update set this high and let Retry-After pace them)",
    )
    ap.add_argument(
        "--target",
        action="append",
        dest="targets",
        default=None,
        metavar="URL",
        help="explicit target URL (repeatable; e.g. edge-runner endpoints)"
        " — overrides the --url/--tenants expansion",
    )
    ap.add_argument(
        "--shared-round",
        action="store_true",
        help="all targets front the SAME coordinator round (edge fan-in):"
        " one population scalar instead of one round per target",
    )
    ap.add_argument(
        "--device",
        default=d["device"],
        help="torch device the drivers derive the masks on ('cpu' runs the plain versions)",
    )
    args = ap.parse_args(argv)

    cfg = dict(
        d,
        url=args.url,
        participants=args.participants,
        drivers=args.drivers,
        block_size=args.block_size,
        tenants=args.tenants,
        wire=args.wire,
        dropout_rate=args.dropout,
        stragglers=args.stragglers,
        straggle_delay_ms=args.straggle_delay_ms,
        ramp_s=args.ramp_s,
        concurrency=args.concurrency,
        seed=args.seed,
        model_length=args.model_length,
        key_start=args.key_start,
        timeout=args.timeout,
        sum_wait_s=args.sum_wait_s,
        max_shed_retries=args.max_shed_retries,
        targets=args.targets,
        shared_round=args.shared_round,
        device=args.device,
    )
    stats = run(cfg)
    json.dump(stats, sys.stdout, indent=2)
    print()
    return 0 if stats["accepted"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
