"""Coordinator-ingress soak: the loadgen against the port's coordinator.

Port of ``tools/loadgen_soak.py``. Boots the port's coordinator CLI
(``python -m xaynet_tpu_torch.server.runner -c <cfg> --device D``) in a
subprocess, drives the sum leg with a real ``Participant``, then replays
a forged population through the process-sharded loadgen driver tier
(``xaynet_tpu_torch.loadgen.runner``) over real REST — packed (wire v2)
by default — and reports accepted updates/s at the REST boundary plus the
staging bytes moved per accepted update, read off ``/metrics``
(``xaynet_bytes_staged_total``). Everything reaching a device runs on
``--device`` (default ``cuda``; ``cpu`` runs the plain versions).

Legs (one JSON result each, combined into one line on stdout):

- **headline** — one loadgen-driven round at ``--participants`` across
  ``--drivers`` processes (optionally spread over ``--tenants`` routes or
  ``--edges`` two-tier fan-in, ``python -m xaynet_tpu_torch.edge.runner``);
  asserts every update landed.
- **identity** (``--identity``) — a small loadgen(packed) round followed
  by a flood-driven (legacy wire v1) control round with the same
  weights/scalar: the two global models must be byte-identical.
- **legacy control** (``--legacy-control N``) — reboots the coordinator
  in the pre-v2 shape (legacy wire, host parse, unpacked uint32 staging)
  and replays N updates; the packed headline must move STRICTLY fewer
  bytes per accepted update.

The JAX tool's ``--append-history`` (rows for ``BENCH_HISTORY.jsonl``) is
not carried over: the port's benchmark is ROADMAP Queue 1 item 15.

Usage:
  python -m xaynet_tpu_torch.tools.loadgen_soak --participants 2000 --drivers 2 \
      --identity --legacy-control 400
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from fractions import Fraction
from urllib.request import urlopen

# the checkout holding the package: the coordinator and edge subprocesses
# import it from there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG = """
[api]
bind_address = "127.0.0.1:{port}"

[pet.sum]
prob = 0.5
[pet.sum.count]
min = 1
max = 1
[pet.sum.time]
min = 0.0
max = {phase_max}

[pet.update]
prob = 0.9
[pet.update.count]
min = {update_n}
max = {update_n}
[pet.update.time]
min = 0.0
max = {phase_max}

[pet.sum2.count]
min = 1
max = 1
[pet.sum2.time]
min = 0.0
max = {phase_max}

[mask]
# capacity must cover the round's update count: validate_aggregation
# rejects fold n with TooManyModels once nb_models reaches the config's
# max_nb_models (10^k for m<k>) — the production m3 default caps a round
# at 1e3 updates, far under the soak populations this harness drives
model_type = "{model_type}"

[model]
length = {model_len}

[aggregation]
device = true
batch_size = {agg_batch}
kernel = "auto"
wire_ingest = {wire_ingest}
packed_staging = {packed_staging}

[ingest]
enabled = true
shards = 2
queue_bound = 4096
retry_after_seconds = 0.2
wire_format = "{wire_format}"

[storage]
backend = "filesystem"
model_dir = "{model_dir}"

[log]
filter = "info"
{tenancy}
"""

EDGE_CONFIG = """
[api]
bind_address = "127.0.0.1:{port}"

[edge]
upstream_url = "http://127.0.0.1:{upstream_port}"
edge_id = "{edge_id}"
max_members = {max_members}
linger_s = 0.5
poll_s = 0.1

[log]
filter = "info"
"""


def _model_type(update_n: int) -> str:
    """Smallest catalogue mask capacity that admits ``update_n`` folds."""
    for mt, cap in (("m3", 10**3), ("m6", 10**6), ("m9", 10**9)):
        if update_n <= cap:
            return mt
    return "m12"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_listening(port: int, proc, timeout_s: float = 120.0) -> None:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError("server process exited during startup")
            time.sleep(0.25)
    raise RuntimeError(f"port {port} did not start listening in {timeout_s}s")


def _client(url: str):
    from ..sdk.client import HttpClient

    return HttpClient(url, keep_alive=False)


def _fetch_params(url: str):
    return asyncio.run(_client(url).get_round_params())


def _fetch_sums(url: str):
    return asyncio.run(_client(url).get_sums())


def _fetch_model_bytes(url: str):
    import numpy as np

    m = asyncio.run(_client(url).get_model())
    return None if m is None else np.asarray(m, np.float64).tobytes()


def _scrape_json(url: str) -> dict:
    with urlopen(url, timeout=15) as resp:
        return json.loads(resp.read())


def _staged_bytes(base_url: str) -> dict:
    """xaynet_bytes_staged_total by layout, off /metrics."""
    with urlopen(f"{base_url}/metrics", timeout=15) as resp:
        text = resp.read().decode("utf-8", "replace")
    out = {}
    for line in text.splitlines():
        if line.startswith("xaynet_bytes_staged_total{"):
            layout = line.split('layout="', 1)[1].split('"', 1)[0]
            out[layout] = float(line.rsplit(None, 1)[1])
    return out


class RoundDriver:
    """Sum/sum2 leg for one coordinator (or tenant route): a real
    ``Participant`` opens the round, the caller lands the updates, then
    the summer closes sum2 and the round completes."""

    def __init__(self, url: str, n_updates: int, device, poll_s: float = 0.05):
        self.url = url
        self.n = n_updates
        self.device = device
        self.poll_s = poll_s

    def open_round(self):
        from ..sdk.participant import Participant
        from ..sdk.simulation import keys_for_task

        last = None
        while True:
            params = _fetch_params(self.url)
            if params.seed.as_bytes() != last:
                break
            time.sleep(0.02)
        seed = params.seed.as_bytes()
        self.params = params
        self.summer = Participant(
            self.url,
            keys=keys_for_task(seed, params.sum, params.update, "sum"),
            scalar=Fraction(1, max(1, self.n)),
            device=self.device,
        )
        for _ in range(600):
            self.summer.tick()
            sums = _fetch_sums(self.url)
            if sums:
                return params, sums
            time.sleep(self.poll_s)
        raise RuntimeError(f"{self.url}: sum dict never appeared")

    def close_round(self, timeout_s: float = 3600.0) -> bytes:
        seed = self.params.seed.as_bytes()
        deadline = time.time() + timeout_s
        try:
            while time.time() < deadline:
                self.summer.tick()
                if _fetch_params(self.url).seed.as_bytes() != seed:
                    model = _fetch_model_bytes(self.url)
                    if model is None:
                        raise RuntimeError(f"{self.url}: round closed without a model")
                    return model
                time.sleep(self.poll_s)
        finally:
            self.summer.close()
        raise RuntimeError(f"{self.url}: round did not complete in {timeout_s}s")


class Coordinator:
    """One coordinator subprocess (plus optional edge tier) from a config."""

    def __init__(self, tmp: str, *, device: str, update_n: int, model_len: int,
                 wire_format: str = "packed", wire_ingest: bool = True,
                 packed_staging: bool = True, agg_batch: int = 32,
                 phase_max: float = 14400.0, tenants: list | None = None,
                 edges: int = 0, edge_members: int = 0, port: int = 0):
        port = port or _free_port()
        self.port = port
        self.url = f"http://127.0.0.1:{port}"
        self.tenants = tenants or []
        self.edge_urls = []
        self._procs = []
        self._logs = []
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
        tenancy = ""
        if self.tenants:
            cfg_dir = os.path.join(tmp, f"tenants-{port}")
            os.makedirs(cfg_dir, exist_ok=True)
            for tid in self.tenants:
                with open(os.path.join(cfg_dir, f"{tid}.toml"), "w") as f:
                    f.write(self._render(
                        tmp, port, update_n, model_len, wire_format,
                        wire_ingest, packed_staging, agg_batch, phase_max,
                        "", suffix=tid,
                    ))
            tenancy = (
                "\n[tenancy]\nenabled = true\n"
                f'tenants = "{",".join(self.tenants)}"\n'
                f'config_dir = "{cfg_dir}"\n'
            )
        if edges:
            # the coordinator must serve /edge/round + /edge/envelope
            tenancy += "\n[edge]\nenabled = true\n"
        cfg_path = os.path.join(tmp, f"coordinator-{port}.toml")
        with open(cfg_path, "w") as f:
            f.write(self._render(
                tmp, port, update_n, model_len, wire_format, wire_ingest,
                packed_staging, agg_batch, phase_max, tenancy,
            ))
        self.log_path = os.path.join(tmp, f"coordinator-{port}.log")
        log = open(self.log_path, "w")
        self._logs.append(log)
        self._procs.append(subprocess.Popen(
            [sys.executable, "-m", "xaynet_tpu_torch.server.runner", "-c", cfg_path,
             "--device", device],
            env=env, stdout=log, stderr=subprocess.STDOUT))
        _wait_listening(port, self._procs[0])
        for i in range(edges):
            eport = _free_port()
            ecfg = os.path.join(tmp, f"edge-{eport}.toml")
            with open(ecfg, "w") as f:
                f.write(EDGE_CONFIG.format(
                    port=eport, upstream_port=port, edge_id=f"edge-{i}",
                    max_members=edge_members))
            elog = open(os.path.join(tmp, f"edge-{eport}.log"), "w")
            self._logs.append(elog)
            self._procs.append(subprocess.Popen(
                [sys.executable, "-m", "xaynet_tpu_torch.edge.runner", "-c", ecfg],
                env=env, stdout=elog, stderr=subprocess.STDOUT))
            _wait_listening(eport, self._procs[-1])
            self.edge_urls.append(f"http://127.0.0.1:{eport}")

    @staticmethod
    def _render(tmp, port, update_n, model_len, wire_format, wire_ingest,
                packed_staging, agg_batch, phase_max, tenancy, suffix="base"):
        return CONFIG.format(
            port=port, update_n=update_n, model_len=model_len,
            model_type=_model_type(update_n),
            wire_format=wire_format,
            wire_ingest="true" if wire_ingest else "false",
            packed_staging="true" if packed_staging else "false",
            agg_batch=agg_batch, phase_max=phase_max,
            model_dir=os.path.join(tmp, f"models-{port}-{suffix}"),
            tenancy=tenancy,
        )

    def stop(self) -> None:
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
        for log in self._logs:
            log.close()

    def log_tail(self, n: int = 3000) -> str:
        try:
            with open(self.log_path) as f:
                return f.read()[-n:]
        except OSError:
            return ""


def run_loadgen_round(coord: Coordinator, cfg: dict, close_timeout: float):
    """One full loadgen-driven round: open every target round, replay the
    tier, close every round. Returns (runner stats, {url: model bytes})."""
    import threading

    from ..loadgen import runner as lg_runner

    if coord.tenants:
        routes = [f"{coord.url}/t/{t}" for t in coord.tenants]
    else:
        routes = [coord.url]
    per_route = [
        len(range(i, cfg["participants"], len(routes))) for i in range(len(routes))
    ]
    drivers = [RoundDriver(url, n, cfg["device"]) for url, n in zip(routes, per_route)]
    for d in drivers:
        d.open_round()
    stats = lg_runner.run(cfg)
    models, errs = {}, []

    def close(d):
        try:
            models[d.url] = d.close_round(timeout_s=close_timeout)
        except BaseException as e:  # noqa: BLE001 - join + report below
            errs.append(e)

    threads = [threading.Thread(target=close, args=(d,), daemon=True) for d in drivers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return stats, models


def _loadgen_cfg(url: str, device: str, **over) -> dict:
    from ..loadgen import runner as lg_runner

    cfg = lg_runner.default_cfg()
    cfg.update(url=url, device=device, sum_wait_s=300.0,
               # a soak must land EVERY update: shed uploads keep retrying and
               # Retry-After paces them against the intake queues
               max_shed_retries=1_000_000)  # fmt: skip
    cfg.update(over)
    return cfg


def leg_headline(tmp: str, args) -> dict:
    tenants = [f"t{i}" for i in range(args.tenants)] if args.tenants else []
    coord = Coordinator(
        tmp, device=args.device, port=args.port,
        # per-tenant rounds each see their own slice of the population
        update_n=(
            len(range(0, args.participants, max(1, len(tenants))))
            if tenants else args.participants
        ),
        model_len=args.model_len, wire_format=args.wire,
        tenants=tenants, edges=args.edges,
        edge_members=max(1, args.participants // max(1, args.edges))
        if args.edges else 0,
    )
    try:
        cfg = _loadgen_cfg(
            coord.url, args.device, participants=args.participants, drivers=args.drivers,
            tenants=",".join(tenants), wire="auto", seed=args.seed,
            block_size=args.block_size, concurrency=args.concurrency,
            sum_wait_s=600.0, timeout=120.0,
        )
        if args.edges:
            cfg["targets"] = coord.edge_urls
            cfg["shared_round"] = True
        stats, models = run_loadgen_round(coord, cfg, args.close_timeout)
        assert stats["accepted"] == args.participants, stats
        health = _scrape_json(f"{coord.url}/healthz")
        staged = _staged_bytes(coord.url)
        ingress = health.get("ingress")
        if ingress is None and tenants:
            ingress = _scrape_json(f"{coord.url}/t/{tenants[0]}/healthz").get("ingress")
        with urlopen(f"{coord.url}/statusz", timeout=15) as resp:
            statusz_ok = resp.status == 200 and b"ingress" in resp.read().lower()
        wire_layout = "wire-planar" if args.wire == "packed" else "wire"
        return {
            "participants": args.participants,
            "drivers": args.drivers,
            "tenants": len(tenants),
            "edges": args.edges,
            "wire": args.wire,
            "model_len": args.model_len,
            "accepted": stats["accepted"],
            "accepted_per_s": stats["accepted_per_s"],
            "replay_wall_s": stats["wall_s"],
            "total_wall_s": stats["total_wall_s"],
            "shed": stats["shed"],
            "errors": stats["errors"],
            "bytes_staged": staged,
            "bytes_per_accepted": (
                round(staged.get(wire_layout, 0.0) / stats["accepted"], 1)
                if stats["accepted"] else None
            ),
            "ingress": ingress,
            "statusz_ingress": statusz_ok,
            "models": {u: len(m) for u, m in models.items()},
        }
    finally:
        coord.stop()


def leg_identity(tmp: str, args) -> dict:
    """loadgen(packed) round vs flood(legacy) control round with identical
    weights/scalar: byte-identical models."""
    from ..loadgen import runner as lg_runner
    from ..sdk.simulation import build_update_message, flood, keys_for_task

    n = args.identity_n
    coord = Coordinator(tmp, device=args.device, update_n=n, model_len=args.model_len,
                        wire_format="packed", phase_max=1800.0)  # fmt: skip
    try:
        cfg = _loadgen_cfg(coord.url, args.device, participants=n, drivers=2, wire="auto",
                           seed=args.seed, block_size=min(64, n))  # fmt: skip
        stats, models = run_loadgen_round(coord, cfg, args.close_timeout)
        assert stats["accepted"] == n, stats
        model_loadgen = models[coord.url]

        # ground truth: the exact weights the driver shards forged
        _, weights, _ = lg_runner.ground_truth(dict(cfg, model_length=args.model_len))

        driver = RoundDriver(coord.url, n, args.device)
        params, sums = driver.open_round()
        seed = params.seed.as_bytes()
        keys = [
            keys_for_task(seed, params.sum, params.update, "update", start=i * 100_000)
            for i in range(n)
        ]

        async def control():
            from ..sdk.client import HttpClient

            client = HttpClient(coord.url)

            async def submit(blob: bytes) -> None:
                await client.send_message(blob)

            try:
                return await flood(
                    submit, params, sums, n,
                    build=lambda i: build_update_message(
                        params, keys[i], sums, weights[i], Fraction(1, n), wire_planar=False),
                )
            finally:
                client.close()

        fstats = asyncio.run(control())
        assert fstats.accepted == n, fstats
        model_control = driver.close_round(timeout_s=args.close_timeout)
        if model_loadgen != model_control:
            raise RuntimeError(
                "identity leg FAILED: loadgen round is not byte-identical "
                "to the flood control round"
            )
        return {
            "participants": n,
            "model_len": args.model_len,
            "byte_identical": True,
            "model_bytes": len(model_loadgen),
        }
    finally:
        coord.stop()


def leg_legacy_control(tmp: str, args) -> dict:
    """The pre-v2 shape: legacy wire, host parse, unpacked uint32 staging.
    Pins the denominator of the bytes-moved comparison."""
    n = args.legacy_control
    coord = Coordinator(tmp, device=args.device, update_n=n, model_len=args.model_len,
                        wire_format="legacy", wire_ingest=False,
                        packed_staging=False, phase_max=3600.0)  # fmt: skip
    try:
        cfg = _loadgen_cfg(coord.url, args.device, participants=n, drivers=1, wire="legacy",
                           seed=args.seed, block_size=min(128, n))  # fmt: skip
        stats, _ = run_loadgen_round(coord, cfg, args.close_timeout)
        assert stats["accepted"] == n, stats
        staged = _staged_bytes(coord.url)
        return {
            "participants": n,
            "accepted_per_s": stats["accepted_per_s"],
            "bytes_staged": staged,
            "bytes_per_accepted": (
                round(staged.get("unpacked", 0.0) / n, 1) if n else None
            ),
        }
    finally:
        coord.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--participants", type=int, default=2000)
    ap.add_argument("--drivers", type=int, default=2)
    ap.add_argument("--tenants", type=int, default=0)
    ap.add_argument("--edges", type=int, default=0)
    ap.add_argument("--model-len", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=512)
    ap.add_argument("--concurrency", type=int, default=64)
    ap.add_argument("--wire", choices=("packed", "legacy"), default="packed")
    ap.add_argument("--seed", type=int, default=20260806)
    ap.add_argument("--port", type=int, default=0,
                    help="the headline coordinator's port (0: a free one)")
    ap.add_argument("--identity", action="store_true")
    ap.add_argument("--identity-n", type=int, default=12)
    ap.add_argument("--legacy-control", type=int, default=0, metavar="N")
    ap.add_argument("--close-timeout", type=float, default=7200.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the coordinators, the drivers and the summers")
    args = ap.parse_args(argv)
    if args.tenants and args.edges:
        ap.error("--tenants and --edges are separate topologies")
    from ..device import resolve_device

    resolve_device(args.device)  # no card, no soak: refuse before anything starts

    result = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if args.identity:
            result["identity"] = leg_identity(tmp, args)
            print(json.dumps({"identity": result["identity"]}), file=sys.stderr)
        result["headline"] = leg_headline(tmp, args)
        print(json.dumps({"headline": result["headline"]}), file=sys.stderr)
        if args.legacy_control:
            result["legacy_control"] = leg_legacy_control(tmp, args)
            packed_bpa = result["headline"]["bytes_per_accepted"]
            legacy_bpa = result["legacy_control"]["bytes_per_accepted"]
            if args.wire == "packed" and not (packed_bpa < legacy_bpa):
                raise RuntimeError(
                    f"packed path must move strictly fewer staging bytes per "
                    f"accepted update: packed={packed_bpa} legacy={legacy_bpa}"
                )
            result["packed_vs_legacy_bytes"] = {
                "packed": packed_bpa,
                "legacy": legacy_bpa,
                "strictly_fewer": packed_bpa < legacy_bpa,
            }
    result["wall_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
