"""Live operator console: the ``GET /statusz`` HTML page (docs/DESIGN.md §20).

The port's copy of ``xaynet_tpu/server/console.py``.

One self-contained page rendered entirely from in-process telemetry state —
the metrics registry, the round-wall timeline (``telemetry.timeline``) and
the SLO engine (``telemetry.slo``) — so an operator gets the coordinator's
live picture from a browser with no scrape pipeline in between:

- per-tenant round/phase state with the recent round-wall **sparkline** and
  the last round's phase decomposition (wall / self time / overlap);
- the shared accumulator pool's page occupancy and per-tenant lease balance
  (multi-tenant deployments, §19);
- coordinator ingress per tenant with an ingest pipeline: accepted and
  shed rates and totals, rejections, intake shard occupancy and the
  accepted wire-format mix (§21);
- the streaming-fold pipeline's overlap ratio, staging depth, in-flight
  folds and degraded state (§15), from the ``xaynet_streaming_*`` gauges
  the port's ``parallel/streaming.py`` sets;
- live SLO burn rates / budget remaining and the recent-alert ring.

Rendering is stdlib-only string assembly (no template engine, and no
torch import: everything here reads gauges, the ingest pipelines'
counters and bounded in-memory rings). ``render_statusz`` and ``alerts_payload`` are
declared taint sinks (§18): the alert entries they serialize were scrubbed
when stored, and every dynamic string is HTML-escaped before it lands in
the page.
"""

from __future__ import annotations

import html
import time

from ..telemetry.slo import SLOS, get_engine
from ..telemetry.timeline import get_timeline

# eight-level unicode sparkline ramp for the recent-wall strip
_SPARK_RAMP = "▁▂▃▄▅▆▇█"

_STYLE = """
body { font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
       margin: 1.5rem; color: #222; background: #fafafa; }
h1 { font-size: 1.2rem; } h2 { font-size: 1rem; margin-top: 1.4rem; }
table { border-collapse: collapse; margin: 0.4rem 0; }
th, td { border: 1px solid #ccc; padding: 0.25rem 0.6rem; text-align: left; }
th { background: #eee; }
.spark { font-size: 1.1rem; letter-spacing: 1px; color: #369; }
.ok { color: #2a7; } .warn { color: #b80; font-weight: bold; }
.page { color: #c22; font-weight: bold; }
.degraded { color: #c22; }
.muted { color: #888; }
"""


def _esc(value) -> str:
    return html.escape(str(value), quote=True)


def _sparkline(walls: list[tuple[int, float]]) -> str:
    """Unicode sparkline over recent (round_id, wall_s) pairs, oldest
    first; scaled to the window's own min/max so shape survives any
    absolute magnitude."""
    values = [w for _, w in walls]
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return _SPARK_RAMP[0] * len(values)
    return "".join(
        _SPARK_RAMP[min(len(_SPARK_RAMP) - 1, int((v - lo) / span * len(_SPARK_RAMP)))]
        for v in values
    )


def _severity_class(severity: str) -> str:
    return severity if severity in ("warn", "page") else "ok"


def _lifecycle_states() -> dict:
    """Tenant lifecycle states for the table column (§23); empty when no
    lifecycle manager is installed (single-tenant deployments)."""
    from ..tenancy.lifecycle import get_manager  # lazy: keeps import cycle out

    manager = get_manager()
    if manager is None:
        return {}
    try:
        return manager.states()
    except Exception:
        return {}


def _tenant_rows(server) -> str:
    """Per-tenant state table rows: lifecycle, phase, round, last wall +
    sparkline, degraded flag and the three SLO burn rates."""
    timeline = get_timeline()
    engine = get_engine()
    lifecycle = _lifecycle_states()
    routes_by_tenant = {"default": server._default_routes, **server.tenants}
    # tenants the timeline folded but the REST layer doesn't route (edge
    # processes, tests driving the fold directly) still get a row
    for tenant in timeline.tenants():
        routes_by_tenant.setdefault(tenant, None)
    rows = []
    for tenant in sorted(routes_by_tenant):
        routes = routes_by_tenant[tenant]
        if routes is not None:
            phase = routes.fetcher.phase().value
            round_id = routes.fetcher.events.params.get_latest().round_id
        else:
            phase, round_id = "-", "-"
        last = timeline.last(tenant)
        walls = timeline.recent_walls(tenant)
        wall = f"{last['wall_s']:.3f}s" if last else "-"
        degraded = (
            '<span class="degraded">degraded</span>'
            if last and last.get("degraded")
            else '<span class="ok">full</span>' if last else "-"
        )
        # cross-phase overlap of the last folded round (docs/DESIGN.md
        # §22): negative slack — the round wall came in under the serial
        # sum of phase walls — is the overlap engine's visible win
        if last:
            ov = last.get("overlap_s", 0.0)
            slack = last.get("wall_s", 0.0) - sum(
                p.get("wall_s", 0.0) for p in last.get("phases", {}).values()
            )
            overlap_cell = "{:.3f}s{}".format(
                ov, " <span class='ok'>(−slack)</span>" if slack < 0 else ""
            )
        else:
            overlap_cell = "-"
        burns = engine.burn_snapshot(tenant)
        burn_cells = "".join(
            "<td>{}</td>".format(
                "{:.2f}x / {:.0%} left".format(
                    burns[slo]["burn_rate"], max(0.0, burns[slo]["budget_remaining"])
                )
                if slo in burns
                else '<span class="muted">-</span>'
            )
            for slo in SLOS
        )
        state = lifecycle.get(tenant, "")
        state_cell = (
            '<span class="{cls}">{st}</span>'.format(
                cls="ok" if state == "serving" else "warn" if state == "onboarding" else "page",
                st=_esc(state),
            )
            if state
            else '<span class="muted">-</span>'
        )
        rows.append(
            "<tr><td>{t}</td><td>{lc}</td><td>{p}</td><td>{r}</td><td>{w}</td>"
            '<td class="spark">{s}</td><td>{o}</td><td>{d}</td>{b}</tr>'.format(
                t=_esc(tenant),
                lc=state_cell,
                p=_esc(phase),
                r=_esc(round_id),
                w=_esc(wall),
                s=_sparkline(walls),
                o=overlap_cell,
                d=degraded,
                b=burn_cells,
            )
        )
    return "\n".join(rows)


def _decomposition_section(tenant: str) -> str:
    """The last folded round's phase decomposition for one tenant."""
    last = get_timeline().last(tenant)
    if not last:
        return ""
    phase_rows = "".join(
        "<tr><td>{p}</td><td>{w:.4f}s</td><td>{s:.4f}s</td></tr>".format(
            p=_esc(phase), w=vals["wall_s"], s=vals["self_s"]
        )
        for phase, vals in last.get("phases", {}).items()
    )
    slow_rows = "".join(
        "<tr><td>{n}</td><td>{d:.4f}s</td></tr>".format(
            n=_esc(entry["span"]), d=entry["seconds"]
        )
        for entry in last.get("slowest", ())
    )
    return (
        "<h2>round {rid} — {tenant}</h2>"
        "<p>wall <b>{wall:.3f}s</b>, overlap {ov:.3f}s "
        "({ratio:.0%}), gap {gap:.3f}s, {spans} spans</p>"
        "<table><tr><th>phase</th><th>wall</th><th>self</th></tr>{rows}</table>"
        "<table><tr><th>slowest span</th><th>seconds</th></tr>{slow}</table>"
    ).format(
        rid=_esc(last["round_id"]),
        tenant=_esc(tenant),
        wall=last["wall_s"],
        ov=last["overlap_s"],
        ratio=last["overlap_ratio"],
        gap=last["gap_s"],
        spans=last["spans"],
        rows=phase_rows,
        slow=slow_rows,
    )


def _pool_section(server) -> str:
    """Accumulator-pool occupancy + per-tenant lease balance (§19); empty
    for single-tenant deployments (no pool to report)."""
    if not server.tenants:
        return ""
    from ..tenancy.pool import get_pool  # lazy: single-tenant paths never pay it

    stats = get_pool().stats()
    leases = stats.get("tenant_leases") or {}
    lease_rows = "".join(
        "<tr><td>{t}</td><td>{n}</td></tr>".format(t=_esc(t), n=_esc(n))
        for t, n in sorted(leases.items())
    )
    occupancy = "".join(
        "<tr><td>{k}</td><td>{v}</td></tr>".format(k=_esc(k), v=_esc(stats[k]))
        for k in (
            "page_bytes",
            "slabs",
            "host_pages_in_use",
            "host_pages_free",
            "device_pages_in_use",
            "fragmentation",
        )
        if k in stats
    )
    return (
        "<h2>accumulator pool</h2>"
        "<table><tr><th>stat</th><th>value</th></tr>{occ}</table>"
        "<table><tr><th>tenant</th><th>pages leased</th></tr>{leases}</table>"
    ).format(occ=occupancy, leases=lease_rows or '<tr><td colspan="2" class="muted">none</td></tr>')


def _streaming_section(server) -> str:
    """Streaming-fold pipeline overlap + degraded shards (§15), from the
    same registry reads as the /healthz section; empty when no streaming
    pipeline ever ran in this process."""
    section = server._streaming_health()
    if section is None:
        return ""
    shards = section.pop("shards", {})
    shard_rows = "".join(
        '<tr><td>{s}</td><td>{o:.2f}</td><td>{d}</td><td>{f}</td></tr>'.format(
            s=_esc(shard),
            o=vals.get("overlap_ratio", 0.0),
            d=_esc(vals.get("staging_depth", 0)),
            f=_esc(vals.get("inflight_folds", 0)),
        )
        for shard, vals in shards.items()
    )
    degraded = (
        '<span class="degraded">degraded</span>'
        if section["degraded"]
        else '<span class="ok">nominal</span>'
    )
    out = (
        "<h2>streaming pipeline</h2>"
        "<p>{deg} — overlap {ov:.2f}, staging depth {depth}, "
        "in-flight folds {folds}</p>"
    ).format(
        deg=degraded,
        ov=section["overlap_ratio"],
        depth=_esc(section["staging_depth"]),
        folds=_esc(section["inflight_folds"]),
    )
    if shard_rows:
        out += (
            "<table><tr><th>shard</th><th>overlap</th><th>staging</th>"
            "<th>in-flight</th></tr>{rows}</table>"
        ).format(rows=shard_rows)
    return out


def _ingress_section(server) -> str:
    """Coordinator-ingress state (§21): per-tenant accepted/shed rates,
    intake shard occupancy and the accepted wire-format mix, read straight
    off each tenant's ingest pipeline; empty when no pipeline is wired
    (direct-handler deployments)."""
    routes_by_tenant = {"default": server._default_routes, **server.tenants}
    rows = []
    for tenant in sorted(routes_by_tenant):
        pipeline = getattr(routes_by_tenant[tenant], "pipeline", None)
        if pipeline is None:
            continue
        stats = pipeline.ingress_stats()
        wire = stats["wire"]
        occupancy = stats["shard_occupancy"]
        rows.append(
            "<tr><td>{t}</td><td>{aps:.1f}/s</td><td>{at}</td>"
            "<td>{sps:.1f}/s</td><td>{st}</td><td>{rt}</td>"
            "<td>{occ}</td><td>{pk} / {lg}</td></tr>".format(
                t=_esc(tenant),
                aps=stats["accepted_per_s"],
                at=_esc(stats["accepted_total"]),
                sps=stats["shed_per_s"],
                st=_esc(stats["shed_total"]),
                rt=_esc(stats["rejected_total"]),
                occ=_esc(" ".join(str(o) for o in occupancy)),
                pk=_esc(wire.get("packed", 0)),
                lg=_esc(wire.get("legacy", 0)),
            )
        )
    if not rows:
        return ""
    return (
        "<h2>ingress</h2>"
        "<table><tr><th>tenant</th><th>accepted/s</th><th>accepted</th>"
        "<th>shed/s</th><th>shed</th><th>rejected</th>"
        "<th>shard occupancy</th><th>wire packed/legacy</th></tr>"
        "{rows}</table>".format(rows="".join(rows))
    )


def _alerts_section() -> str:
    """Active alerts banner + the recent-transition ring, newest first."""
    engine = get_engine()
    active = engine.active_alerts()
    banner = (
        "".join(
            '<p class="{cls}">FIRING: tenant {t} {slo} — {sev}</p>'.format(
                cls=_severity_class(a["severity"]),
                t=_esc(a["tenant"]),
                slo=_esc(a["slo"]),
                sev=_esc(a["severity"]),
            )
            for a in active
        )
        or '<p class="ok">no active alerts</p>'
    )
    rows = "".join(
        '<tr><td>{ts}</td><td>{t}</td><td>{slo}</td>'
        '<td class="{cls}">{sev}</td><td>{prev}</td><td>{r}</td>'
        "<td>{bf}x</td><td>{bs}x</td></tr>".format(
            ts=_esc(time.strftime("%H:%M:%S", time.localtime(e.get("ts", 0)))),
            t=_esc(e.get("tenant", "")),
            slo=_esc(e.get("slo", "")),
            cls=_severity_class(e.get("severity", "")),
            sev=_esc(e.get("severity", "")),
            prev=_esc(e.get("previous", "")),
            r=_esc(e.get("round_id", "")),
            bf=_esc(e.get("burn_fast", "")),
            bs=_esc(e.get("burn_slow", "")),
        )
        for e in reversed(engine.recent_alerts())
    )
    table = (
        "<table><tr><th>time</th><th>tenant</th><th>slo</th><th>severity</th>"
        "<th>previous</th><th>round</th><th>fast</th><th>slow</th></tr>"
        "{rows}</table>".format(rows=rows)
        if rows
        else '<p class="muted">no transitions recorded</p>'
    )
    return "<h2>alerts</h2>" + banner + table


def render_statusz(server) -> str:
    """Assemble the full ``/statusz`` page from live telemetry state.

    ``server`` is the :class:`..rest.RestServer` — the console reads its
    tenant routing table and reuses its registry-backed health readers;
    everything else comes from the process-wide timeline/SLO singletons.
    Declared as a taint sink (§18): all dynamic content is escaped here
    and alert entries were scrubbed at store time.
    """
    timeline = get_timeline()
    uptime = time.monotonic() - server._started_at
    tenant_labels = sorted({"default", *server.tenants, *timeline.tenants()})
    burn_headers = "".join(f"<th>{_esc(slo)} burn</th>" for slo in SLOS)
    sections = [
        "<h1>xaynet-tpu coordinator</h1>",
        '<p class="muted">uptime {up:.0f}s — {rounds} rounds folded — '
        "generated {ts}</p>".format(
            up=uptime,
            rounds=timeline.rounds_folded(),
            ts=_esc(time.strftime("%Y-%m-%d %H:%M:%S")),
        ),
        _alerts_section(),
        "<h2>tenants</h2>",
        "<table><tr><th>tenant</th><th>lifecycle</th><th>phase</th><th>round</th><th>wall</th>"
        "<th>recent walls</th><th>overlap</th><th>windows</th>{bh}</tr>{rows}</table>".format(
            bh=burn_headers, rows=_tenant_rows(server)
        ),
    ]
    for tenant in tenant_labels:
        sections.append(_decomposition_section(tenant))
    sections.append(_ingress_section(server))
    sections.append(_pool_section(server))
    sections.append(_streaming_section(server))
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>xaynet-tpu statusz</title>"
        f"<style>{_STYLE}</style></head><body>"
        + "".join(s for s in sections if s)
        + "</body></html>"
    )
