"""The port's elastic tenant lifecycle (``xaynet_tpu_torch.tenancy.lifecycle``
and the ``/admin/tenants`` surface of its ``RestServer``) against the JAX
package's, on the CPU.

Each case runs one script of events, the ones ``tests/test_lifecycle.py``
drives, against both packages' ``TenantLifecycle`` (with fakes and an
injectable clock, so no case sleeps through a drain budget or a quarantine
reset) and records what each step observes: lifecycle states, admission
verdicts, scheduler demotions, weights and tiers, drain outcomes, errors by
class name and admin status codes (401, 400, 409, 404). The two records
must be equal.
"""

from __future__ import annotations

import asyncio
import json
import types
from types import SimpleNamespace

import pytest

import xaynet_tpu.server.rest as jax_rest
import xaynet_tpu.server.settings as jax_settings
import xaynet_tpu.tenancy.lifecycle as jax_lifecycle
import xaynet_tpu.tenancy.registry as jax_registry
import xaynet_tpu.tenancy.scheduler as jax_scheduler
import xaynet_tpu_torch.server.rest as port_rest
import xaynet_tpu_torch.server.settings as port_settings
import xaynet_tpu_torch.tenancy.lifecycle as port_lifecycle
import xaynet_tpu_torch.tenancy.registry as port_registry
import xaynet_tpu_torch.tenancy.scheduler as port_scheduler

PACKAGES = {
    "jax": SimpleNamespace(lc=jax_lifecycle, reg=jax_registry, sched=jax_scheduler,
                           rest=jax_rest, settings=jax_settings),
    "port": SimpleNamespace(lc=port_lifecycle, reg=port_registry, sched=port_scheduler,
                            rest=port_rest, settings=port_settings),
}  # fmt: skip
TOKEN = "test-admin-token"


class _Clock:
    def __init__(self, start: float = 1000.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def _lifecycle(pkg, builder=None, budget=None, **overrides):
    settings = dict(enabled=True, admin_token=TOKEN, drain_timeout_s=5.0,
                    quarantine_failures=2, quarantine_reset_s=30.0)  # fmt: skip
    settings.update(overrides)
    clock = _Clock()
    registry = pkg.reg.TenantRegistry()
    routes: dict = {}
    lc = pkg.lc.TenantLifecycle(pkg.settings.TenancySettings(**settings), registry, routes,
                                budget=budget, builder=builder, clock=clock)  # fmt: skip
    return lc, clock, registry, routes


def _outcome(fn):
    """``fn()``'s value, or the class name of what it raised."""
    try:
        return fn()
    except Exception as err:  # the record compares classes by name
        return ("raised", type(err).__name__)


async def _aoutcome(coro):
    try:
        return await coro
    except Exception as err:
        return ("raised", type(err).__name__)


def _demoted(pkg, tenant: str) -> bool:
    return tenant in pkg.sched.get_scheduler().demoted()


# -- the scripts -------------------------------------------------------------


def script_quarantine(pkg) -> list:
    """Trip, shed, ignore outcomes while open, probe, re-open, lift."""
    lc, clock, _, _ = _lifecycle(pkg)
    lc.mark_serving("q1")
    trace = [lc.state("q1")]
    for event in ("fail", "fail", "fail", "complete", "probe", "fail", "probe", "complete"):
        if event == "fail":
            lc.note_round_failed("q1")
        elif event == "complete":
            lc.note_round_completed("q1")
        else:
            clock.advance(31.0)
        trace.append((event, lc.state("q1"), lc.admit("q1"), _demoted(pkg, "q1"),
                      lc.breaker("q1").state))  # fmt: skip
    pkg.sched.get_scheduler().forget_tenant("q1")
    return trace


def script_slo(pkg) -> list:
    lc, _, _, _ = _lifecycle(pkg)
    lc.mark_serving("s1")
    trace = []
    for tenant, slo, severity in (("s1", "round_wall", "page"), ("s1", "ingest", "page"),
                                  ("s1", "round_wall", "warn"), ("s1", "ingest", "ok"),
                                  ("ghost", "round_wall", "page")):  # fmt: skip
        lc.slo_transition(tenant, slo, severity)
        trace.append((tenant, slo, severity, _demoted(pkg, "s1"), _demoted(pkg, "ghost")))
    engine = types.SimpleNamespace(hook=None)
    engine.set_transition_hook = lambda hook: setattr(engine, "hook", hook)
    lc.install_slo_hook(engine)
    trace.append(engine.hook == lc.slo_transition)
    pkg.sched.get_scheduler().forget_tenant("s1")
    return trace


def script_weights_tiers(pkg) -> list:
    lc, _, _, _ = _lifecycle(pkg, weights="w1=2.5,w2=0.5", tiers="w1=1")
    sched = pkg.sched.get_scheduler()
    trace = []
    for tenant in ("w1", "w2", "w3"):
        lc.mark_serving(tenant)
        trace.append((tenant, sched._weights.get(tenant), sched._tiers.get(tenant)))
    for tenant in ("w1", "w2", "w3"):
        sched.forget_tenant(tenant)
    return trace


def script_reconfigure(pkg) -> list:
    lc, _, _, _ = _lifecycle(pkg)
    trace = [_outcome(lambda: lc.reconfigure("nobody", weight=2.0))]
    lc.mark_serving("r1")
    trace.append(_outcome(lambda: lc.reconfigure("r1", weight=2.0, tier=1)))
    trace.append(_outcome(lambda: lc.reconfigure("r1", weight=0.0)))
    trace.append(_outcome(lambda: lc.reconfigure("r1", tier=3)))
    sched = pkg.sched.get_scheduler()
    trace.append((sched._weights.get("r1"), sched._tiers.get("r1")))
    sched.forget_tenant("r1")
    return trace


def script_drain_graceful(pkg) -> list:
    async def run():
        lc, _, registry, routes = _lifecycle(pkg)
        ctx = pkg.reg.TenantContext(tenant="d1", settings=None)
        registry.add(ctx)
        ctx.task = asyncio.create_task(asyncio.sleep(3600))
        routes["d1"] = object()
        lc.mark_serving("d1")
        verdicts = []

        async def close_round():
            await asyncio.sleep(0.12)
            verdicts.append((lc.state("d1"), lc.admit("d1")))
            lc.note_round_completed("d1")  # the in-flight round's boundary

        closer = asyncio.create_task(close_round())
        result = await lc.offboard("d1")
        await closer
        again = await _aoutcome(lc.offboard("d1"))
        return [verdicts, result, lc.state("d1"), "d1" in routes, registry.get("d1") is None,
                ctx.task.cancelled(), again]  # fmt: skip

    return asyncio.run(run())


def script_drain_timeout(pkg) -> list:
    async def run():
        class Budget:
            def __init__(self):
                self.discharged = []

            def held(self, tenant):
                return 3

            def discharge(self, tenant, amount):
                self.discharged.append((tenant, amount))

        budget = Budget()
        lc, clock, registry, routes = _lifecycle(pkg, budget=budget, drain_timeout_s=1.0)
        closed = []
        ctx = pkg.reg.TenantContext(
            tenant="d2",
            settings=None,
            request_tx=types.SimpleNamespace(close=lambda: closed.append("tx")),
            metrics=types.SimpleNamespace(close=lambda: closed.append("metrics")),
        )
        registry.add(ctx)
        ctx.task = asyncio.create_task(asyncio.sleep(3600))
        routes["d2"] = object()
        lc.mark_serving("d2")

        async def burn_the_budget():
            await asyncio.sleep(0.12)
            clock.advance(10.0)  # no boundary ever arrives; the budget expires

        burner = asyncio.create_task(burn_the_budget())
        result = await lc.offboard("d2")
        await burner
        return [result, lc.state("d2"), ctx.task.cancelled(), sorted(closed),
                budget.discharged, "d2" in routes, registry.get("d2") is None]  # fmt: skip

    return asyncio.run(run())


def script_onboard(pkg) -> list:
    async def run():
        cell: dict = {}
        during_build = []

        async def builder(tenant):
            if tenant == "boom":
                raise RuntimeError("builder exploded")
            during_build.append((tenant, cell["lc"].state(tenant), cell["lc"].admit(tenant)))

            async def machine_run():
                return None

            ctx = pkg.reg.TenantContext(tenant=tenant, settings=None,
                                        machine=types.SimpleNamespace(run=machine_run))
            cell["registry"].add(ctx)
            return ctx, ("routes", tenant)

        lc, _, registry, routes = _lifecycle(pkg, builder=builder)
        cell["lc"], cell["registry"] = lc, registry
        trace = []
        for tenant in ("n1", "n1", "NOT A VALID ID", "boom", "boom2"):
            result = await _aoutcome(lc.onboard(tenant))
            if isinstance(result, dict):
                result = {k: v for k, v in result.items() if k != "onboard_s"}
            trace.append((tenant, result, lc.state(tenant), sorted(lc.states().items()),
                          sorted(routes)))  # fmt: skip
        for tenant in ("n1", "boom2"):
            await asyncio.sleep(0)  # the machines return at once
            trace.append(await _aoutcome(lc.offboard(tenant)))
        trace.append(during_build)
        nobuilder, _, _, _ = _lifecycle(pkg, builder=None)
        trace.append(await _aoutcome(nobuilder.onboard("n2")))
        for tenant in ("n1", "boom2"):
            pkg.sched.get_scheduler().forget_tenant(tenant)
        return trace

    return asyncio.run(run())


def script_forwarders(pkg) -> list:
    previous = pkg.lc.get_manager()
    pkg.lc.install_manager(None)
    trace = [_outcome(lambda: pkg.lc.note_round_failed("nobody")),
             _outcome(lambda: pkg.lc.note_round_completed("nobody"))]  # fmt: skip
    lc, _, _, _ = _lifecycle(pkg)
    lc.mark_serving("fw")
    pkg.lc.install_manager(lc)
    try:
        trace.append(pkg.lc.get_manager() is lc)
        pkg.lc.note_round_failed("fw")
        trace.append((lc.breaker("fw")._failures, lc.state("fw")))
        pkg.lc.note_round_completed("fw")
        trace.append((lc.breaker("fw")._failures, lc.state("fw")))
    finally:
        pkg.lc.install_manager(previous)
        pkg.sched.get_scheduler().forget_tenant("fw")
    return trace


def script_admin_disabled(pkg) -> list:
    lc, _, _, _ = _lifecycle(pkg)
    no_lc = pkg.rest.RestServer(fetcher=None, handler=None, admin_token="x")
    no_token = pkg.rest.RestServer(fetcher=None, handler=None, lifecycle=lc, admin_token="")
    auth = {"x-admin-token": "x"}
    return [asyncio.run(server._admin_route("GET", "/admin/tenants", b"", auth))[0]
            for server in (no_lc, no_token)]  # fmt: skip


def script_admin(pkg) -> list:
    async def run():
        async def builder(tenant):
            async def machine_run():
                return None

            ctx = pkg.reg.TenantContext(tenant=tenant, settings=None,
                                        machine=types.SimpleNamespace(run=machine_run))
            return ctx, ("routes", tenant)

        lc, _, _, routes = _lifecycle(pkg, builder=builder)
        server = pkg.rest.RestServer(fetcher=None, handler=None, lifecycle=lc, admin_token=TOKEN)
        auth = {"x-admin-token": TOKEN}
        calls = [
            ("GET", "/admin/tenants", b"", {}),
            ("GET", "/admin/tenants", b"", {"x-admin-token": "nope"}),
            ("POST", "/admin/tenants", json.dumps({"tenant": "rt1"}).encode(), auth),
            ("GET", "/admin/tenants", b"", auth),
            ("POST", "/admin/tenants/rt1", json.dumps({"weight": 2.0}).encode(), auth),
            ("PATCH", "/admin/tenants/rt1", json.dumps({"tier": 1}).encode(), auth),
            ("POST", "/admin/tenants", json.dumps({"tenant": "BAD ID"}).encode(), auth),
            ("POST", "/admin/tenants", b"{not json", auth),
            ("POST", "/admin/tenants", json.dumps({"tenant": "rt1"}).encode(), auth),
            ("POST", "/admin/tenants/ghost", b"{}", auth),
            ("DELETE", "/admin/tenants", b"", auth),
            ("PUT", "/admin/tenants/rt1", b"", auth),
            ("DELETE", "/admin/tenants/rt1", b"", auth),
            ("DELETE", "/admin/tenants/rt1", b"", auth),
            ("GET", "/admin/tenants", b"", auth),
        ]
        trace = []
        for method, path, body, headers in calls:
            status, payload, ctype, extra = await server._admin_route(method, path, body, headers)
            if ctype == "application/json":
                payload = {k: v for k, v in json.loads(payload).items() if k != "onboard_s"}
            else:
                payload = None  # error texts name each package's own classes
            trace.append((method, path, status, payload, extra, sorted(routes)))
        # through the router too: the admin paths never reach a tenant route
        status, _, _, _ = await server._route("GET", "/admin/tenants", b"", {})
        trace.append(status)
        pkg.sched.get_scheduler().forget_tenant("rt1")
        return trace

    return asyncio.run(run())


def script_route_429(pkg) -> list:
    async def run():
        class FakeLifecycle:
            def __init__(self):
                self.admit_calls = []

            def admit(self, tenant):
                self.admit_calls.append(tenant)
                return (False, 7.5) if tenant in ("dq", "t9") else (False, None)

        lifecycle = FakeLifecycle()
        server = pkg.rest.RestServer(fetcher=None, handler=None, lifecycle=lifecycle,
                                     admin_token="x", default_tenant="dq")  # fmt: skip
        trace = []
        status, _, _, extra = await server._route("POST", "/message", b"", {})
        trace.append((status, extra, list(lifecycle.admit_calls)))
        lifecycle.admit_calls.clear()
        status, _, _, _ = await server._route("GET", "/params", b"", {})
        trace.append((status == 429, list(lifecycle.admit_calls)))
        status, _, _, _ = await server._route("POST", "/t/t9/message", b"", {})
        trace.append((status, list(lifecycle.admit_calls)))  # unknown tenant: 404 first
        return trace

    return asyncio.run(run())


SCRIPTS = {
    "quarantine": script_quarantine,
    "slo-demotion": script_slo,
    "weights-tiers": script_weights_tiers,
    "reconfigure": script_reconfigure,
    "drain-graceful": script_drain_graceful,
    "drain-timeout": script_drain_timeout,
    "onboard": script_onboard,
    "forwarders": script_forwarders,
    "admin-disabled": script_admin_disabled,
    "admin": script_admin,
    "route-429": script_route_429,
}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_lifecycle_matches_jax(case):
    records = {name: SCRIPTS[case](pkg) for name, pkg in PACKAGES.items()}
    assert records["port"] == records["jax"]


def test_lifecycle_records_hold_the_designed_states():
    """The port's records themselves: the states the design names, so equal
    records cannot both be wrong the same way unnoticed."""
    port = PACKAGES["port"]
    quarantine = script_quarantine(port)
    assert quarantine[0] == "serving"
    assert [step[1] for step in quarantine[1:]] == [
        "serving", "quarantined", "quarantined", "quarantined", "quarantined",
        "quarantined", "quarantined", "serving",
    ]  # fmt: skip
    assert quarantine[2][2] == (False, 30.0) and quarantine[2][3] is True
    admin = script_admin(port)
    assert [step[2] for step in admin[:-1]] == [401, 401, 200, 200, 200, 200, 400, 400, 409,
                                                409, 404, 404, 200, 409, 200]  # fmt: skip
    assert admin[12][3]["outcome"] == "graceful" and admin[-1] == 401
    assert script_admin_disabled(port) == [404, 404]
    assert script_route_429(port)[0] == (429, {"Retry-After": "8"}, ["dq"])
    timeout = script_drain_timeout(port)
    assert timeout[0]["outcome"] == "timeout" and timeout[3] == ["metrics", "tx"]
