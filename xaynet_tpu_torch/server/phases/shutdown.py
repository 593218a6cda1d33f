"""Shutdown phase: close and drain the request channel.

Reference behavior
(rust/xaynet-server/src/state_machine/phases/shutdown.rs:23-33).
"""

from __future__ import annotations

from ..events import PhaseName
from ..requests import ChannelClosed, RequestError
from .base import PhaseState


class Shutdown(PhaseState):
    NAME = PhaseName.SHUTDOWN

    async def process(self) -> None:
        rx = self.shared.request_rx
        rx.close()
        while True:
            try:
                env = rx.try_recv()
            except ChannelClosed:
                break
            if env is None:
                break
            self._respond(env, RequestError(RequestError.Kind.INTERNAL, "shutting down"))

    async def run_phase(self):
        self._announce()
        await self.process()
        return None
