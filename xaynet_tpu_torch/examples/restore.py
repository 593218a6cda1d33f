"""Participant save/restore across process boundaries.

Port of ``examples/restore.py`` (the analogue of the reference's restore
example, bindings/python/examples/restore.py): a participant is suspended
(serialized to bytes) mid-protocol and resumed later — the whole state
machine (keys, task signatures, ephemeral keys, round parameters)
survives. The participant is built for ``--device`` (default ``cuda``,
where it would mask); without a card and without ``--device cpu`` it exits
non-zero with ``DeviceUnavailable``.

Run:  python -m xaynet_tpu_torch.examples.restore [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from ..device import resolve_device
from ..sdk.client import InProcessClient
from ..sdk.participant import Participant


class _OfflineClient(InProcessClient):
    """A client with no coordinator behind it (participant stays pending)."""

    def __init__(self):
        pass

    async def get_round_params(self):
        raise RuntimeError("coordinator unreachable")

    async def get_model(self):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device the participant masks on")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    participant = Participant(_OfflineClient(), device=device)
    participant.tick()  # coordinator unreachable -> pending, state intact
    print("task before suspend:", participant.task().value)

    state = participant.save()
    print(f"suspended: {len(state)} bytes of serialized state")

    resumed = Participant.restore(state, _OfflineClient(), device=device)
    resumed.tick()
    print("task after resume:", resumed.task().value)
    if resumed.save() != state:
        print("the resumed participant's state differs from the suspended one")
        return 1
    print("save/restore round-trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
