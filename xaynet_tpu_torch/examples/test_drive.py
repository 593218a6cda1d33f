"""Test drive: N in-process participants against a coordinator.

Port of ``examples/test_drive.py`` (the analogue of the reference's
test-drive example, rust/examples/test-drive/main.rs): starts this
package's coordinator on ``--device`` and N participants uploading a dummy
model of length ``-l`` (masking on the same device), then runs ``-r``
rounds, printing round progress. Without a card and without ``--device
cpu`` it exits non-zero with ``DeviceUnavailable``.

Run:  python -m xaynet_tpu_torch.examples.test_drive -n 20 -l 1000 -r 3
"""

from __future__ import annotations

import argparse
import sys
import time
from fractions import Fraction

import numpy as np

from ..device import resolve_device
from ..sdk.api import ParticipantABC, spawn_participant
from ..sdk.client import HttpClient
from ..sdk.simulation import keys_for_task
from .coordinator import next_round_seed, round_settings, start_coordinator, sync, wait_for_model


class DummyTrainer(ParticipantABC):
    def __init__(self, length: int):
        self.length = length

    def train_round(self, training_input):
        return np.zeros(self.length, dtype=np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=20, help="participants per round")
    ap.add_argument("-l", type=int, default=1000, help="model length")
    ap.add_argument("-r", type=int, default=3, help="rounds")
    ap.add_argument("--url", default=None,
                    help="drive an EXISTING coordinator (e.g. the docker-compose stack) "
                         "instead of starting one in-process; -l and -n must match its config")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the coordinator's fold and the participants' masking")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n_sum = max(1, args.n // 10)
    n_update = max(3, args.n - n_sum)
    url = args.url or start_coordinator(
        round_settings(0.3, 0.6, n_sum, n_update, 60, args.l), device
    )
    probe = HttpClient(url)
    print(f"coordinator at {url}: {n_sum} sum + {n_update} update participants/round")

    last_seed = None
    threads = []  # participants stay alive across rounds (roles re-draw)
    try:
        for round_no in range(1, args.r + 1):
            t0 = time.time()
            seed = next_round_seed(probe, last_seed)
            params = sync(probe.get_round_params())
            for i in range(n_sum):
                keys = keys_for_task(seed, params.sum, params.update, "sum", start=i * 1000)
                threads.append(spawn_participant(url, DummyTrainer, args=(args.l,), keys=keys,
                                                 device=device))  # fmt: skip
            for i in range(n_update):
                keys = keys_for_task(seed, params.sum, params.update, "update",
                                     start=(1000 + i) * 1000)  # fmt: skip
                threads.append(spawn_participant(
                    url, DummyTrainer, args=(args.l,), scalar=Fraction(1, n_update), keys=keys,
                    device=device,
                ))  # fmt: skip
            model = wait_for_model(probe, seed, timeout=600)
            last_seed = seed  # the completed round; the next loop uses the new seed
            print(f"round {round_no}: completed in {time.time() - t0:.1f}s "
                  f"(model norm {float(np.linalg.norm(model)):.3f})")  # fmt: skip
    finally:
        for t in threads:
            t.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
