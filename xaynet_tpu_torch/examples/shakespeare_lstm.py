"""Baseline config #3: federated char-LSTM next-token (LEAF-Shakespeare shaped).

Port of ``examples/shakespeare_lstm.py``. 1k-participant-scale config with
a bounded M3 mask; this simulation drives a scaled-down round (pass
--participants to widen), training on ``--device``. Character sequences
are synthesized with per-participant distributions standing in for the
LEAF shards.

Run:  python -m xaynet_tpu_torch.examples.shakespeare_lstm [--rounds 1] [--participants 8]
"""

from __future__ import annotations

import argparse
import time
from fractions import Fraction

import numpy as np
import torch

from ..device import resolve_device
from ..models import lstm
from ..models.federated import FederatedTrainer, model_length
from ..sdk.api import spawn_participant
from ..sdk.client import HttpClient
from ..sdk.simulation import keys_for_task
from .coordinator import next_round_seed, round_settings, start_coordinator, wait_for_model

SEQ_LEN = 40
HIDDEN = 64


def synthetic_shards(seed: int, n: int = 64, seq_len: int = SEQ_LEN):
    """Per-participant character streams with distinct symbol biases."""
    rng = np.random.default_rng(seed)
    bias = rng.dirichlet(np.ones(lstm.VOCAB_SIZE) * 0.3)
    tokens = rng.choice(lstm.VOCAB_SIZE, size=(n, seq_len + 1), p=bias).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--participants", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=HIDDEN)
    ap.add_argument("--seq-len", type=int, default=SEQ_LEN)
    ap.add_argument("--check-loss", action="store_true",
                    help="exit nonzero unless the final global model beats the init loss")
    ap.add_argument("--epochs", type=int, default=1, help="local epochs per round")
    ap.add_argument("--lr", type=float, default=1e-3, help="local Adam learning rate")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the coordinator, the masking and the training")
    args = ap.parse_args()
    device = resolve_device(args.device)

    hidden, seq_len = args.hidden, args.seq_len

    def init_module():
        return lstm.init_params(torch.Generator().manual_seed(1), hidden=hidden, device=device)

    model_len = model_length(init_module())
    n_sum, n_update = 1, max(3, args.participants - 1)
    print(f"char-LSTM: {model_len} parameters (bounded M3 mask config)")

    url = start_coordinator(round_settings(0.2, 0.5, n_sum, n_update, 300, model_len), device)
    probe = HttpClient(url)

    shared_step = lstm.make_train_step(learning_rate=args.lr)
    threads = []
    last_seed = None
    for round_no in range(1, args.rounds + 1):
        t0 = time.time()
        seed = next_round_seed(probe, last_seed)

        def kwargs(i):
            return dict(
                init_params_fn=init_module,
                make_step=lambda: shared_step,
                data=synthetic_shards(i, seq_len=seq_len),
                epochs=args.epochs,
                batch_size=16,
                device=device,
            )

        for i in range(n_sum):
            threads.append(
                spawn_participant(
                    url, FederatedTrainer, kwargs=kwargs(900 + i),
                    keys=keys_for_task(seed, 0.2, 0.5, "sum", start=i * 1000), device=device,
                )
            )  # fmt: skip
        for i in range(n_update):
            threads.append(
                spawn_participant(
                    url, FederatedTrainer, kwargs=kwargs(i), scalar=Fraction(1, n_update),
                    keys=keys_for_task(seed, 0.2, 0.5, "update", start=(500 + i) * 1000),
                    device=device,
                )
            )  # fmt: skip

        model = wait_for_model(probe, seed)
        last_seed = seed
        print(f"round {round_no}: completed in {time.time() - t0:.1f}s "
              f"(model norm {float(np.linalg.norm(model)):.2f})")

    for t in threads:
        t.stop()

    if args.check_loss:
        from .eval_check import require_loss_improved

        loss_fn, _, _ = shared_step
        # the federated average must at least fit the participating shards
        require_loss_improved(
            loss_fn,
            init_module(),
            model,
            [synthetic_shards(i, seq_len=seq_len) for i in range(n_update)],
        )


if __name__ == "__main__":
    main()
