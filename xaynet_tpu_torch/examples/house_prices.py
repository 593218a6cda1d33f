"""Baseline config #1: federated house-prices regression (MLP, 10 participants).

Port of ``examples/house_prices.py``, the analogue of the reference's
keras_house_prices example (bindings/python/examples/keras_house_prices/):
one coordinator, participants each holding a private shard of the dataset,
training a 2-hidden-layer MLP with federated averaging over the PET
protocol, on ``--device``.

Synthetic data stands in for the Kaggle dataset (zero-egress environment);
swap ``make_data`` for a real loader. ``--check-loss`` (not in the JAX
example) holds the last round's global model to the same gate as the other
examples: its MSE on the union of that round's updaters' shards must beat
the first updater's initial model's.

Run:  python -m xaynet_tpu_torch.examples.house_prices [--check-loss]
"""

from __future__ import annotations

import argparse
from fractions import Fraction

import numpy as np
import torch

from ..device import resolve_device
from ..models import mlp
from ..models.federated import FederatedTrainer, model_length
from ..sdk.api import spawn_participant
from ..sdk.client import HttpClient
from ..sdk.simulation import keys_for_task
from .coordinator import next_round_seed, round_settings, start_coordinator, wait_for_model

N_PARTICIPANTS = 10
N_SUM = 2
N_UPDATE = 6
ROUNDS = 3
INPUT_DIM = 13


def make_data(rng, n=256):
    """Synthetic housing-style regression data."""
    x = rng.normal(size=(n, INPUT_DIM)).astype(np.float32)
    w = rng.normal(size=INPUT_DIM).astype(np.float32)
    y = (x @ w + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-loss", action="store_true",
                    help="exit nonzero unless the final global model beats the init loss")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the coordinator, the masking and the training")
    args = ap.parse_args()
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)

    def init_module(seed: int):
        return mlp.init_params(torch.Generator().manual_seed(seed), INPUT_DIM, device=device)

    model_len = model_length(init_module(0))
    print(f"model length: {model_len} parameters")

    url = start_coordinator(round_settings(0.3, 0.7, N_SUM, N_UPDATE, 60, model_len), device)
    probe = HttpClient(url)

    # Task eligibility re-draws every round (fresh seed), so the simulation
    # pins role-matched participants per round; threads from earlier rounds
    # stay alive (they idle or pick up whatever role the new seed gives them).
    shared_step = mlp.make_train_step()
    threads = []
    last_seed = None
    for round_no in range(1, ROUNDS + 1):
        seed = next_round_seed(probe, last_seed)

        trainers, shards = [], []
        for i in range(N_SUM):
            keys = keys_for_task(seed, 0.3, 0.7, "sum", start=i * 1000)
            threads.append(
                spawn_participant(
                    url,
                    FederatedTrainer,
                    kwargs=dict(
                        init_params_fn=lambda: init_module(1),
                        make_step=lambda: shared_step,
                        data=make_data(rng),
                        device=device,
                    ),
                    keys=keys,
                    device=device,
                )
            )
        for i in range(N_UPDATE):
            keys = keys_for_task(seed, 0.3, 0.7, "update", start=(50 + i) * 1000)
            shards.append(make_data(rng))
            t = spawn_participant(
                url,
                FederatedTrainer,
                kwargs=dict(
                    init_params_fn=lambda i=i: init_module(10 + i),
                    make_step=lambda: shared_step,
                    data=shards[-1],
                    epochs=2,
                    device=device,
                ),
                scalar=Fraction(1, N_UPDATE),
                keys=keys,
                device=device,
            )
            threads.append(t)
            trainers.append(t)

        model = wait_for_model(probe, seed, timeout=120)
        last_seed = seed
        losses = [t._participant.last_loss for t in trainers if t._participant.last_loss]
        print(f"round {round_no}: global model ready; local losses: "
              + ", ".join(f"{l:.4f}" for l in losses))

    for t in threads:
        t.stop()
    if args.check_loss:
        from .eval_check import require_loss_improved

        loss_fn, _, _ = shared_step
        require_loss_improved(loss_fn, init_module(10), model, shards)
    print("done")


if __name__ == "__main__":
    main()
