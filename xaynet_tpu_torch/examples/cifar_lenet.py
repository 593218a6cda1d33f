"""Baseline config #2: federated LeNet on CIFAR-10-shaped data.

Port of ``examples/cifar_lenet.py``. 100 simulated participants (8 sum +
12 update per round drawn from the pool), f32 mask config, LeNet local
training on ``--device``. Synthetic CIFAR-shaped data stands in for the
dataset (zero-egress environment).

Run:  python -m xaynet_tpu_torch.examples.cifar_lenet [--rounds 2] [--participants 20]
"""

from __future__ import annotations

import argparse
import time
from fractions import Fraction

import numpy as np
import torch

from ..device import resolve_device
from ..models import lenet
from ..models.federated import FederatedTrainer, model_length
from ..sdk.api import spawn_participant
from ..sdk.client import HttpClient
from ..sdk.simulation import keys_for_task
from .coordinator import next_round_seed, round_settings, start_coordinator, wait_for_model


def synthetic_cifar(seed: int, n: int = 128, image_size: int = 32):
    """CIFAR-shaped data with a shared linear teacher so the federated
    objective is actually learnable (labels = argmax of a fixed random
    projection of the image)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, image_size, image_size, 3)).astype(np.float32)
    teacher = np.random.default_rng(123).normal(size=(image_size * image_size * 3, 10))
    y = np.argmax(x.reshape(n, -1) @ teacher, axis=1).astype(np.int32)
    return x, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--participants", type=int, default=20)
    ap.add_argument("--image-size", type=int, default=32, help="synthetic image side (CI smoke: 8)")
    ap.add_argument("--epochs", type=int, default=1, help="local epochs per round")
    ap.add_argument("--lr", type=float, default=1e-3, help="local SGD learning rate")
    ap.add_argument("--check-loss", action="store_true",
                    help="exit nonzero unless the final global model beats the init loss")
    ap.add_argument("--quant", type=int, default=0,
                    help="pre-mask quantization level (0 = exact catalogue "
                    "config; level q divides the fixed-point scale by 10^q "
                    "and shrinks the group order/limb count). The "
                    "--check-loss gate is the accuracy gate for quantized "
                    "rounds: federation must still beat the init loss.")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the coordinator, the masking and the training")
    args = ap.parse_args()
    device = resolve_device(args.device)

    image_shape = (args.image_size, args.image_size, 3)

    def init_module():
        return lenet.init_params(torch.Generator().manual_seed(1), image_shape=image_shape,
                                 device=device)  # fmt: skip

    model_len = model_length(init_module())
    n_sum, n_update = 2, max(3, args.participants - 2)
    print(f"LeNet: {model_len} parameters; {n_sum} sum + {n_update} update per round")

    settings = round_settings(0.2, 0.5, n_sum, n_update, 300, model_len)
    # pre-mask quantization (docs/DESIGN.md §17): a coarser fixed-point
    # config — smaller group order, fewer limbs, proportionally cheaper
    # masks/folds/transfers. Participants follow via the round params.
    settings.mask.quant = args.quant
    url = start_coordinator(settings, device)
    probe = HttpClient(url)

    shared_step = lenet.make_train_step(learning_rate=args.lr)
    last_seed = None
    threads = []
    for round_no in range(1, args.rounds + 1):
        t0 = time.time()
        seed = next_round_seed(probe, last_seed)

        def kwargs(i):
            return dict(
                init_params_fn=init_module,
                make_step=lambda: shared_step,
                data=synthetic_cifar(i, image_size=args.image_size),
                epochs=args.epochs,
                batch_size=32,
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
        # the shared linear teacher makes every shard the same task
        require_loss_improved(
            loss_fn,
            init_module(),
            model,
            [synthetic_cifar(i, image_size=args.image_size) for i in range(n_update)],
        )


if __name__ == "__main__":
    main()
