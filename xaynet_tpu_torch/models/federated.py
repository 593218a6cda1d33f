"""Glue between the port's model families and the PET participant API.

Port of ``xaynet_tpu/models/federated.py``. ``FederatedTrainer`` wraps
(init_params, train_step, local data) into a ``ParticipantABC``: each round
it writes the global model into its module, runs E local epochs on its
device, and returns the flattened weight vector for masking — the analogue
of the reference's keras participant (reference:
bindings/python/examples/keras_house_prices/).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..sdk.api import ParticipantABC
from .mlp import flatten_params, unflatten_params


class FederatedTrainer(ParticipantABC):
    """Local trainer for any module of ``models``.

    ``init_params_fn()`` returns the module, ``make_step()`` a family's
    ``make_train_step`` triple ``(loss_fn, optimizer_fn, step)``; ``data``
    is ``(x, y)`` numpy arrays, uploaded to ``device`` (None: CUDA) once.
    Round semantics are the JAX trainer's: a global model resets the
    optimizer state; each epoch walks ``np.random.default_rng(seed)``
    permutations in whole batches (the last short batch is dropped).
    """

    def __init__(
        self,
        init_params_fn: Callable[[], nn.Module],
        make_step: Callable[[], tuple],
        data: tuple[np.ndarray, np.ndarray],
        epochs: int = 1,
        batch_size: int = 32,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.module = init_params_fn().to(self.device)
        _, self.optimizer_fn, self.step = make_step()
        self.optimizer = self.optimizer_fn(self.module.parameters())
        x, y = data
        self.n = len(x)
        self.x = torch.as_tensor(np.asarray(x), device=self.device)
        self.y = torch.as_tensor(np.asarray(y), device=self.device)
        self.epochs = epochs
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.last_loss: Optional[float] = None

    def train_round(self, training_input):
        if training_input is not None:
            unflatten_params(self.module, training_input)
            self.optimizer = self.optimizer_fn(self.module.parameters())
        for _ in range(self.epochs):
            order = self.rng.permutation(self.n)
            for start in range(0, self.n - self.batch_size + 1, self.batch_size):
                idx = torch.as_tensor(order[start : start + self.batch_size], device=self.device)
                loss = self.step(self.module, self.optimizer, self.x[idx], self.y[idx])
            self.last_loss = float(loss)
        return flatten_params(self.module)

    def deserialize_training_input(self, global_model):
        return np.asarray(global_model, dtype=np.float32)


def model_length(module: nn.Module) -> int:
    return sum(t.numel() for t in module.flax_leaves().values())
