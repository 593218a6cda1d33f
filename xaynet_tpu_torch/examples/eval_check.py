"""Shared acceptance gate for the federated examples' ``--check-loss``.

Port of ``examples/eval_check.py``: evaluates the initial participant
module and the final federated global model on the union of the updaters'
shards with the family's loss (cross-entropy for LeNet and the LSTM, MSE
for the house-prices MLP); exits nonzero unless federation improved it.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..models.mlp import unflatten_params


def require_loss_improved(loss_fn, init_module, final_model, shards) -> None:
    """Exit nonzero unless the federated model beats ``init_module``.

    ``loss_fn(module, x, y)`` is the family's loss (``make_train_step``'s
    first element); ``shards`` a list of (x, y) arrays (the updaters' own
    data); ``final_model`` the flattened global model vector.
    """
    device = next(init_module.parameters()).device
    eval_x = torch.as_tensor(np.concatenate([x for x, _ in shards]), device=device)
    eval_y = torch.as_tensor(np.concatenate([y for _, y in shards]), device=device)
    final = unflatten_params(copy.deepcopy(init_module), np.asarray(final_model, dtype=np.float32))
    with torch.no_grad():
        before = float(loss_fn(init_module, eval_x, eval_y))
        after = float(loss_fn(final, eval_x, eval_y))
    print(f"eval loss: init {before:.4f} -> federated {after:.4f}")
    if not after < before:
        raise SystemExit("federated model did not improve on the init loss")
