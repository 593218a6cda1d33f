"""Baseline model families with local training in ``torch.nn``.

Port of ``xaynet_tpu/models``; covers the benchmark configurations
(BASELINE.md):

1. house-prices regression MLP (``mlp``) — 10 participants;
2. LeNet / CIFAR-10 (``lenet``) — 100 simulated participants;
3. character LSTM next-token (``lstm``) — LEAF-Shakespeare shaped;
4. ResNet-50 (``resnet``) — the 25M-parameter aggregation stress model;
5. LoRA adapters (``lora``) — federated low-rank deltas (stretch config).

Every family exposes ``init_params`` (an explicit ``torch.Generator`` and
device) and ``make_train_step`` (``torch.optim``); the ``federated``
module glues any of them into a PET participant. ``flatten_params`` gives
the bytes the JAX package's gives for the same weights (``mlp``: the layout
contract), so torch and JAX participants share one federation.
"""

from .mlp import MLP, flatten_params, unflatten_params

__all__ = ["MLP", "flatten_params", "unflatten_params"]
