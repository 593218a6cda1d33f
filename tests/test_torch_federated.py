"""One federated MLP round per package, from the same init and data.

The JAX package's ``FederatedTrainer`` under its ``LocalFederation`` and the
port's under the port's (``device="cpu"``): 1 sum and 3 update
participants, each update trainer with its own numpy-seeded shard, every
trainer starting from the same JAX init (carried over with
``convert.load_flax_params``). Both rounds average the same three locally
trained MLPs, so the two global models agree within the local training's
own disagreement: 6 Adam steps (2 epochs of 3 batches) at lr 5e-3, each
update about lr per weight and agreeing to f32 roundings (see
``test_torch_models.py``), plus the fixed-point decode (3 / exp_shift);
held to 1e-5 absolute.
"""

from __future__ import annotations

import jax
import numpy as np

from xaynet_tpu.models import mlp as j_mlp
from xaynet_tpu.models.federated import FederatedTrainer as JaxTrainer
from xaynet_tpu.sdk.federation import LocalFederation as JaxFederation
from xaynet_tpu_torch.convert import load_flax_params
from xaynet_tpu_torch.models import mlp
from xaynet_tpu_torch.models.federated import FederatedTrainer, model_length
from xaynet_tpu_torch.sdk.federation import LocalFederation

INPUT_DIM, FEATURES = 5, (8,)
N_SUM, N_UPDATE = 1, 3


def _shard(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(96, INPUT_DIM)).astype(np.float32)
    w = np.random.default_rng(0).normal(size=INPUT_DIM).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _round(federation, trainers) -> np.ndarray:
    try:
        (result,) = list(federation.rounds(trainers, n_rounds=1))
    finally:
        federation.stop()
    return result.global_model


def test_one_round_matches_the_jax_round():
    init = jax.tree_util.tree_map(
        np.asarray, j_mlp.init_params(jax.random.PRNGKey(7), INPUT_DIM, FEATURES)
    )
    common = [dict(data=_shard(100 + i), epochs=2, batch_size=32, seed=i)
              for i in range(N_SUM + N_UPDATE)]  # fmt: skip
    j_step = j_mlp.make_train_step(FEATURES, learning_rate=5e-3)
    jax_trainers = [JaxTrainer(lambda: init, lambda: j_step, **kw) for kw in common]
    t_step = mlp.make_train_step(learning_rate=5e-3)
    port_trainers = [
        FederatedTrainer(lambda: load_flax_params(mlp.MLP(INPUT_DIM, FEATURES), init),
                         lambda: t_step, device="cpu", **kw)
        for kw in common
    ]  # fmt: skip
    length = model_length(port_trainers[0].module)
    assert length == j_mlp.flatten_params(init).size

    want = _round(JaxFederation(length, n_sum=N_SUM, n_update=N_UPDATE), jax_trainers)
    got = _round(LocalFederation(length, n_sum=N_SUM, n_update=N_UPDATE, device="cpu"),
                 port_trainers)  # fmt: skip

    assert got.shape == want.shape == (length,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # each round averaged its three trained models, which moved off the init
    trained = np.mean([mlp.flatten_params(t.module) for t in port_trainers[N_SUM:]], axis=0)
    np.testing.assert_allclose(got, trained, rtol=0, atol=3e-6)
    assert np.abs(got - j_mlp.flatten_params(init)).max() > 1e-3
    assert all(t.last_loss is not None for t in port_trainers[N_SUM:])
    assert port_trainers[0].last_loss is None  # the sum participant never trains
