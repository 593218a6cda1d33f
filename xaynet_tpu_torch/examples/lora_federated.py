"""Baseline config #5 (stretch): federated LoRA adapters, integer masking.

Port of ``examples/lora_federated.py``, the analogue of the Llama-LoRA
federation scenario in BASELINE.md: each participant fine-tunes low-rank
adapters over a FROZEN base model on ``--device``, and only the adapter
deltas federate. The deltas are quantized to int fixed-point and masked
with an INTEGER mask config (i64/B6) — the masked payload covers the
adapters only (~0.1% of a full model) and integer masking avoids the
float fixed-point encode entirely.

The "base model" here is a small frozen linear probe so the example runs
anywhere; the federation mechanics (quantize -> i64 masking -> aggregate ->
dequantize -> apply) are exactly what a Llama-scale adapter run uses, with
`LoraSpec.targets` swapped for the attention projections.

Run:  python -m xaynet_tpu_torch.examples.lora_federated [--check-loss]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..core.mask.config import BoundType, DataType, GroupType, MaskConfig, ModelType
from ..device import resolve_device
from ..models import lora
from ..sdk.api import ParticipantABC
from ..sdk.federation import LocalFederation
from ..server.settings import (
    CountSettings,
    PetSettings,
    PhaseSettings,
    Settings,
    Sum2Settings,
    TimeSettings,
)

D_IN, D_OUT, RANK = 32, 16, 4
Q_SCALE = 10**4  # fixed-point quantization step for the adapter deltas
N_UPDATE, ROUNDS = 3, 2

SPEC = lora.LoraSpec(targets={"probe": (D_IN, D_OUT)}, rank=RANK)
BASE_W = np.asarray(
    np.random.default_rng(7).normal(size=(D_IN, D_OUT)) * 0.1, dtype=np.float32
)


def adapter_len() -> int:
    return D_IN * RANK + RANK * D_OUT


class LoraTrainer(ParticipantABC):
    """Trains adapters on a private shard; federates quantized int deltas."""

    def __init__(self, seed: int, device):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(128, D_IN)).astype(np.float32)
        true_w = BASE_W + 0.05 * rng.standard_normal((D_IN, D_OUT)).astype(np.float32)
        self.y = self.x @ true_w
        self.adapters = lora.init_adapters(torch.Generator().manual_seed(seed), SPEC, device)
        base = torch.as_tensor(BASE_W, device=device)
        self._batch = (torch.as_tensor(self.x, device=device), torch.as_tensor(self.y, device=device))

        def loss_fn(adapters, batch):
            x, y = batch
            pred = lora.apply_adapter(x @ base, x, adapters["probe"], SPEC.alpha, SPEC.rank)
            return torch.mean((pred - y) ** 2)

        self._optimizer_fn, self._step = lora.make_train_step(loss_fn, learning_rate=1e-2)
        self._optimizer = self._optimizer_fn(self.adapters)
        self.last_loss: Optional[float] = None

    def train_round(self, training_input) -> np.ndarray:
        if training_input is not None:
            self.adapters = lora.dequantize_deltas(training_input, self.adapters, Q_SCALE)
            self._optimizer = self._optimizer_fn(self.adapters)
        for _ in range(10):
            loss = self._step(self.adapters, self._optimizer, self._batch)
        self.last_loss = float(loss)
        return lora.quantize_deltas(self.adapters, Q_SCALE)

    def serialize_training_result(self, result) -> np.ndarray:
        return np.asarray(result, dtype=np.int64)  # integer masking path

    def deserialize_training_input(self, global_model):
        return None if global_model is None else np.asarray(global_model)


def _eval_mse(adapters, shards) -> float:
    """Mean squared error over the union of the updaters' shards; adapters
    ``None`` evaluates the frozen base model alone."""
    tot, n = 0.0, 0
    with torch.no_grad():
        for x, y in shards:
            base = x @ BASE_W
            if adapters is not None:
                device = adapters["probe"]["A"].device
                base = lora.apply_adapter(torch.as_tensor(base, device=device),
                                          torch.as_tensor(x, device=device),
                                          adapters["probe"], SPEC.alpha, SPEC.rank).cpu().numpy()  # fmt: skip
            tot += float(np.mean((base - y) ** 2)) * len(x)
            n += len(x)
    return tot / n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument(
        "--check-loss",
        action="store_true",
        help="exit nonzero unless the federated adapters beat the frozen "
        "base model on the union of the updaters' shards (the same "
        "acceptance-gate contract as cifar_lenet / shakespeare_lstm)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device of the coordinator, the masking and the training")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = MaskConfig(GroupType.INTEGER, DataType.I64, BoundType.B6, ModelType.M3)
    settings = Settings(
        pet=PetSettings(
            sum=PhaseSettings(prob=0.3, count=CountSettings(1, 1), time=TimeSettings(0, 300)),
            update=PhaseSettings(
                prob=0.6, count=CountSettings(N_UPDATE, N_UPDATE), time=TimeSettings(0, 300)
            ),
            sum2=Sum2Settings(count=CountSettings(1, 1), time=TimeSettings(0, 300)),
        )
    )
    settings.mask.group_type = cfg.group_type
    settings.mask.data_type = cfg.data_type
    settings.mask.bound_type = cfg.bound_type
    settings.mask.model_type = cfg.model_type
    fed = LocalFederation(model_length=adapter_len(), n_sum=1, n_update=N_UPDATE,
                          settings=settings, device=device)  # fmt: skip

    trainers = [LoraTrainer(seed=i, device=device) for i in range(1 + N_UPDATE)]
    print(f"federating {adapter_len()} int64 adapter deltas (rank {RANK}, scale {Q_SCALE})")
    final_delta = None
    try:
        for result in fed.rounds(trainers, n_rounds=args.rounds):
            losses = [t.last_loss for t in trainers[1:] if t.last_loss is not None]
            final_delta = result.global_model
            print(
                f"round {result.round_id}: global adapter delta ready in "
                f"{result.wall_seconds:.1f}s; local losses: "
                + ", ".join(f"{l:.4f}" for l in losses)
            )
    finally:
        fed.stop()

    if args.check_loss:
        # acceptance gate: the federated global adapters must beat the
        # frozen base model on the union of the updaters' data
        if final_delta is None:
            raise SystemExit("--check-loss needs at least one completed round")
        template = lora.init_adapters(torch.Generator().manual_seed(0), SPEC, device)
        fed_adapters = lora.dequantize_deltas(np.asarray(final_delta), template, Q_SCALE)
        shards = [(t.x, t.y) for t in trainers[1:]]
        before, after = _eval_mse(None, shards), _eval_mse(fed_adapters, shards)
        print(f"eval loss: frozen base {before:.5f} -> base+federated adapters {after:.5f}")
        if not after < before:
            raise SystemExit("federated adapters did not improve on the frozen base model")
    print("done")


if __name__ == "__main__":
    main()
