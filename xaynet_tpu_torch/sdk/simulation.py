"""Simulation helpers: deterministic role assignment and load generation.

PET task selection is probabilistic over each participant's Ed25519 key and
the round seed. For simulations and tests we need participants with *known*
roles, so we rejection-sample signing keys until the eligibility check lands
on the desired task — the protocol itself stays untouched.

``flood`` drives N concurrent, fully valid update uploads (deterministic
keys via ``keys_for_task``) against a ``PetMessageHandler`` or an
``ingest.IngestPipeline`` — the load generator behind the shed/admit stress
tests.

Copy of ``xaynet_tpu/sdk/simulation.py``. ``build_update_message`` masks
with the host ``Masker``, as the JAX package's does: a load generator's
messages need no device.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.common import RoundParameters
from ..core.crypto.encrypt import PublicEncryptKey
from ..core.crypto.sign import SigningKeyPair, is_eligible
from ..core.mask.masking import Masker
from ..core.mask.model import Scalar
from ..core.message import Message, Update


def keys_for_task(
    round_seed: bytes,
    sum_prob: float,
    update_prob: float,
    want: str,
    start: int = 0,
    max_tries: int = 100_000,
) -> SigningKeyPair:
    """Finds a signing keypair whose task for this round is ``want``.

    ``want`` is "sum", "update" or "none". Deterministic given ``start``.
    """
    for i in range(start, start + max_tries):
        keys = SigningKeyPair.derive_from_seed(i.to_bytes(32, "little"))
        sum_sig = keys.sign(round_seed + b"sum").as_bytes()
        update_sig = keys.sign(round_seed + b"update").as_bytes()
        if is_eligible(sum_sig, sum_prob):
            role = "sum"
        elif is_eligible(update_sig, update_prob):
            role = "update"
        else:
            role = "none"
        if role == want:
            return keys
    raise RuntimeError(f"no key found for task {want} in {max_tries} tries")


def build_update_message(
    params: RoundParameters,
    keys: SigningKeyPair,
    sum_dict: dict,
    model,
    scalar: Fraction = Fraction(1),
    wire_planar: Optional[bool] = None,
) -> bytes:
    """One fully valid, sealed update upload for an update-task participant.

    The exact client-side pipeline (mask -> seed-dict encrypt -> sign ->
    sealed box) without the participant state machine around it — what a
    load generator needs. ``wire_planar=None`` follows the round's
    negotiated wire format (``params.wire_format``); an explicit bool
    forces the v2 planar / v1 interleaved element layout.
    """
    masker = Masker(params.mask_config)
    seed, masked_model = masker.mask(Scalar.from_fraction(scalar), np.asarray(model))
    if wire_planar is None:
        wire_planar = params.wire_format >= 2
    payload = Update(
        sum_signature=keys.sign(params.seed.as_bytes() + b"sum").as_bytes(),
        update_signature=keys.sign(params.seed.as_bytes() + b"update").as_bytes(),
        masked_model=masked_model,
        local_seed_dict={
            sum_pk: seed.encrypt(PublicEncryptKey(ephm_pk))
            for sum_pk, ephm_pk in sum_dict.items()
        },
        wire_planar=wire_planar,
    )
    message = Message(participant_pk=keys.public, coordinator_pk=params.pk, payload=payload)
    return PublicEncryptKey(params.pk).encrypt(message.to_bytes(keys.secret))


@dataclass
class FloodStats:
    """Outcome counts of one ``flood`` run.

    ``accepted`` means the target took the message (handler completed, or
    the pipeline admitted it — admitted messages resolve asynchronously);
    ``rejected`` counts pipeline-stage/protocol drops surfaced at submit
    time; ``shed`` counts admission-control refusals (429 upstream).
    Chaos knobs add ``dropped`` (participants whose upload was never sent)
    and ``straggled`` (sent late); the index tuples name exactly who, so a
    test can rebuild the surviving participant set.
    """

    sent: int = 0
    accepted: int = 0
    rejected: int = 0
    shed: int = 0
    dropped: int = 0
    straggled: int = 0
    dropped_indices: tuple = ()
    straggled_indices: tuple = ()


def plan_churn(
    n: int, dropout_rate: float, stragglers: int, seed: int
) -> tuple[frozenset, frozenset]:
    """Deterministic churn assignment for ``flood``: which of the ``n``
    participants drop out entirely and which straggle. Seeded — a chaos
    test and its byte-identity control run agree on the survivor set."""
    if not (0.0 <= dropout_rate < 1.0):
        raise ValueError("dropout_rate must be in [0, 1)")
    rng = random.Random(seed)
    n_drop = int(round(n * dropout_rate))
    dropped = frozenset(rng.sample(range(n), n_drop)) if n_drop else frozenset()
    remaining = sorted(set(range(n)) - dropped)
    n_straggle = min(max(0, stragglers), len(remaining))
    straggled = (
        frozenset(rng.sample(remaining, n_straggle)) if n_straggle else frozenset()
    )
    return dropped, straggled


async def flood(
    target,
    params: RoundParameters,
    sum_dict: dict,
    n: int,
    *,
    models: Optional[Sequence] = None,
    scalar: Optional[Fraction] = None,
    key_start: int = 0,
    key_spacing: int = 1000,
    concurrency: int = 64,
    build: Optional[Callable[[int], bytes]] = None,
    dropout_rate: float = 0.0,
    stragglers: int = 0,
    straggle_delay_s: float = 0.2,
    churn_seed: Optional[int] = None,
) -> FloodStats:
    """Drive ``n`` concurrent valid update uploads against ``target``.

    ``target`` is a ``PetMessageHandler`` (awaits each message's verdict),
    an ``ingest.IngestPipeline`` (admission verdicts), or any async callable
    of one ``bytes`` argument. Keys are deterministic — participant ``i``
    searches from ``key_start + i * key_spacing`` — so repeated floods in
    the same round collide on purpose (duplicate-participant rejections)
    and distinct ``key_start`` ranges never do. ``build`` overrides message
    construction (e.g. pre-sealed garbage for decrypt-path floods).

    Churn knobs (chaos scenarios, docs/DESIGN.md §10): ``dropout_rate``
    silently withholds that fraction of the uploads (the participants
    trained, then vanished — the quorum-completion target), ``stragglers``
    delays that many of the surviving uploads by ``straggle_delay_s``.
    Assignment is deterministic per ``churn_seed`` (``plan_churn``), and
    the stats name the affected indices so a control run can rebuild the
    exact survivor set.
    """
    if models is None:
        rng = np.random.default_rng(key_start or 7)
        models = [
            rng.uniform(-1, 1, params.model_length).astype(np.float32) for _ in range(n)
        ]
    scalar = scalar if scalar is not None else Fraction(1, max(1, n))
    seed = params.seed.as_bytes()

    def default_build(i: int) -> bytes:
        keys = keys_for_task(
            seed, params.sum, params.update, "update", start=key_start + i * key_spacing
        )
        return build_update_message(params, keys, sum_dict, models[i % len(models)], scalar)

    build = build or default_build
    # seed 0 is a valid explicit choice — only None falls back to key_start
    # (a control run on a different key range must reuse the chaos run's
    # churn_seed and get the identical survivor set)
    if churn_seed is None:
        churn_seed = key_start or 7
    dropped, straggled = plan_churn(n, dropout_rate, stragglers, churn_seed)
    # sealing is CPU-bound and deterministic: do it before the clock starts
    # (dropouts never sent anything — don't pay for sealing them either)
    sealed = {i: build(i) for i in range(n) if i not in dropped}

    submit = _submitter(target)
    stats = FloodStats(
        dropped=len(dropped),
        straggled=len(straggled),
        dropped_indices=tuple(sorted(dropped)),
        straggled_indices=tuple(sorted(straggled)),
    )
    gate = asyncio.Semaphore(max(1, concurrency))

    async def one(i: int, blob: bytes) -> None:
        if i in straggled:
            # outside the gate: a straggler must not hold a concurrency slot
            # while it sleeps
            await asyncio.sleep(straggle_delay_s)
        async with gate:
            stats.sent += 1
            outcome = await submit(blob)
            setattr(stats, outcome, getattr(stats, outcome) + 1)

    await asyncio.gather(*(one(i, blob) for i, blob in sealed.items()))
    return stats


def _submitter(target):
    """Normalize the three target kinds to ``async (bytes) -> outcome``."""
    from ..server.requests import RequestError
    from ..server.services import ServiceError

    if hasattr(target, "submit"):  # ingest.IngestPipeline

        async def submit_pipeline(blob: bytes) -> str:
            verdict = await target.submit(blob)
            if verdict.shed:
                return "shed"
            return "accepted" if verdict.verdict.value == "admitted" else "rejected"

        return submit_pipeline

    if hasattr(target, "handle_message"):  # PetMessageHandler

        async def submit_handler(blob: bytes) -> str:
            try:
                await target.handle_message(blob)
                return "accepted"
            except (ServiceError, RequestError):
                return "rejected"

        return submit_handler

    async def submit_callable(blob: bytes) -> str:
        await target(blob)
        return "accepted"

    return submit_callable
