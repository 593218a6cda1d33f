"""Participant state machine: the client half of the PET protocol.

Functional port of the reference's poll-driven FSM (reference:
rust/xaynet-sdk/src/state_machine/): phases Awaiting -> NewRound ->
(Sum -> Sum2 | Update) -> Awaiting. Every ``transition()`` first re-polls
the round parameters; a parameter change resets the machine to NewRound
(phase.rs:160-200), which is what makes participants tolerant of coordinator
restarts and round cuts.

The whole machine state is serializable (``save()`` / ``restore()``,
reference: state_machine.rs:54-148) so an embedding application can suspend
at any point; a state saved by the JAX package's SDK restores here and the
reverse.

Copy of ``xaynet_tpu/sdk/state_machine.py`` whose two device steps run on
the participant's torch device (``device.resolve_device``: CUDA unless the
caller passes another device): the Update task's masked model is
``ops.masking.mask_update`` (kernel K2 derives the mask, K1 adds the
encoded weights) and the Sum2 mask aggregate is ``ops.masking.sum_masks``
(K2). There is no host route beside them: a failed build or launch fails
the step. ``device_sum2``, ``device_sum2_strict`` and ``mask_kernel`` are
kept, saved and restored for compatibility with the JAX package's states;
they do not move the work to the host.
"""

from __future__ import annotations

import asyncio
import base64
import enum
import json
import logging
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

import numpy as np

from ..core.common import RoundParameters
from ..core.crypto.encrypt import EncryptKeyPair, PublicEncryptKey
from ..core.crypto.sign import SigningKeyPair, is_eligible
from ..core.mask.model import Scalar
from ..core.mask.object import MaskObject, MaskUnit, MaskVect
from ..core.mask.seed import MaskSeed
from ..core.message import Message, Sum, Sum2, Update
from ..core.message.encoder import DEFAULT_MAX_MESSAGE_SIZE, MIN_MESSAGE_SIZE, MessageEncoder
from ..device import resolve_device
from ..ops import masking
from .traits import ModelStore, Notify, XaynetClient

logger = logging.getLogger("xaynet.participant")


def _is_transient_client_error(err: BaseException) -> bool:
    """Worth retrying within the same round? Typed markers win
    (``ClientError.transient``); unmarked connection/timeout builtins are
    transient too (a custom ``XaynetClient`` raising raw socket errors).
    Deliberately NARROWER than ``resilience.policy.is_transient``: a
    generic ``OSError`` here is more likely a local fault (a model store's
    ``FileNotFoundError``) than a network one — treating it as transient
    would spin the participant on PENDING forever, so it propagates."""
    marker = getattr(err, "transient", None)
    if marker is not None:
        return bool(marker)
    return isinstance(err, (ConnectionError, TimeoutError, asyncio.TimeoutError))


# the JAX package's Sum2 route names (its ``utils/kernels.py:MASK_KERNELS``):
# the fused ones name K2 here; the host and batch routes are not ported
MASK_KERNELS = (
    "auto",
    "batch",
    "fused-pallas",
    "fused-pallas-interpret",
    "host-threaded",
    "host-chunked",
)
UNPORTED_MASK_KERNELS = ("batch", "host-threaded", "host-chunked")


class TransitionOutcome(enum.Enum):
    PENDING = "pending"  # no progress possible right now; retry later
    COMPLETE = "complete"  # made progress


class Task(enum.Enum):
    NONE = "none"
    SUM = "sum"
    UPDATE = "update"


class PhaseKind(str, enum.Enum):
    AWAITING = "awaiting"
    NEW_ROUND = "new_round"
    SUM = "sum"
    UPDATE = "update"
    SUM2 = "sum2"


@dataclass
class PetSettings:
    """Participant settings (reference: xaynet-sdk/src/settings/mod.rs:8-23)."""

    keys: SigningKeyPair
    scalar: Fraction = Fraction(1)
    max_message_size: Optional[int] = DEFAULT_MAX_MESSAGE_SIZE
    # the JAX package's Sum2 routing switches, kept (and saved, restored)
    # so its participant states restore here and the reverse; the masks
    # are derived and summed on ``device`` whatever they say
    device_sum2: Optional[bool] = None
    device_sum2_strict: bool = False
    # Sum2 route (MASK_KERNELS): "auto" and the fused names all name K2;
    # the JAX package's host and batch routes are refused
    mask_kernel: str = "auto"
    # deterministic mask seed for the Update task (32 bytes). None (the
    # default, and the only safe production value) draws a fresh random
    # seed per update exactly like the reference; injecting a fixed seed
    # makes the masked model and seed dictionary reproducible, which is
    # what the differential oracle (xaynet_tpu.sim.oracle) needs to replay
    # one round through both the server and the in-graph simulation.
    mask_seed: Optional[bytes] = None
    # the torch device both device steps run on: None is CUDA (and raises
    # ``DeviceUnavailable`` without one); pass "cpu" for the plain versions
    device: object = None

    def __post_init__(self):
        if self.max_message_size is not None and self.max_message_size < MIN_MESSAGE_SIZE:
            raise ValueError(
                f"max_message_size must be None or >= {MIN_MESSAGE_SIZE} "
                "(header + chunk header + 1 byte of progress)"
            )
        if self.mask_seed is not None and len(self.mask_seed) != 32:
            raise ValueError("mask_seed must be exactly 32 bytes")
        if self.mask_kernel not in MASK_KERNELS:
            raise ValueError(
                "mask_kernel must be one of: " + " | ".join(MASK_KERNELS)
            )
        if self.mask_kernel in UNPORTED_MASK_KERNELS:
            raise ValueError(
                f"mask_kernel = {self.mask_kernel!r} names a host or batch Sum2 "
                "route of the JAX package; xaynet_tpu_torch derives and sums "
                "masks with K2 only and accepts \"auto\", \"fused-pallas\" or "
                "\"fused-pallas-interpret\" (ROADMAP Queue 2)"
            )


@dataclass
class _RawPayload:
    """Pre-serialized payload bytes (restoring an in-flight send)."""

    raw: bytes

    def to_bytes(self) -> bytes:
        return self.raw

    def serialized_length(self) -> int:
        return len(self.raw)


class _PendingSend:
    """An in-flight multipart send: encoder + next undelivered part."""

    def __init__(self, encoder: MessageEncoder, coordinator_pk: bytes, next_index: int = 0):
        self.encoder = encoder
        self.coordinator_pk = PublicEncryptKey(coordinator_pk)
        self.next_index = next_index

    def sealed_part(self, i: int) -> bytes:
        return self.coordinator_pk.encrypt(self.encoder.part(i))


class StateMachine:
    """Poll-driven participant FSM."""

    def __init__(
        self,
        settings: PetSettings,
        client: XaynetClient,
        model_store: ModelStore,
        notify: Optional[Notify] = None,
    ):
        self.keys = settings.keys
        self.scalar = settings.scalar
        self.max_message_size = settings.max_message_size
        self.device_sum2 = settings.device_sum2
        self.device_sum2_strict = settings.device_sum2_strict
        self.mask_kernel = settings.mask_kernel
        self.mask_seed = settings.mask_seed
        self.device = resolve_device(settings.device)
        self.client = client
        self.model_store = model_store
        self.notify = notify or Notify()

        self.phase = PhaseKind.AWAITING
        self.round_params: Optional[RoundParameters] = None
        self.task = Task.NONE
        self.sum_signature: Optional[bytes] = None
        self.update_signature: Optional[bytes] = None
        self.ephm_keys: Optional[EncryptKeyPair] = None
        # chunk-level send retry (reference: sending.rs:96-113): the
        # in-flight multipart send is ONE payload copy plus a part index —
        # each part is signed+sealed lazily when its turn comes, so a
        # paused 270MB send doesn't hold a second materialized part list.
        # Delivered parts are never re-sent.
        self._pending: Optional[_PendingSend] = None
        self._after_send_phase: Optional[PhaseKind] = None

    # --- driving ----------------------------------------------------------

    async def transition(self) -> TransitionOutcome:
        """One step; checks round freshness first (phase.rs:160-200).

        A TRANSIENT client failure inside a phase step (a dropped
        connection, a 429/503 the retry wrapper gave up on) does NOT abort
        the round: the machine stays in its phase and reports PENDING — the
        next tick re-polls the round params and, while the round is
        unchanged, resumes exactly where it left off (signatures, ephemeral
        keys and the send cursor are all kept). Only permanent errors
        propagate to the caller."""
        try:
            fresh = await self.client.get_round_params()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if getattr(e, "transient", None) is False:
                # typed PERMANENT client error (404 from a wrong URL, ...):
                # re-polling cannot heal it — surface the misconfiguration
                # instead of ticking PENDING forever
                raise
            logger.debug("round params unavailable: %s", e)
            return TransitionOutcome.PENDING
        if self.round_params is None or fresh != self.round_params:
            self.round_params = fresh
            self._reset_round_state()
            self.phase = PhaseKind.NEW_ROUND
            self.notify.new_round()
            # pin the client's spans to the round's deterministic trace id
            # (derived from the public seed) so the participant's uploads
            # stitch into the coordinator's round trace (DESIGN §16)
            set_round_trace = getattr(self.client, "set_round_trace", None)
            if set_round_trace is not None:
                set_round_trace(fresh.seed.as_bytes())

        if self._pending is not None:
            return await self._drain_sends()

        handler = {
            PhaseKind.AWAITING: self._step_awaiting,
            PhaseKind.NEW_ROUND: self._step_new_round,
            PhaseKind.SUM: self._step_sum,
            PhaseKind.UPDATE: self._step_update,
            PhaseKind.SUM2: self._step_sum2,
        }[self.phase]
        try:
            return await handler()
        except asyncio.CancelledError:
            raise
        except Exception as err:
            if _is_transient_client_error(err):
                logger.info(
                    "transient client failure in %s (%s); staying in phase "
                    "and retrying on a later tick",
                    self.phase.value,
                    err,
                )
                return TransitionOutcome.PENDING
            raise

    def _reset_round_state(self) -> None:
        self.task = Task.NONE
        self.sum_signature = None
        self.update_signature = None
        self.ephm_keys = None
        self._pending = None
        self._after_send_phase = None

    # --- phases -----------------------------------------------------------

    async def _step_awaiting(self) -> TransitionOutcome:
        self.notify.idle()
        return TransitionOutcome.PENDING

    async def _step_new_round(self) -> TransitionOutcome:
        """Sign the round tasks and check eligibility (new_round.rs:29-79)."""
        assert self.round_params is not None
        seed = self.round_params.seed.as_bytes()
        self.sum_signature = self.keys.sign(seed + b"sum").as_bytes()
        self.update_signature = self.keys.sign(seed + b"update").as_bytes()

        if is_eligible(self.sum_signature, self.round_params.sum):
            self.task = Task.SUM
            self.phase = PhaseKind.SUM
            self.notify.sum()
        elif is_eligible(self.update_signature, self.round_params.update):
            self.task = Task.UPDATE
            self.phase = PhaseKind.UPDATE
            self.notify.update()
        else:
            self.task = Task.NONE
            self.phase = PhaseKind.AWAITING
            self.notify.idle()
        return TransitionOutcome.COMPLETE

    async def _step_sum(self) -> TransitionOutcome:
        """Send the ephemeral key, then wait for Sum2 (sum.rs:17-81)."""
        assert self.round_params is not None and self.sum_signature is not None
        if self.ephm_keys is None:
            self.ephm_keys = EncryptKeyPair.generate()
        payload = Sum(
            sum_signature=self.sum_signature,
            ephm_pk=self.ephm_keys.public.as_bytes(),
        )
        return await self._send(payload, PhaseKind.SUM2)

    async def _step_update(self) -> TransitionOutcome:
        """Train, mask, encrypt seeds, upload (update.rs:134-258)."""
        assert self.round_params is not None
        sum_dict = await self.client.get_sums()
        if not sum_dict:
            return TransitionOutcome.PENDING
        model = await self.model_store.load_model()
        if model is None:
            self.notify.load_model()
            return TransitionOutcome.PENDING
        if len(model) != self.round_params.model_length:
            raise ValueError(
                f"local model length {len(model)} != round model length "
                f"{self.round_params.model_length}"
            )
        # dtype vs the ROUND's mask config: integer weights on a float
        # config become the config's float width (f32 fast path when exact
        # to 2^24; f64 keeps integer exactness to 2^53)
        if isinstance(model, np.ndarray) and np.issubdtype(model.dtype, np.integer):
            from ..core.mask.config import DataType

            dt = self.round_params.mask_config.vect.data_type
            if dt is DataType.F32:
                model = model.astype(np.float32)
            elif dt is DataType.F64:
                model = model.astype(np.float64)

        # the mask derived by K2 and the encoded weights added by K1 on the
        # participant's device: the bytes of the host Masker's masked model
        seed = MaskSeed(self.mask_seed) if self.mask_seed is not None else MaskSeed.generate()
        masked_model = masking.mask_update(
            seed.as_bytes(),
            Scalar.from_fraction(self.scalar),
            model if isinstance(model, np.ndarray) else model.weights,
            self.round_params.mask_config,
            device=self.device,
        )
        local_seed_dict = {
            sum_pk: seed.encrypt(PublicEncryptKey(ephm_pk))
            for sum_pk, ephm_pk in sum_dict.items()
        }
        payload = Update(
            sum_signature=self.sum_signature,
            update_signature=self.update_signature,
            masked_model=masked_model,
            local_seed_dict=local_seed_dict,
            # honor the round's negotiated upload format (wire v2 planar)
            wire_planar=self.round_params.wire_format >= 2,
        )
        return await self._send(payload, PhaseKind.AWAITING)

    async def _step_sum2(self) -> TransitionOutcome:
        """Fetch seeds, derive + aggregate masks, upload (sum2.rs:82-204)."""
        assert self.round_params is not None and self.ephm_keys is not None
        seeds = await self.client.get_seeds(self.keys.public)
        if not seeds:
            return TransitionOutcome.PENDING

        length = self.round_params.model_length
        config = self.round_params.mask_config
        mask_seeds = [
            encrypted.decrypt(self.ephm_keys.secret, self.ephm_keys.public)
            for encrypted in seeds.values()
        ]
        mask_obj = self._aggregate_masks(mask_seeds, length, config)

        payload = Sum2(sum_signature=self.sum_signature, model_mask=mask_obj)
        return await self._send(payload, PhaseKind.AWAITING)

    def _aggregate_masks(self, mask_seeds, length: int, config) -> MaskObject:
        """Every update's mask derived and summed by K2 on the participant's
        device (the plain version on a CPU device); the same object as the
        JAX package's host ``Aggregation`` of ``derive_mask`` per seed."""
        unit, vect = masking.sum_masks(
            [s.as_bytes() for s in mask_seeds], length, config, device=self.device
        )
        return MaskObject(MaskVect(config.vect, vect), MaskUnit(config.unit, unit))

    # --- sending ----------------------------------------------------------

    async def _send(self, payload, next_phase: PhaseKind) -> TransitionOutcome:
        """Sign, chunk if oversized, sealed-box encrypt, POST
        (sending.rs:23-121).

        A part that fails to send is retried on later ticks (chunk-level
        retry, reference sending.rs:96-113) — already-delivered chunks are
        never re-sent; the phase only advances once every part is through.
        """
        assert self.round_params is not None
        message = Message(
            participant_pk=self.keys.public,
            coordinator_pk=self.round_params.pk,
            payload=payload,
        )
        encoder = MessageEncoder(message, self.keys.secret, self.max_message_size)
        self._pending = _PendingSend(encoder, self.round_params.pk)
        self._after_send_phase = next_phase
        return await self._drain_sends()

    async def _drain_sends(self) -> TransitionOutcome:
        assert self._pending is not None
        pending = self._pending
        while pending.next_index < pending.encoder.n_parts:
            sealed = pending.sealed_part(pending.next_index)
            try:
                await self.client.send_message(sealed)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if not _is_transient_client_error(e):
                    # a permanent rejection (4xx) will never succeed on a
                    # resend of the SAME bytes: abandon this round's send and
                    # wait for the next round instead of retrying forever
                    logger.warning(
                        "chunk send permanently rejected (part %d/%d): %s; "
                        "abandoning this round's upload",
                        pending.next_index + 1,
                        pending.encoder.n_parts,
                        e,
                    )
                    self._pending = None
                    self._after_send_phase = None
                    self.phase = PhaseKind.AWAITING
                    self.notify.idle()
                    return TransitionOutcome.COMPLETE
                logger.info(
                    "chunk send failed (part %d/%d); retrying on a later tick: %s",
                    pending.next_index + 1,
                    pending.encoder.n_parts,
                    e,
                )
                return TransitionOutcome.PENDING
            pending.next_index += 1
        self._pending = None
        if self._after_send_phase is not None:
            self.phase = self._after_send_phase
            self._after_send_phase = None
        return TransitionOutcome.COMPLETE

    # --- persistence ------------------------------------------------------

    def save(self) -> bytes:
        """Serialize the whole machine state (phase.rs:295-313)."""
        d = {
            "keys": self.keys.secret.hex(),
            "scalar": [self.scalar.numerator, self.scalar.denominator],
            "max_message_size": self.max_message_size,
            "device_sum2": self.device_sum2,
            "device_sum2_strict": self.device_sum2_strict,
            "mask_kernel": self.mask_kernel,
            "mask_seed": self.mask_seed.hex() if self.mask_seed else None,
            "phase": self.phase.value,
            "task": self.task.value,
            "sum_signature": self.sum_signature.hex() if self.sum_signature else None,
            "update_signature": self.update_signature.hex() if self.update_signature else None,
            "ephm_secret": self.ephm_keys.secret.as_bytes().hex() if self.ephm_keys else None,
            "round_params": self.round_params.to_dict() if self.round_params else None,
            # in-flight multipart send (chunk-level retry resumes exactly
            # where it stopped): ONE payload copy + cursor, not sealed parts
            "pending_send": (
                {
                    "payload": base64.b64encode(self._pending.encoder._payload_bytes).decode(),
                    "tag": int(self._pending.encoder.message.tag),
                    "message_id": getattr(self._pending.encoder, "message_id", 0),
                    "max_message_size": self._pending.encoder.max_message_size,
                    "next_index": self._pending.next_index,
                }
                if self._pending is not None
                else None
            ),
            "after_send_phase": self._after_send_phase.value if self._after_send_phase else None,
        }
        # restore() must re-derive the signing keypair, the ephemeral sum
        # keys and the injected oracle seed; the blob never leaves the
        # participant's own store (not a log/report/telemetry surface)
        return json.dumps(d).encode()  # lint: taint-ok: participant-local durable resume blob

    @classmethod
    def restore(
        cls,
        data: bytes,
        client: XaynetClient,
        model_store: ModelStore,
        notify: Optional[Notify] = None,
        device=None,
    ) -> "StateMachine":
        """A machine from ``save()``'s bytes (this SDK's or the JAX
        package's), on ``device`` (None: CUDA); the device is not part of
        the saved state."""
        d = json.loads(data.decode())
        settings = PetSettings(
            keys=SigningKeyPair.derive_from_seed(bytes.fromhex(d["keys"])),
            scalar=Fraction(*d["scalar"]),
            max_message_size=d["max_message_size"],
            # None means "auto on device-equipped hosts" and must survive
            # the save/restore round trip
            device_sum2=(None if d.get("device_sum2") is None else bool(d["device_sum2"])),
            device_sum2_strict=bool(d.get("device_sum2_strict", False)),
            mask_kernel=str(d.get("mask_kernel") or "auto"),
            mask_seed=(
                bytes.fromhex(d["mask_seed"]) if d.get("mask_seed") else None
            ),
            device=device,
        )
        machine = cls(settings, client, model_store, notify)
        machine.phase = PhaseKind(d["phase"])
        machine.task = Task(d["task"])
        machine.sum_signature = bytes.fromhex(d["sum_signature"]) if d["sum_signature"] else None
        machine.update_signature = (
            bytes.fromhex(d["update_signature"]) if d["update_signature"] else None
        )
        if d["ephm_secret"]:
            machine.ephm_keys = EncryptKeyPair.derive_from_seed(bytes.fromhex(d["ephm_secret"]))
        if d["round_params"]:
            machine.round_params = RoundParameters.from_dict(d["round_params"])
        ps = d.get("pending_send")
        if ps and machine.round_params is not None:
            from ..core.message.message import Tag

            message = Message(
                participant_pk=machine.keys.public,
                coordinator_pk=machine.round_params.pk,
                payload=_RawPayload(base64.b64decode(ps["payload"])),
                tag=Tag(ps["tag"]),
            )
            encoder = MessageEncoder(
                message,
                machine.keys.secret,
                ps["max_message_size"],
                message_id=ps["message_id"],
            )
            machine._pending = _PendingSend(
                encoder, machine.round_params.pk, next_index=int(ps["next_index"])
            )
        if d.get("after_send_phase"):
            machine._after_send_phase = PhaseKind(d["after_send_phase"])
        return machine
