"""PET wire protocol: signed message envelope and payloads.

Reference surface: rust/xaynet-core/src/message/.
"""

from .message import (
    HEADER_LENGTH,
    SUM_COUNT_MIN,
    UPDATE_COUNT_MIN,
    DecodeError,
    Flags,
    Message,
    Tag,
    peek_header,
)
from .payloads import (
    CHUNK_HEADER_LENGTH,
    SEED_DICT_ENTRY_LENGTH,
    Chunk,
    Payload,
    Sum,
    Sum2,
    Update,
    lv_decode,
    lv_encode,
    parse_local_seed_dict,
    parse_payload,
    serialize_local_seed_dict,
)

__all__ = [
    "HEADER_LENGTH",
    "SUM_COUNT_MIN",
    "UPDATE_COUNT_MIN",
    "DecodeError",
    "Flags",
    "Message",
    "Tag",
    "peek_header",
    "CHUNK_HEADER_LENGTH",
    "SEED_DICT_ENTRY_LENGTH",
    "Chunk",
    "Payload",
    "Sum",
    "Sum2",
    "Update",
    "lv_decode",
    "lv_encode",
    "parse_local_seed_dict",
    "parse_payload",
    "serialize_local_seed_dict",
]
