"""Coordinator and model stores of the port (copies of the JAX package's
``storage/``): in memory, on files, in Redis (``redis``, its Lua scripts
run by Redis itself) and in an S3-compatible bucket (``s3``)."""

from .memory import (
    FileCoordinatorStorage,
    FilesystemModelStorage,
    InMemoryCoordinatorStorage,
    InMemoryModelStorage,
    NoOpTrustAnchor,
)
from .redis import RedisCoordinatorStorage, RespClient
from .s3 import S3ModelStorage, sign_v4
from .traits import Store

__all__ = [
    "FileCoordinatorStorage",
    "FilesystemModelStorage",
    "InMemoryCoordinatorStorage",
    "InMemoryModelStorage",
    "NoOpTrustAnchor",
    "RedisCoordinatorStorage",
    "RespClient",
    "S3ModelStorage",
    "Store",
    "sign_v4",
]
