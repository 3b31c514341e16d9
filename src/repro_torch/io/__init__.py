from repro_torch.io.serialization import (
    StateBlob,
    serialize_state,
    deserialize_state,
    partition_blob,
    join_fragments,
    fragment_key,
)
from repro_torch.io.sion import SionContainer
from repro_torch.io.beeond import CacheFS

__all__ = [
    "StateBlob",
    "serialize_state",
    "deserialize_state",
    "partition_blob",
    "join_fragments",
    "fragment_key",
    "SionContainer",
    "CacheFS",
]
