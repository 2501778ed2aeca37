from .sharding import (BATCH_AXES, TP_AXIS, filter_spec, pad_to_multiple,
                       padded_heads, padded_vocab, shard_hint, spec)

__all__ = [
    "BATCH_AXES", "TP_AXIS", "filter_spec", "pad_to_multiple",
    "padded_heads", "padded_vocab", "shard_hint", "spec",
]
