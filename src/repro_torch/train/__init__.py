from .optimizer import AdamWState, adamw_init, adamw_update
from .train_step import TrainState, make_train_step, train_state_init
from .grad_compress import compress_int8, decompress_int8, ErrorFeedback

__all__ = [
    "AdamWState", "adamw_init", "adamw_update",
    "TrainState", "make_train_step", "train_state_init",
    "compress_int8", "decompress_int8", "ErrorFeedback",
]
