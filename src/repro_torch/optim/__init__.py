"""AdamW and int8 gradient compression (counterparts of `repro.optim`)."""

from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule  # noqa: F401
from .compression import compress_gradients, decompress_gradients, init_error_feedback  # noqa: F401
