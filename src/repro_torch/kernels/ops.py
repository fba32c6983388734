"""The kernel wrappers: CUDA on a card, the plain version for CPU tensors."""

from .kw_queue import kw_queue  # noqa: F401
from .residual_sampler import residual_sample  # noqa: F401
