"""The kernel wrappers: CUDA on a card, the plain version for CPU tensors."""

from .flash_attention import flash_attention  # noqa: F401
from .kw_queue import kw_queue  # noqa: F401
from .residual_sampler import residual_sample  # noqa: F401
from .single_job import single_job  # noqa: F401
from .ssd_scan import ssd_scan  # noqa: F401
