"""Plain PyTorch oracles for the kernels, under the reference's names
(`repro.kernels.ref.kw_queue_ref` and `residual_sample_ref`)."""

from .kw_queue import kw_queue_plain as kw_queue_ref  # noqa: F401
from .residual_sampler import residual_sample_plain as residual_sample_ref  # noqa: F401
