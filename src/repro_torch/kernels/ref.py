"""Plain PyTorch oracles for the kernels, under the reference's names
(`repro.kernels.ref.kw_queue_ref`, `residual_sample_ref`,
`flash_attention_ref` and `ssd_scan_ref`)."""

from .flash_attention import flash_attention_plain as flash_attention_ref  # noqa: F401
from .kw_queue import kw_queue_plain as kw_queue_ref  # noqa: F401
from .residual_sampler import residual_sample_plain as residual_sample_ref  # noqa: F401
from .ssd_scan import ssd_scan_plain as ssd_scan_ref  # noqa: F401
