"""Hand-written CUDA kernels for the port's hot spots, with their plain
PyTorch versions.

Each kernel module holds the wrapper (`kw_queue`, `residual_sample`,
`flash_attention`, `ssd_scan`, `single_job`), the plain version it is tested against
(`*_plain`) and a launch counter on the wrapper.  The CUDA sources live in `repro_torch/csrc/` and are built at
first use by `build.load_library` — never at import, so the package imports
on machines without a card or a CUDA toolkit.  `ops` re-exports the
wrappers, `ref` the plain versions.
"""
