"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version and a launch counter (``<module>.launches``).

| Kernel | Wrapper | Replaces (TPU) |
| --- | --- | --- |
| K1 | ``flash_attention.flash_fwd`` | ``ops/pallas/flash_attention.py::_fwd_kernel``, ``::_fwd_stream_kernel`` |
| K2 | ``layer_norm.layer_norm_fwd`` | ``ops/pallas/layer_norm.py::_ln_fwd_kernel`` |
| K3a | ``flash_attention.flash_bwd_fused`` | ``ops/pallas/flash_attention.py::_bwd_fused_kernel`` |
| K3b | ``flash_attention.flash_bwd_dkv``, ``flash_bwd_dq`` | ``ops/pallas/flash_attention.py::_bwd_dkv_stream_kernel``, ``::_bwd_dq_stream_kernel`` |
| K4 | ``paged_attention.paged_attention`` | ``ops/pallas/paged_attention.py::_paged_kernel`` |
| K5 | ``chunk_prefill.chunk_prefill`` | ``ops/pallas/chunk_prefill.py::_chunk_kernel`` |

Modules are imported lazily by their callers; nothing here builds or
loads the CUDA library at import.
"""
