"""Hand-written CUDA kernels of the port and their plain versions.

  sparse_saga  per-node sparse gather-dot and scatter-AXPY (csrc/sparse_saga.cu)
  flash_attention   attention forward with o and lse (csrc/flash_attention.cu),
                    its blocked gradient (csrc/flash_attention_bwd.cu) and the
                    FlashAttention autograd Function joining them
  decode_attention  paged single-query decode attention (csrc/decode_attention.cu)
  ref          plain PyTorch versions (the CPU path and the parity oracle)
  ops          the registry: kernel, plain version and tolerance per name
  _build       builds csrc/*.cu with nvcc at first use and loads them
"""
