"""Hand-written CUDA kernels of the port and their plain versions.

  sparse_saga  per-node sparse gather-dot and scatter-AXPY (csrc/sparse_saga.cu)
  flash_attention   attention forward with o and lse (csrc/flash_attention.cu),
                    its blocked gradient (csrc/flash_attention_bwd.cu) and the
                    FlashAttention autograd Function joining them
  decode_attention  paged single-query decode attention (csrc/decode_attention.cu)
  topk_compress     block-local top-k magnitude selection, the gossip wire
                    format's (csrc/topk_compress.cu)
  ssd_scan     Mamba2/SSD within-chunk forward and its gradient
               (csrc/ssd_scan.cu) and the SsdChunk autograd Function
  ref          plain PyTorch versions (the CPU path and the parity oracle)
  ops          the registry: kernel, plain version and tolerance per name
  _build       builds csrc/*.cu with nvcc at first use and loads them
"""
