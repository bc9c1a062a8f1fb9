"""Hand-written CUDA kernels for the DSBA hot loop and their plain versions.

  sparse_saga  per-node sparse gather-dot and scatter-AXPY (csrc/sparse_saga.cu)
  ref          plain PyTorch versions (the CPU path and the parity oracle)
  ops          the registry: kernel, plain version and tolerance per name
  _build       builds csrc/*.cu with nvcc at first use and loads them
"""
