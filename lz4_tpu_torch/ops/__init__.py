"""The port's kernels: each module holds a hand-written CUDA kernel
(`csrc/`), its wrapper, its plain PyTorch version and its launch count;
`encode_dense`, `decode_dense` and `chain` (X1-X3, the JAX package's XLA
dense kernels) are PyTorch tensor ops with a call count, one code path on
the CPU and the card."""
