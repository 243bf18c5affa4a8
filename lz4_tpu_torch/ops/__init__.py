"""The port's kernels: each module holds a hand-written CUDA kernel
(`csrc/`), its wrapper, its plain PyTorch version and its launch count."""
