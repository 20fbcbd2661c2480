"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), each with a plain
PyTorch version beside it; ``ops`` holds the wrapper contracts and ``ref``
the oracles. Kernels build at first use (``build``), never at import."""
