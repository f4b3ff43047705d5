"""Hand-written CUDA kernels of the port and their plain PyTorch twins.
Nothing here compiles or loads a kernel at import time."""
