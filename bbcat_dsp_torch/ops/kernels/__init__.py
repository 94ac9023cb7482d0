"""One module per ported Pallas kernel module (``ops/pallas/<name>.py``):
the ctypes wrapper of the CUDA kernel and its plain PyTorch version."""
