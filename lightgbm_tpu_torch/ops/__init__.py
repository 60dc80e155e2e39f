"""Device compute ops: the traversal kernel, its plain PyTorch version,
and the CUDA build."""
