"""The plain reference of the benchmark's configurations (float32 PyTorch,
no kernels, no cache, no batching).  Imports nothing of the program."""
