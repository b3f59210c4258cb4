"""PyTorch + CUDA port of the HOBBIT reproduction (`src/repro/` is the JAX
reference).  Plain tensor code is PyTorch; every Pallas kernel on the
serving path is a hand-written Hopper kernel under `kernels/csrc/`.
Nothing here imports JAX or the `repro` package."""

__version__ = "0.1.0"
