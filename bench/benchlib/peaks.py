"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  Frozen with the
benchmark: a later change to the program cannot move the yardstick."""

BF16_FLOPS = 989e12          # tensor cores, bf16 / fp16
HBM_BYTES_PER_S = 3.35e12
