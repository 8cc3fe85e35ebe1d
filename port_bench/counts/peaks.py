"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
700 W runs slower under load: every share reported against these peaks
goes out with the card's power limit beside it."""

BF16_DENSE_FLOPS = 989e12   # tensor cores, bfloat16 and float16
FP32_FLOPS = 67e12          # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
