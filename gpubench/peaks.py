"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W limit). A card set below 700 W
(``nvidia-smi --query-gpu=power.limit``) reaches less; every run records
its card's limit beside the shares it reports."""

BF16_FLOPS = 989e12   # bf16 / fp16 tensor cores
HBM_BYTES_PER_S = 3.35e12
