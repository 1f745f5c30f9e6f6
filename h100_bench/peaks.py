"""The table of peaks: one NVIDIA H100 SXM5 (80 GB HBM3), NVIDIA's data
sheet, dense rates at the full 700 W. A card set to a lower power limit
runs below them; every result names the card."""

HBM_BYTES_PER_S = 3.35e12  # device memory rate
F32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 is off)
