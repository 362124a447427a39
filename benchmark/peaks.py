"""The table of peaks the shares are stated against.

Published rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W power limit): FP32 outside the tensor cores and HBM3
bandwidth.  A card set below 700 W runs slower under load; every result
line carries the card's ``nvidia-smi`` power limit beside the shares.
"""

FP32_FLOPS = 67e12          # FP32 operations per second (FMA counts two)
HBM_BYTES_PER_S = 3.35e12   # HBM3 bytes per second
