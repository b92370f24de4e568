"""Published peaks of the card (NVIDIA H100 SXM data sheet, at its full
700 W power limit)."""

H100_HBM_BYTES_S = 3.35e12
