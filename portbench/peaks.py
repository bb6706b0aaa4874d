"""Peaks of the card, for rooflines.

NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s, at the full 700 W
power limit (a card set below it runs slower under load; the harness prints
the limit beside every traced run).
"""

HBM_BYTES_PER_S = 3.35e12
