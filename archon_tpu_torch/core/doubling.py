"""Sentinel conventions and rank inversion (port of the parts of
``archon_tpu/core/doubling.py`` the forward BWT uses)."""

from __future__ import annotations

import torch

SENT_SMALL = "small"  # off-end compares below every byte (a4)
SENT_LARGE = "large"  # off-end compares above every byte (a7)


def _invert_permutation(perm: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` scattered to positions ``perm``.  The TPU version sorts by
    ``perm``; on the GPU the scatter ``out[perm] = values`` is one pass, and
    since ``perm`` is a permutation the result is identical."""
    out = torch.empty_like(values)
    out[perm] = values
    return out
