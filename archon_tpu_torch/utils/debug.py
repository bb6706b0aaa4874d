"""Debug/poison-mode utilities (SURVEY.md section 5: race detection analog;
port of ``archon_tpu/utils/debug.py``).

The reference's debug machinery is assert density plus memory poisoning
(a5's kDebug=DM_CHECK memsets unused group regions to -1 so a wrong
derivation trips immediately, a5/src/archon.c:155-160).  The analogs here:

- running a path on CPU tensors sends every sort through its plain PyTorch
  twin (``ops.sort.sort_operands_ref``, ``sort_rows_ref``), the way to inspect
  a path without the kernels; the sorts have no switch for it;
- ``checked(fn, lo, hi)``: wrap a function so that every integer tensor it
  returns is held to the index range [lo, hi), surfacing the index errors
  that clamped gathers and dropped scatters would hide;
- ``poison_check(rank)``: assert no poison values survived a refinement
  (the -1 fill convention used by the narrowed path's pads).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _integer_tensors(out):
    if isinstance(out, torch.Tensor):
        if not out.dtype.is_floating_point and out.dtype != torch.bool:
            yield out
    elif isinstance(out, (tuple, list)):
        for item in out:
            yield from _integer_tensors(item)


def checked(fn, lo: int, hi: int):
    """``fn`` wrapped: it runs, then every integer tensor it returns (inside
    tuples and lists too) must lie in [lo, hi), or ``IndexError`` is raised
    naming the function and the offending extreme."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i, t in enumerate(_integer_tensors(out)):
            if t.numel() and (int(t.min()) < lo or int(t.max()) >= hi):
                raise IndexError(
                    f"{fn.__name__}: integer output {i} spans [{int(t.min())}, {int(t.max())}], "
                    f"outside [{lo}, {hi})"
                )
        return out

    return wrapper


def poison_check(arr, poison=-1, name="array") -> None:
    """Host-side poison assertion (a5 DM_CHECK analog)."""
    a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    bad = int((a == poison).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} poison value(s) survived")
