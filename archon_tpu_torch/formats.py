"""Single-block a4/a7 formats on the port's forward BWT (port of
``archon_tpu/formats.py``).

Both formats are N bytes of BWT payload followed by a u32-LE base index; the
payload is the BWT of the reversed input, a4 with the terminator-smallest
suffix order, a7 terminator-largest (see ``golden/sa.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .core.doubling import SENT_LARGE, SENT_SMALL
from .io.blocks import _inverse, as_device

_CONVENTION = {"a4": SENT_SMALL, "a7": SENT_LARGE}


def encode(data: bytes, generation: str = "a4", verify: bool = True, device="cuda") -> bytes:
    """``data`` as an a4/a7 blob, byte-identical with
    ``archon_tpu.formats.encode``.  ``verify=True`` round-trips the result
    through the host LF walk and raises if it does not give ``data`` back."""
    sentinel = _CONVENTION[generation]
    if not data:
        return np.uint32(0).tobytes()
    from .core.fast2 import bwt_v3

    arr = torch.from_numpy(np.frombuffer(data[::-1], np.uint8).copy()).to(as_device(device))
    L, base = bwt_v3(arr, sentinel)
    L = L.cpu().numpy()
    if verify and _inverse(L, base, sentinel, native.available()).tobytes() != data:
        raise AssertionError("BWT verification failed (internal error)")
    return L.tobytes() + np.uint32(base).tobytes()


def decode(blob: bytes, generation: str = "a4", device=None) -> bytes:
    """Invert an a4/a7 blob.  ``device=None`` walks on the host (the native
    LF walk); a device (e.g. ``"cuda"``) runs ``core.unbwt.bwt_inverse``
    there, the counterpart of ``archon_tpu.formats.decode(device=True)``."""
    sentinel = _CONVENTION[generation]
    n = len(blob) - 4
    if n < 0:
        raise ValueError("blob too short")
    if n == 0:
        return b""
    L = np.frombuffer(blob[:n], dtype=np.uint8)
    base = int(np.frombuffer(blob[n:], dtype=np.uint32)[0])
    if base >= n:
        raise ValueError(f"base {base} out of range")
    if device is None:
        return _inverse(L, base, sentinel, native.available()).tobytes()
    from .core.unbwt import bwt_inverse

    out = bwt_inverse(torch.from_numpy(L.copy()).to(as_device(device)), base, sentinel)
    return out.cpu().numpy().tobytes()
