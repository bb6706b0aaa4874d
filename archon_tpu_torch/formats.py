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
from .io.blocks import _inverse, as_byte_tensor, as_device

_CONVENTION = {"a4": SENT_SMALL, "a7": SENT_LARGE}


def encode(data: bytes, generation: str = "a4", verify: bool = True, device="cuda") -> bytes:
    """``data`` as an a4/a7 blob, byte-identical with
    ``archon_tpu.formats.encode``.  Runs the batched v3 sorter on a single
    row; ``verify=True`` takes the certified variant, whose LF certificate
    runs on the device, and raises if the certificate fails."""
    sentinel = _CONVENTION[generation]
    if not data:
        return np.uint32(0).tobytes()
    from .core.batched import bwt_batched_v3, bwt_batched_v3_certified

    arr = as_byte_tensor(data, device).flip(0).reshape(1, -1)
    if verify:
        L, base, ok = bwt_batched_v3_certified(arr, sentinel)
        if not bool(ok[0]):
            raise AssertionError("BWT verification failed (internal error)")
    else:
        L, base = bwt_batched_v3(arr, sentinel)
    return L[0].cpu().numpy().tobytes() + np.uint32(int(base[0])).tobytes()


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
