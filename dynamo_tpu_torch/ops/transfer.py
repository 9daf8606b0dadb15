"""Host → device transfers that never block the host on the device.

A blocking ``tensor.to("cuda")`` from pageable memory synchronizes the
stream, which a dispatch-ahead decode loop cannot afford (and
``torch.cuda.set_sync_debug_mode("error")`` refuses). ``to_device`` stages
the host array in pinned memory and enqueues a ``non_blocking`` copy on the
current stream; the pinned block returns to PyTorch's caching host
allocator, which holds it until the copy has run. ``to_device_packed``
sends several small host arrays as ONE pinned buffer and one copy (a decode
step carries a dozen of them, and each transfer costs the host more than
its bytes do). CPU targets take a plain conversion.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def to_device(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (numpy array, sequence or tensor) on ``device`` as ``dtype``.
    A tensor already on ``device`` passes through (converted if needed)."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        if a.dtype == np.uint32:      # torch has no arithmetic on uint32
            a = a.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    # "cuda" names the current card: a tensor on cuda:0 is already there
    there = t.device.type == device.type and device.index in (
        None, t.device.index)
    if not there:
        if dtype is not None:
            t = t.to(dtype)           # convert on the host: one copy to the card
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
    return t if dtype is None or t.dtype == dtype else t.to(dtype)


_NUMPY = {torch.int64: np.int64, torch.int32: np.int32,
          torch.float32: np.float32, torch.bool: np.bool_}
_ALIGN = 16


def to_device_packed(device, **specs: Tuple[object, torch.dtype]
                     ) -> Dict[str, torch.Tensor]:
    """``name=(array, dtype)`` → ``{name: tensor on device}``. Host arrays
    are converted on the host, laid into one byte buffer at 16-byte
    offsets, copied to a card once (pinned, ``non_blocking``) and handed
    back as typed views of that one buffer (on the CPU the views are of
    the host buffer itself); tensors already on the device pass through
    ``to_device``."""
    device = torch.device(device)
    out, host = {}, {}
    for name, (x, dtype) in specs.items():
        if isinstance(x, torch.Tensor):
            out[name] = to_device(x, device, dtype)
        else:
            host[name] = np.ascontiguousarray(np.asarray(x), _NUMPY[dtype])
    offsets, total = {}, 0
    for name, a in host.items():
        offsets[name] = total
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    if not total:
        return out
    on_card = device.type == "cuda"
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=on_card)
    stage = buf.numpy()
    for name, a in host.items():
        stage[offsets[name]: offsets[name] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = buf.to(device, non_blocking=True) if on_card else buf
    for name, a in host.items():
        dtype = specs[name][1]
        flat = dev[offsets[name]: offsets[name] + a.nbytes]
        out[name] = flat.view(dtype).reshape(a.shape)
    return out
