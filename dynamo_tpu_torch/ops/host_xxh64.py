"""The cold KV tier's payload checksum: xxh64 over K's bytes then V's.

``xxh64_pair`` is the native host routine (``csrc/host_xxh64.cpp``, built
by ``ops/_build.py`` with the kernels at first use and called through
ctypes); ``xxh64_pair_ref`` is its plain version, the port's pure-Python
``tokens.xxh64_intdigest`` over the concatenation, which serves the CPU
and the tests. Both equal the reference's ``xxhash.xxh64`` digest of the
two updates, so a file checksummed by either reads under the other.

``checksum_for(device)`` picks the routine a cold tier uses: the native
one for a CUDA engine (the plain loop takes ~68 ms over one 512 KiB
Llama-3.2-1B block on a CPU, against a fraction of a millisecond
natively), the plain one otherwise. A failed native build raises: it
never falls back to the plain loop on a card's host.
"""

from __future__ import annotations

import ctypes
import threading

from ..tokens import xxh64_intdigest

_fn = None
# the cold tier checksums on executor threads: one of them builds and loads
_load_lock = threading.Lock()


def _native():
    global _fn
    with _load_lock:
        if _fn is None:
            from . import _build

            fn = _build.load("host_xxh64").dyn_xxh64_pair
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                           ctypes.c_size_t, ctypes.c_uint64]
            _fn = fn
    return _fn


def xxh64_pair(a: bytes, b: bytes, seed: int = 0) -> int:
    """xxh64 of ``a || b`` by the native routine (no concatenation copy)."""
    return int(_native()(a, len(a), b, len(b), seed))


def xxh64_pair_ref(a: bytes, b: bytes, seed: int = 0) -> int:
    """The plain version: the pure-Python xxh64 of the concatenation."""
    return xxh64_intdigest(bytes(a) + bytes(b), seed=seed)


def checksum_for(device) -> callable:
    """The checksum a cold tier serving an engine on ``device`` uses."""
    import torch

    return xxh64_pair if torch.device(device).type == "cuda" else xxh64_pair_ref
