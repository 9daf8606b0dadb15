"""ctypes bindings over the port's native host core.

The port's copy of ``dynamo_tpu/native``. The library is built from
``csrc/indexer.cc`` + ``csrc/capi.cc`` (with ``csrc/xxhash64.h``) by
``ops/_build.py``'s host route, with the host compiler, at first use, and
exposes:

- ``compute_block_hashes(tokens, block_size, seed)``: the batched chained
  block hash, bit-identical to ``tokens.compute_block_hashes_plain`` (both
  XXH64 over the same uint32 bytes);
- ``NativeRadixTree``: the C++ radix tree behind
  ``kv_router.indexer.KvIndexer`` (``apply_stored`` / ``apply_removed`` /
  ``find_matches`` / ``remove_worker`` / ``clear_expired``), whose plain
  version is the port's ``RadixTree``;
- ``CApi``: the external-engine KV event ABI (``dt_capi_*``,
  ``dt_kv_event_publish_*``; reference analog lib/bindings/c/src/lib.rs)
  with a Python sink.

Unlike the reference, nothing here degrades quietly: a build that fails
raises with the compiler's output at the first call, and the callers
(``tokens.compute_block_hashes``, ``KvIndexer``) never turn such a failure
into the Python versions (the reference's ``DYNAMO_TPU_NATIVE=0`` switch
is not carried).
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

_lib: Optional[ctypes.CDLL] = None
# several threads may hash at once (executors): one of them builds and loads
_load_lock = threading.Lock()

_SINK_CFUNC = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)


def _declare(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    vp, sz, cp = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p

    def sig(fn, restype, *argtypes):
        fn.restype = restype
        fn.argtypes = list(argtypes)

    sig(lib.dt_xxh64, ctypes.c_uint64, vp, sz, ctypes.c_uint64)
    sig(lib.dt_compute_block_hashes, sz, u32p, sz, sz, ctypes.c_uint64, u64p)
    sig(lib.dt_tree_new, vp, ctypes.c_double)
    sig(lib.dt_tree_free, None, vp)
    sig(lib.dt_tree_apply_stored, None, vp, cp, ctypes.c_int, ctypes.c_uint64,
        u64p, sz)
    sig(lib.dt_tree_apply_removed, None, vp, cp, u64p, sz)
    sig(lib.dt_tree_remove_worker, None, vp, cp)
    sig(lib.dt_tree_size, sz, vp)
    sig(lib.dt_tree_clear_expired, sz, vp)
    sig(lib.dt_tree_find_matches, vp, vp, u64p, sz, ctypes.c_int)
    sig(lib.dt_result_num_workers, sz, vp)
    sig(lib.dt_result_worker, cp, vp, sz)
    sig(lib.dt_result_score, ctypes.c_uint32, vp, sz)
    sig(lib.dt_result_num_freqs, sz, vp)
    sig(lib.dt_result_freq, ctypes.c_uint32, vp, sz)
    sig(lib.dt_result_free, None, vp)
    sig(lib.dt_capi_init, ctypes.c_int, cp, cp, cp, ctypes.c_uint32,
        ctypes.c_uint64)
    sig(lib.dt_capi_shutdown, ctypes.c_int)
    sig(lib.dt_capi_set_sink, None, _SINK_CFUNC, vp)
    sig(lib.dt_kv_event_publish_stored, ctypes.c_int, ctypes.c_uint64, u32p,
        sz, u64p)
    sig(lib.dt_kv_event_publish_removed, ctypes.c_int, ctypes.c_uint64, u64p,
        sz)
    sig(lib.dt_capi_drain, ctypes.c_long, cp, sz)
    sig(lib.dt_capi_dropped_events, ctypes.c_uint64)


def load() -> ctypes.CDLL:
    """The loaded native library, built first if it is missing. Raises
    (``RuntimeError`` with the compiler's output) when the build fails; the
    next call tries again."""
    global _lib
    if _lib is None:
        with _load_lock:
            if _lib is None:
                from ..ops import _build

                lib = _build.load("native")
                _declare(lib)
                _lib = lib
    return _lib


def _u64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u64(values: Sequence[int]) -> np.ndarray:
    return np.ascontiguousarray(values, dtype=np.uint64)


def xxh64(data: bytes, seed: int = 0) -> int:
    return int(load().dt_xxh64(data, len(data), ctypes.c_uint64(seed)))


def compute_block_hashes(token_ids: Sequence[int], block_size: int,
                         seed: int) -> List[int]:
    """Chained sequence hashes of the complete blocks, natively. The ids
    go through ``tokens.full_block_ids`` as the plain loop's do, so both
    accept and refuse the same ids."""
    from ..tokens import full_block_ids

    lib = load()
    arr = full_block_ids(token_ids, block_size)
    out = np.empty(len(arr) // block_size, dtype=np.uint64)
    n = lib.dt_compute_block_hashes(_u32p(arr), len(arr), block_size,
                                    ctypes.c_uint64(seed), _u64p(out))
    return out[:n].tolist()


class NativeRadixTree:
    """The C++ radix tree with ``RadixTree``'s surface, worker ids crossing
    as strings. ``find_matches`` returns ``(scores: {worker: depth},
    frequencies: [holders per depth])``; ``kv_router.indexer`` wraps it."""

    def __init__(self, expiration_s: Optional[float] = None):
        self._lib = load()
        self._ptr = self._lib.dt_tree_new(
            ctypes.c_double(-1.0 if expiration_s is None else expiration_s))

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr and getattr(self, "_lib", None) is not None:
            self._lib.dt_tree_free(ptr)

    def apply_stored(self, worker_id: str, parent_hash: Optional[int],
                     block_hashes: Sequence[int]) -> None:
        arr = _u64(block_hashes)
        self._lib.dt_tree_apply_stored(
            self._ptr, worker_id.encode(), 0 if parent_hash is None else 1,
            ctypes.c_uint64(parent_hash or 0), _u64p(arr), len(arr))

    def apply_removed(self, worker_id: str, block_hashes: Sequence[int]) -> None:
        arr = _u64(block_hashes)
        self._lib.dt_tree_apply_removed(self._ptr, worker_id.encode(),
                                        _u64p(arr), len(arr))

    def remove_worker(self, worker_id: str) -> None:
        self._lib.dt_tree_remove_worker(self._ptr, worker_id.encode())

    def clear_expired(self) -> int:
        return int(self._lib.dt_tree_clear_expired(self._ptr))

    def find_matches(self, block_hashes: Sequence[int],
                     early_exit: bool = False):
        lib, arr = self._lib, _u64(block_hashes)
        res = lib.dt_tree_find_matches(self._ptr, _u64p(arr), len(arr),
                                       1 if early_exit else 0)
        try:
            scores = {lib.dt_result_worker(res, i).decode():
                      int(lib.dt_result_score(res, i))
                      for i in range(lib.dt_result_num_workers(res))}
            freqs = [int(lib.dt_result_freq(res, i))
                     for i in range(lib.dt_result_num_freqs(res))]
        finally:
            lib.dt_result_free(res)
        return scores, freqs

    def __len__(self) -> int:
        return int(self._lib.dt_tree_size(self._ptr))


class CApi:
    """The external-engine KV event ABI (reference: lib/bindings/c). One
    process-wide state in C: ``init`` once, ``set_sink(fn)`` to receive
    each event as a ``RouterEvent`` wire dict (or ``drain`` them), and
    ``publish_stored`` / ``publish_removed`` as a C engine calls the same
    ``dt_*`` symbols::

        capi = CApi(); capi.init("ns", "comp", "worker-0", kv_block_size=16)
        capi.set_sink(events.append)
        capi.publish_stored(1, token_ids)
    """

    def __init__(self):
        self._lib = load()
        # the ctypes trampoline C calls: held for as long as C holds it
        self._sink_ref = None

    def __del__(self):
        # the C global must not outlive the trampoline this object holds
        if getattr(self, "_sink_ref", None) is not None:
            self._lib.dt_capi_set_sink(_SINK_CFUNC(), None)  # a NULL sink

    def init(self, namespace: str, component: str, worker_id: str,
             kv_block_size: int = 16, hash_seed: int = 1337) -> int:
        return int(self._lib.dt_capi_init(
            namespace.encode(), component.encode(), worker_id.encode(),
            kv_block_size, ctypes.c_uint64(hash_seed)))

    def shutdown(self) -> int:
        rc = int(self._lib.dt_capi_shutdown())  # clears the C sink first
        self._sink_ref = None
        return rc

    def set_sink(self, fn: Optional[Callable[[dict], None]]) -> None:
        if fn is None:
            self._lib.dt_capi_set_sink(_SINK_CFUNC(), None)
            self._sink_ref = None
            return

        def trampoline(raw: bytes, _user) -> None:
            fn(json.loads(raw.decode()))

        ref = _SINK_CFUNC(trampoline)
        self._lib.dt_capi_set_sink(ref, None)
        self._sink_ref = ref

    def publish_stored(self, event_id: int, token_ids: Sequence[int],
                       parent_hash: Optional[int] = None) -> int:
        tokens = np.ascontiguousarray(token_ids, dtype=np.uint32)
        parent = (None if parent_hash is None
                  else ctypes.pointer(ctypes.c_uint64(parent_hash)))
        return int(self._lib.dt_kv_event_publish_stored(
            ctypes.c_uint64(event_id), _u32p(tokens), len(tokens), parent))

    def publish_removed(self, event_id: int, block_hashes: Sequence[int]) -> int:
        arr = _u64(block_hashes)
        return int(self._lib.dt_kv_event_publish_removed(
            ctypes.c_uint64(event_id), _u64p(arr), len(arr)))

    def drain(self, cap: int = 1 << 20) -> Optional[dict]:
        """The oldest queued event (pull mode, no sink), or None. A head
        event larger than ``cap`` (-1 from C, still queued) doubles the
        buffer and retries, so one oversized event cannot wedge the queue."""
        cap = max(int(cap), 64)
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.dt_capi_drain(buf, cap)
            if n == 0:
                return None
            if n > 0:
                return json.loads(buf.value.decode())
            cap *= 2

    def dropped_events(self) -> int:
        return int(self._lib.dt_capi_dropped_events())
