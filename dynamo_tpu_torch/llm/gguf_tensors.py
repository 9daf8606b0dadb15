"""GGUF tensor data: reading and dequantization (numpy, vectorized).

The port of ``dynamo_tpu/llm/gguf_tensors.py``: ``llm/gguf.py`` parses the
metadata and descriptors, this module reads each tensor's bytes from a
mapping of the file and dequantizes them on the host to float32, so a
``.gguf`` checkpoint can be served (``models/loader.load_gguf_llama_params``
narrows each to the compute dtype on its way to the device). The block
formats are the public GGML spec (ggml's quants.c).

Supported ggml dtypes: f32, f16, bf16, q8_0, q4_0, q4_1, q5_0, q5_1 and the
k-quants q4_k, q5_k, q6_k. Each dequantizer takes the raw block bytes as a
uint8 array and the element count and returns float32 of that length,
as reshapes and bit arithmetic over the block axis.
"""

from __future__ import annotations

import mmap
from typing import Dict, Iterator, Tuple

import numpy as np

from .gguf import GgufError, GgufFile, GgufTensorInfo

QK = 32       # block size of the simple quants
QK_K = 256    # block size of the k-quants


def _f16(raw: np.ndarray) -> np.ndarray:
    """View consecutive byte pairs as little-endian float16 → float32."""
    return raw.view("<f2").astype(np.float32)


def _nibbles(qs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(low, high) 4-bit halves of a uint8 array."""
    return (qs & 0x0F).astype(np.int8), (qs >> 4).astype(np.int8)


def _deq_q8_0(blocks: np.ndarray, n: int) -> np.ndarray:
    b = blocks.reshape(-1, 2 + QK)
    d = _f16(b[:, :2].reshape(-1))[:, None]
    q = b[:, 2:].view(np.int8).astype(np.float32)
    return (d * q).reshape(-1)[:n]


def _deq_q4_0(blocks: np.ndarray, n: int) -> np.ndarray:
    b = blocks.reshape(-1, 2 + QK // 2)
    d = _f16(b[:, :2].reshape(-1))[:, None]
    lo, hi = _nibbles(b[:, 2:])
    q = np.concatenate([lo, hi], axis=1).astype(np.float32) - 8.0
    return (d * q).reshape(-1)[:n]


def _deq_q4_1(blocks: np.ndarray, n: int) -> np.ndarray:
    b = blocks.reshape(-1, 4 + QK // 2)
    d = _f16(b[:, 0:2].reshape(-1))[:, None]
    m = _f16(b[:, 2:4].reshape(-1))[:, None]
    lo, hi = _nibbles(b[:, 4:])
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (d * q + m).reshape(-1)[:n]


def _q5_high_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """[nb, 4] uint8 → [nb, 32] fifth bits (little-endian uint32 bit j)."""
    qh = qh_bytes.copy().view("<u4").reshape(-1, 1)
    j = np.arange(QK, dtype=np.uint32)[None, :]
    return ((qh >> j) & 1).astype(np.int8)


def _deq_q5_0(blocks: np.ndarray, n: int) -> np.ndarray:
    b = blocks.reshape(-1, 2 + 4 + QK // 2)
    d = _f16(b[:, :2].reshape(-1))[:, None]
    hi_bits = _q5_high_bits(b[:, 2:6])
    lo, hi = _nibbles(b[:, 6:])
    q = np.concatenate([lo, hi], axis=1) | (hi_bits << 4)
    return (d * (q.astype(np.float32) - 16.0)).reshape(-1)[:n]


def _deq_q5_1(blocks: np.ndarray, n: int) -> np.ndarray:
    b = blocks.reshape(-1, 4 + 4 + QK // 2)
    d = _f16(b[:, 0:2].reshape(-1))[:, None]
    m = _f16(b[:, 2:4].reshape(-1))[:, None]
    hi_bits = _q5_high_bits(b[:, 4:8])
    lo, hi = _nibbles(b[:, 8:])
    q = np.concatenate([lo, hi], axis=1) | (hi_bits << 4)
    return (d * q.astype(np.float32) + m).reshape(-1)[:n]


def _k_scale_min(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ggml get_scale_min_k4: [nb, 12] packed 6-bit → ([nb, 8] sc, m)."""
    sc = np.empty(scales.shape[:1] + (8,), np.float32)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[:, j] = (scales[:, j] & 63).astype(np.float32)
        mn[:, j] = (scales[:, j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[:, j] = ((scales[:, j + 4] & 0x0F) | ((scales[:, j - 4] >> 6) << 4)).astype(np.float32)
        mn[:, j] = ((scales[:, j + 4] >> 4) | ((scales[:, j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def _deq_q4_k(blocks: np.ndarray, n: int) -> np.ndarray:
    # block: d f16, dmin f16, scales[12], qs[128] — 8 sub-blocks of 32
    b = blocks.reshape(-1, 2 + 2 + 12 + QK_K // 2)
    d = _f16(b[:, 0:2].reshape(-1))[:, None]
    dmin = _f16(b[:, 2:4].reshape(-1))[:, None]
    sc, mn = _k_scale_min(b[:, 4:16])
    qs = b[:, 16:].reshape(-1, 4, 32)            # 4 chunks of 32 bytes
    lo = (qs & 0x0F).astype(np.float32)          # sub-blocks 0,2,4,6
    hi = (qs >> 4).astype(np.float32)            # sub-blocks 1,3,5,7
    q = np.stack([lo, hi], axis=2).reshape(-1, 8, 32)  # [nb, sub, 32]
    y = d[:, :, None] * sc[:, :, None] * q - dmin[:, :, None] * mn[:, :, None]
    return y.reshape(-1)[:n]


def _deq_q5_k(blocks: np.ndarray, n: int) -> np.ndarray:
    # block: d f16, dmin f16, scales[12], qh[32], qs[128]
    b = blocks.reshape(-1, 2 + 2 + 12 + QK_K // 8 + QK_K // 2)
    d = _f16(b[:, 0:2].reshape(-1))[:, None]
    dmin = _f16(b[:, 2:4].reshape(-1))[:, None]
    sc, mn = _k_scale_min(b[:, 4:16])
    qh = b[:, 16:48]                              # [nb, 32]
    qs = b[:, 48:].reshape(-1, 4, 32)
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    # chunk g supplies sub-blocks 2g (low nibbles, qh bit 2g) and 2g+1
    # (high nibbles, qh bit 2g+1)
    g = np.arange(4)
    bit_lo = ((qh[:, None, :] >> (2 * g)[None, :, None]) & 1).astype(np.int16)
    bit_hi = ((qh[:, None, :] >> (2 * g + 1)[None, :, None]) & 1).astype(np.int16)
    q = np.stack([lo | (bit_lo << 4), hi | (bit_hi << 4)], axis=2)
    q = q.reshape(-1, 8, 32).astype(np.float32)
    y = d[:, :, None] * sc[:, :, None] * q - dmin[:, :, None] * mn[:, :, None]
    return y.reshape(-1)[:n]


def _deq_q6_k(blocks: np.ndarray, n: int) -> np.ndarray:
    # block: ql[128], qh[64], scales[16] int8, d f16
    b = blocks.reshape(-1, QK_K // 2 + QK_K // 4 + 16 + 2)
    ql = b[:, :128].reshape(-1, 2, 64)            # [nb, half, 64]
    qh = b[:, 128:192].reshape(-1, 2, 32)         # [nb, half, 32]
    scales = b[:, 192:208].view(np.int8).astype(np.float32)  # [nb, 16]
    d = _f16(b[:, 208:210].reshape(-1))[:, None]
    l32 = np.arange(32)
    out = np.empty((b.shape[0], 2, 128), np.float32)
    sidx = np.empty((2, 128), np.int64)
    for h in (0, 1):
        qlh, qhh = ql[:, h], qh[:, h]
        q1 = (qlh[:, :32] & 0x0F) | (((qhh >> 0) & 3) << 4)
        q2 = (qlh[:, 32:] & 0x0F) | (((qhh >> 2) & 3) << 4)
        q3 = (qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)
        q4 = (qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)
        out[:, h] = np.concatenate(
            [q1, q2, q3, q4], axis=1
        ).astype(np.float32) - 32.0
        sidx[h] = 8 * h + np.concatenate(
            [l32 // 16, 2 + l32 // 16, 4 + l32 // 16, 6 + l32 // 16]
        )
    y = d[:, None] * scales[:, sidx.reshape(-1)].reshape(-1, 2, 128) * out
    return y.reshape(-1)[:n]


# ggml type id → (bytes per block, elements per block, dequantizer)
_DEQUANT: Dict[int, Tuple[int, int, object]] = {
    0: (4, 1, None),                               # f32
    1: (2, 1, None),                               # f16
    30: (2, 1, None),                              # bf16
    2: (2 + QK // 2, QK, _deq_q4_0),
    3: (4 + QK // 2, QK, _deq_q4_1),
    6: (2 + 4 + QK // 2, QK, _deq_q5_0),
    7: (4 + 4 + QK // 2, QK, _deq_q5_1),
    8: (2 + QK, QK, _deq_q8_0),
    12: (2 + 2 + 12 + QK_K // 2, QK_K, _deq_q4_k),
    13: (2 + 2 + 12 + QK_K // 8 + QK_K // 2, QK_K, _deq_q5_k),
    14: (QK_K // 2 + QK_K // 4 + 16 + 2, QK_K, _deq_q6_k),
}


def tensor_nbytes(info: GgufTensorInfo) -> int:
    if info.ggml_type not in _DEQUANT:
        raise GgufError(
            f"tensor {info.name!r} has unsupported ggml type "
            f"{info.type_name} ({info.ggml_type})"
        )
    block_bytes, block_elems, _ = _DEQUANT[info.ggml_type]
    n = int(np.prod(info.shape)) if info.shape else 1
    if n % block_elems:
        raise GgufError(
            f"tensor {info.name!r}: {n} elements not divisible by "
            f"{info.type_name} block size {block_elems}"
        )
    return n // block_elems * block_bytes


def dequantize(info: GgufTensorInfo, raw: np.ndarray) -> np.ndarray:
    """Raw tensor bytes → numpy array in the tensor's LOGICAL layout.

    GGUF's ne[] lists the contiguous dim first, so the numpy shape is
    ``reversed(info.shape)`` — for a llama.cpp matmul weight that comes
    out as the familiar [out_features, in_features].
    """
    n = int(np.prod(info.shape)) if info.shape else 1
    block_bytes, block_elems, fn = _DEQUANT[info.ggml_type]
    if fn is None:
        dt = {0: "<f4", 1: "<f2", 30: "<u2"}[info.ggml_type]
        flat = raw.view(dt)
        if info.ggml_type == 30:  # bf16: widen via the exponent trick
            flat = (flat.astype(np.uint32) << 16).view(np.float32)
        flat = flat.astype(np.float32)
    else:
        flat = fn(raw, n)
    return flat.reshape(tuple(reversed(info.shape)) if info.shape else ())


def iter_gguf_tensors(
    path: str, g: GgufFile
) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (name, float32 ndarray) without staging the whole file."""
    with open(path, "rb") as f, mmap.mmap(
        f.fileno(), 0, access=mmap.ACCESS_READ
    ) as mm:
        buf = raw = None
        try:
            buf = np.frombuffer(mm, dtype=np.uint8)
            for info in g.tensors:
                start = g.data_offset + info.offset
                end = start + tensor_nbytes(info)
                if end > buf.size:
                    raise GgufError(
                        f"tensor {info.name!r} data [{start}, {end}) "
                        f"exceeds file size {buf.size}"
                    )
                raw = buf[start:end]
                yield info.name, dequantize(info, raw)
        finally:
            # dequantize returns copies; drop OUR views of the mmap so
            # closing it doesn't hit "exported pointers exist"
            del buf, raw
