"""The port's wire codec (``dynamo_tpu_torch/runtime/wire.py``) against
``msgpack``, the reference's: byte for byte on pack, value for value on
unpack, by hypothesis over the types the runtime sends, plus the edges of
every length and integer form, u64 sequence hashes, the errors, and the
4-byte framing over a real stream."""

import asyncio
import math

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime.transports import dynstore as ref_dynstore
from dynamo_tpu_torch.runtime import wire

# what msgpack.packb takes and the runtime sends: nil, bool, ints of the
# 64-bit range (u64 included), float64, str, bytes, arrays and maps
scalars = (st.none() | st.booleans()
           | st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text() | st.binary())
keys = st.text() | st.binary() | st.integers(-(2 ** 63), 2 ** 64 - 1) | st.booleans()
values = st.recursive(
    scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text() | st.binary(), inner, max_size=20)),
    max_leaves=60)


def _ref_unpack(data):
    return msgpack.unpackb(data, raw=False)


@settings(max_examples=300, deadline=None)
@given(values)
def test_pack_is_msgpack_bytes_and_unpack_is_msgpack_value(obj):
    """Bytes equal ``msgpack.packb(obj, use_bin_type=True)``; unpacking
    those bytes gives what ``msgpack.unpackb(raw=False)`` gives (tuples
    come back as lists)."""
    data = wire.packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    assert wire.unpackb(data) == _ref_unpack(data)


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(keys, st.integers(0, 3), max_size=6))
def test_map_keys_follow_strict_map_key(obj):
    """Packing takes any key; unpacking refuses a key that is not str or
    bytes, as msgpack's strict_map_key does, and otherwise agrees."""
    data = wire.packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    try:
        want = _ref_unpack(data)
    except ValueError:
        with pytest.raises(ValueError, match="not allowed for map key"):
            wire.unpackb(data)
    else:
        assert wire.unpackb(data) == want


# every boundary of every length and integer form
INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129,
             -32768, -32769, -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63)]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("n", INT_EDGES)
def test_int_forms_at_every_edge(n):
    data = wire.packb(n)
    assert data == msgpack.packb(n, use_bin_type=True)
    assert wire.unpackb(data) == n and type(wire.unpackb(data)) is int


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["str", "bin", "array", "map"])
def test_length_forms_at_every_edge(kind, n):
    obj = {"str": "x" * n, "bin": b"\x01" * n, "array": [0] * n,
           "map": {f"k{i}": i for i in range(n)}}[kind]
    data = wire.packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    assert wire.unpackb(data) == _ref_unpack(data)


def test_u64_sequence_hashes_stay_unsigned():
    """A sequence hash above 2**63 goes out as uint64 (0xcf) and comes back
    as the same positive Python int, in a router event's shape."""
    h = 0xF0E1D2C3B4A59687
    event = {"worker_id": "w-1", "event_id": 3,
             "stored": {"block_hashes": [h, 5], "parent_hash": h}}
    data = wire.packb(event)
    assert data == msgpack.packb(event, use_bin_type=True)
    assert bytes([0xCF]) + h.to_bytes(8, "big") in data
    back = wire.unpackb(data)
    assert back == event and back["stored"]["parent_hash"] == h > 0


def test_floats_nan_inf_and_float32():
    for x in (math.inf, -math.inf, -0.0, 1e-310):
        assert wire.packb(x) == msgpack.packb(x, use_bin_type=True)
    nan = wire.unpackb(wire.packb(math.nan))
    assert nan != nan
    f32 = msgpack.packb(1.5, use_single_float=True)
    assert wire.unpackb(f32) == _ref_unpack(f32) == 1.5


def test_errors_match_msgpack():
    for bad in (object(), {1, 2}, 1j):
        with pytest.raises(TypeError):
            msgpack.packb(bad)
        with pytest.raises(TypeError):
            wire.packb(bad)
    for big in (2 ** 64, -(2 ** 63) - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(big)
        with pytest.raises(OverflowError):
            wire.packb(big)
    data = wire.packb([1, 2])
    with pytest.raises(ValueError):
        wire.unpackb(data + b"\x00")   # extra data
    with pytest.raises(ValueError):
        wire.unpackb(data[:-1])        # incomplete
    ext = msgpack.packb(msgpack.ExtType(1, b"ab"))
    with pytest.raises(ValueError, match="ext"):
        wire.unpackb(ext)


def test_framing_round_trips_between_the_packages():
    """``write_frame`` of one package is read by ``read_frame`` of the other
    over a real TCP stream; a truncated frame reads as None."""

    async def main():
        got = {}

        async def serve(reader, writer):
            got["ref"] = await ref_dynstore.read_frame(reader)
            got["port"] = await wire.read_frame(reader)
            got["end"] = await wire.read_frame(reader)
            writer.close()

        server = await asyncio.start_server(serve, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        frame = {"op": "kv_put", "id": 7, "key": "a/b", "value": b"\x00\xff",
                 "lease": 2 ** 64 - 1}
        wire.write_frame(writer, frame)
        ref_dynstore.write_frame(writer, dict(frame, id=8))
        writer.write((100).to_bytes(4, "big") + b"short")
        await writer.drain()
        writer.close()
        for _ in range(100):
            if "end" in got:
                break
            await asyncio.sleep(0.01)
        server.close()
        await server.wait_closed()
        return got, frame

    got, frame = asyncio.run(asyncio.wait_for(main(), 10))
    assert got["ref"] == frame
    assert got["port"] == dict(frame, id=8)
    assert got["end"] is None
