"""The port's native host core against its plain versions and the
reference's.

- ``compute_block_hashes`` (native) equals ``compute_block_hashes_plain``
  and the reference's ``dynamo_tpu.tokens.compute_block_hashes`` over
  seeded prompts at block sizes 1, 16 and 64, the 12,000-token prompt
  included; ids outside uint32 are refused alike in a complete block and
  ignored alike in the ragged tail (exact);
- ``NativeRadixTree`` against the port's ``RadixTree``, the reference's
  ``RadixTree`` and the reference's ``NativeRadixTree`` on seeded event
  streams (stored, removed, ``remove_worker``, early exit), expiry and
  ``clear_expired`` (exact scores, frequencies and sizes);
- ``KvIndexer`` defaults to the native tree, ``use_native=False`` gives the
  plain one, and the cold-tier extension is the same over either;
- the ``CApi`` round trip (events equal the reference's C ABI's);
- a compiler that fails (``CXX=false``) makes the first call raise with
  the compiler's output, and nothing hashes or indexes in Python after it;
  processes racing the first build all load the one library.
"""

import random
import time

import numpy as np
import pytest
import xxhash

from dynamo_tpu import native as ref_native
from dynamo_tpu import tokens as ref_tokens
from dynamo_tpu.kv_router.indexer import KvIndexer as RefIndexer
from dynamo_tpu.kv_router.indexer import RadixTree as RefTree
from dynamo_tpu.kv_router.protocols import KvCacheRemoved as RefRemoved
from dynamo_tpu.kv_router.protocols import KvCacheStored as RefStored
from dynamo_tpu.kv_router.protocols import RouterEvent as RefEvent
from dynamo_tpu_torch import native, tokens
from dynamo_tpu_torch.kv_router import indexer as port_indexer
from dynamo_tpu_torch.kv_router.indexer import KvIndexer, RadixTree, ShardedKvIndexer
from dynamo_tpu_torch.kv_router.protocols import KvCacheRemoved, KvCacheStored, RouterEvent
from dynamo_tpu_torch.ops import _build

VOCAB = 271_680  # the largest vocabulary a served config has (fits uint32)


def _ref_plain_hashes(ids, block_size, seed=ref_tokens.ROUTER_SEED):
    """The reference's pure-Python loop (its native dispatch switched off)."""
    saved = ref_tokens._native_hashes, ref_tokens._native_checked
    try:
        ref_tokens._native_hashes, ref_tokens._native_checked = None, True
        return ref_tokens.compute_block_hashes(ids, block_size, seed)
    finally:
        ref_tokens._native_hashes, ref_tokens._native_checked = saved


# ---------------------------------------------------------------- hashing


@pytest.mark.parametrize("block_size", [1, 16, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_block_hashes_equal_plain_and_reference(block_size, seed):
    rng = np.random.default_rng(seed)
    for n in (0, block_size - 1, block_size, 3 * block_size + 5,
              int(rng.integers(1, 600))):
        ids = rng.integers(0, VOCAB, max(n, 0)).tolist()
        salt = int(rng.integers(0, 2**63))
        got = tokens.compute_block_hashes(ids, block_size, salt)
        assert got == native.compute_block_hashes(ids, block_size, salt)
        assert got == tokens.compute_block_hashes_plain(ids, block_size, salt)
        assert got == ref_tokens.compute_block_hashes(ids, block_size, salt)
        assert got == _ref_plain_hashes(ids, block_size, salt)
        assert len(got) == len(ids) // block_size


def test_the_12000_token_prompt_hashes_equal_natively_and_plainly():
    ids = np.random.default_rng(12000).integers(0, VOCAB, 12000)
    for arg in (ids.tolist(), ids, ids.astype(np.int32)):
        got = tokens.compute_block_hashes(arg, 16)
        assert len(got) == 750
        assert got == tokens.compute_block_hashes_plain(arg, 16)
        assert got == ref_tokens.compute_block_hashes(ids.tolist(), 16)


def test_ids_outside_uint32_are_refused_alike_in_a_block_and_ignored_in_the_tail():
    base = list(range(32))
    for bad in (2**32, -1, 2**40):
        in_block = base[:7] + [bad] + base[8:]
        with pytest.raises(OverflowError):
            tokens.compute_block_hashes(in_block, 16)
        with pytest.raises(OverflowError):
            tokens.compute_block_hashes_plain(in_block, 16)
        with pytest.raises(OverflowError):
            _ref_plain_hashes(in_block, 16)
        tail = base + [bad]  # 33 ids: the 33rd is in no complete block
        got = tokens.compute_block_hashes(tail, 16)
        assert got == tokens.compute_block_hashes_plain(tail, 16)
        assert got == _ref_plain_hashes(tail, 16) == _ref_plain_hashes(base, 16)
    # an integer array's values wrap as astype wraps them, in both
    wrapped = np.array(base[:15] + [-1] + base[16:], dtype=np.int64)
    assert (tokens.compute_block_hashes(wrapped, 16)
            == tokens.compute_block_hashes_plain(wrapped, 16)
            == _ref_plain_hashes(wrapped, 16))


def test_native_xxh64_equals_the_plain_one_and_xxhash():
    rng = random.Random(42)
    for _ in range(200):
        data = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 300)))
        seed = rng.randrange(2**64)
        want = xxhash.xxh64_intdigest(data, seed=seed)
        assert native.xxh64(data, seed) == tokens.xxh64_intdigest(data, seed) == want


# ------------------------------------------------------------ radix trees


def _random_events(rng, n_workers=4, n_events=300, block_size=4):
    """A seeded stored/removed event stream and the chains it is cut from."""
    chains = []
    for _ in range(12):
        toks = [rng.randrange(1000) for _ in range(block_size * rng.randrange(1, 9))]
        chains.append(tokens.compute_block_hashes_plain(toks, block_size))
    events = []
    for eid in range(n_events):
        worker = f"w{rng.randrange(n_workers)}"
        chain = rng.choice(chains)
        if rng.random() < 0.7:
            start = rng.randrange(len(chain))
            end = rng.randrange(start, len(chain)) + 1
            parent = chain[start - 1] if start > 0 else None
            events.append(("stored", worker, eid, chain[start:end], parent))
        else:
            k = rng.randrange(1, len(chain) + 1)
            events.append(("removed", worker, eid, rng.sample(chain, k), None))
    return chains, events


def _as(event, ev_cls, stored_cls, removed_cls):
    kind, worker, eid, hashes, parent = event
    if kind == "stored":
        return ev_cls(worker_id=worker, event_id=eid,
                      stored=stored_cls(block_hashes=hashes, parent_hash=parent))
    return ev_cls(worker_id=worker, event_id=eid,
                  removed=removed_cls(block_hashes=hashes))


class _RefNative:
    """The reference's C++ tree behind the same surface as the others."""

    def __init__(self, expiration_s=None):
        self.tree = ref_native.NativeRadixTree(expiration_s)

    def apply_event(self, ev):
        if ev.stored is not None:
            self.tree.apply_stored(ev.worker_id, ev.stored.parent_hash,
                                   ev.stored.block_hashes)
        if ev.removed is not None:
            self.tree.apply_removed(ev.worker_id, ev.removed.block_hashes)

    def find_matches(self, hashes, early_exit=False):
        return self.tree.find_matches(hashes, early_exit)

    def __getattr__(self, name):
        return getattr(self.tree, name)

    def __len__(self):
        return len(self.tree)


def _trees(expiration_s=None):
    """(name, tree, event classes) of the four trees held against each other."""
    port = (RouterEvent, KvCacheStored, KvCacheRemoved)
    ref = (RefEvent, RefStored, RefRemoved)
    return [
        ("native", port_indexer._NativeTreeAdapter(expiration_s), port),
        ("plain", RadixTree(expiration_s), port),
        ("reference", RefTree(expiration_s), ref),
        ("reference_native", _RefNative(expiration_s), ref),
    ]


def _matches(tree, hashes, early_exit=False):
    out = tree.find_matches(hashes, early_exit=early_exit)
    if isinstance(out, tuple):
        return out
    return out.scores, out.frequencies


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_native_tree_equals_the_plain_and_reference_trees(seed):
    rng = random.Random(seed)
    chains, events = _random_events(rng)
    trees = _trees()
    for i, event in enumerate(events):
        for _, tree, classes in trees:
            tree.apply_event(_as(event, *classes))
        if i % 25 == 0 or i == len(events) - 1:
            sizes = {name: len(tree) for name, tree, _ in trees}
            assert len(set(sizes.values())) == 1, (i, sizes)
            for chain in chains:
                for qlen in (1, len(chain) // 2 + 1, len(chain)):
                    for early in (False, True):
                        got = {name: _matches(tree, chain[:qlen], early)
                               for name, tree, _ in trees}
                        assert all(g == got["reference"] for g in got.values()), (
                            i, qlen, early, got)
    for worker in ("w0", "w2"):
        for _, tree, _ in trees:
            tree.remove_worker(worker)
        assert len({len(tree) for _, tree, _ in trees}) == 1
        for chain in chains:
            got = {name: _matches(tree, chain) for name, tree, _ in trees}
            assert all(g == got["reference"] for g in got.values()), got


def test_expiry_and_clear_expired_agree_across_the_trees():
    chain = tokens.compute_block_hashes(list(range(16)), 4)
    trees = _trees(expiration_s=0.05)
    for _, tree, (ev, st, _) in trees:
        tree.apply_event(ev(worker_id="w", stored=st(chain)))
        assert _matches(tree, chain) == ({"w": 4}, [1, 1, 1, 1])
    time.sleep(0.1)
    for _, tree, _ in trees:
        assert _matches(tree, chain) == ({}, [])
    # every tree counts the one expired leaf and, as the reference's, keeps
    # it: a node with a holder is never pruned
    cleared = {name: tree.clear_expired() for name, tree, _ in trees}
    assert set(cleared.values()) == {1}, cleared
    assert {len(tree) for _, tree, _ in trees} == {4}
    for _, tree, (ev, _, rm) in trees:
        tree.apply_event(ev(worker_id="w", removed=rm(chain[3:])))
    assert {len(tree) for _, tree, _ in trees} == {3}


def test_early_exit_extends_a_single_holder_down_the_chain():
    chain = tokens.compute_block_hashes(list(range(32)), 4)
    other = tokens.compute_block_hashes(list(range(8)) + [7] * 24, 4)
    for _, tree, (ev, st, _) in _trees():
        tree.apply_event(ev(worker_id="solo", stored=st(chain)))
        tree.apply_event(ev(worker_id="pair", stored=st(other[:2])))
        assert _matches(tree, chain, True) == ({"solo": 8, "pair": 2},
                                               [2, 2, 1, 1, 1, 1, 1, 1])
        assert _matches(tree, other, True) == ({"solo": 2, "pair": 2}, [2, 2])


# ------------------------------------------------------------- the indexer


def test_kv_indexer_takes_the_native_tree_by_default():
    idx = KvIndexer(block_size=4)
    assert isinstance(idx.tree, port_indexer._NativeTreeAdapter)
    assert all(isinstance(s.tree, port_indexer._NativeTreeAdapter)
               for s in ShardedKvIndexer(3, block_size=4).shards)
    assert isinstance(KvIndexer(block_size=4, use_native=False).tree, RadixTree)


@pytest.mark.parametrize("use_native", [True, False])
def test_cold_extension_is_the_same_over_either_tree(use_native):
    """A warm run on one worker, cold spill advertisements on it and on a
    respawned one: the same warm and cold scores as the reference's."""
    chain = tokens.compute_block_hashes(list(range(40)), 4)
    got = KvIndexer(block_size=4, use_native=use_native)
    want = RefIndexer(block_size=4, use_native=False)
    for idx, (ev, st, rm) in ((got, (RouterEvent, KvCacheStored, KvCacheRemoved)),
                              (want, (RefEvent, RefStored, RefRemoved))):
        idx.apply_event(ev(worker_id="a", stored=st(chain[:3])))
        idx.apply_event(ev(worker_id="a", stored=st(chain[3:7], chain[2]),
                           tier="cold"))
        idx.apply_event(ev(worker_id="b", stored=st(chain[:5]), tier="cold"))
        idx.apply_event(ev(worker_id="b", removed=rm(chain[4:5]), tier="cold"))
    for q in (chain, chain[:4], chain[:1]):
        g, w = got.find_matches(q), want.find_matches(q)
        assert (g.scores, g.frequencies, g.cold_scores) == (
            w.scores, w.frequencies, w.cold_scores)
    assert got.find_matches(chain).cold_scores == {"a": 4, "b": 4}


def test_processes_racing_the_first_build_load_one_library(tmp_path):
    """Four processes (the test run's workers) build into one fresh
    directory at once (at -O0, to keep the suite's load down): each hashes
    natively, one library is left and no temporary file."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    build = tmp_path / "_build"
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from pathlib import Path\n"
        "from dynamo_tpu_torch.ops import _build\n"
        "from dynamo_tpu_torch import tokens\n"
        "_build.BUILD_DIR = Path(sys.argv[2])\n"
        "_build.CXX_FLAGS = [f for f in _build.CXX_FLAGS if f != '-O2'] + ['-O0']\n"
        "ids = list(range(100))\n"
        "assert tokens.compute_block_hashes(ids, 16) == "
        "tokens.compute_block_hashes_plain(ids, 16)\n"
        "print('ok')\n")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(repo),
                               str(build)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all(out.strip() == "ok" for out, _ in outs)
    assert len(list(build.glob("native-*.so"))) == 1
    assert not list(build.glob("*.tmp"))


# --------------------------------------------------------------- the C ABI


def _capi_events(mod):
    """One fixed publish sequence through a package's C ABI: pushed events
    (sink), pulled ones (drain) and the status codes."""
    capi = mod.CApi()

    def pull_mode():
        if mod is native:
            capi.set_sink(None)
        else:  # the reference's set_sink(None) raises (ROADMAP §3)
            capi._lib.dt_capi_set_sink(mod._SINK_CFUNC(), None)
            capi._sink_ref = None

    rcs = [capi.publish_removed(1, [5])]  # not initialised: 1
    rcs.append(capi.init("ns", "comp", 'w"\\7\n', kv_block_size=4))
    try:
        rcs.append(capi.init("ns", "comp", "again", kv_block_size=4))  # 1
        got = []
        capi.set_sink(got.append)
        rcs.append(capi.publish_stored(1, list(range(12))))
        parent = got[0]["stored"]["block_hashes"][-1]
        rcs.append(capi.publish_stored(2, list(range(12, 16)), parent_hash=parent))
        rcs.append(capi.publish_removed(3, [1, 2, 3]))
        rcs.append(capi.publish_stored(4, [1, 2]))  # no complete block: 2
        pull_mode()
        rcs.append(capi.publish_removed(5, list(range(5000))))
        pulled = [capi.drain(cap=64), capi.drain(cap=64)]
        return rcs, got, pulled, capi.dropped_events()
    finally:
        capi.shutdown()


def test_capi_round_trip_equals_the_reference_abi():
    rcs, got, pulled, dropped = _capi_events(native)
    assert (rcs, got, pulled, dropped) == _capi_events(ref_native)
    assert rcs == [1, 0, 1, 0, 0, 0, 2, 0]
    events = [RouterEvent.from_wire(e) for e in got]
    assert events[0].worker_id == 'w"\\7\n' and events[0].event_id == 1
    assert events[0].stored.block_hashes == tokens.compute_block_hashes(
        list(range(12)), 4)
    assert events[1].stored.block_hashes == tokens.compute_block_hashes(
        list(range(16)), 4)[-1:]
    assert events[2].removed.block_hashes == [1, 2, 3]
    assert pulled[0]["removed"]["block_hashes"] == list(range(5000))
    assert pulled[1] is None and dropped == 0


def test_capi_set_sink_none_returns_to_pull_mode():
    """The port's ``set_sink(None)`` passes a NULL sink (the reference's
    raises ``ctypes.ArgumentError``: ROADMAP §3), after which events queue
    for ``drain``."""
    capi = native.CApi()
    assert capi.init("ns", "comp", "w0", kv_block_size=4) == 0
    try:
        got = []
        capi.set_sink(got.append)
        capi.set_sink(None)
        assert capi._sink_ref is None
        assert capi.publish_removed(1, [9]) == 0
        assert got == [] and capi.drain()["removed"]["block_hashes"] == [9]
    finally:
        capi.shutdown()
    ref = ref_native.CApi()
    with pytest.raises(Exception, match="CFunctionType"):
        ref.set_sink(None)


# ---------------------------------------------------- a build that fails


SHARED_BUILD_DIR = _build.BUILD_DIR


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """No library loaded or built: the next call builds into ``tmp_path``."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "_build"


def test_a_failed_build_raises_with_the_compiler_output(fresh_build, monkeypatch,
                                                         tmp_path):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'broken-cxx: cannot compile' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="broken-cxx: cannot compile"):
        tokens.compute_block_hashes(list(range(32)), 16)
    assert not list(fresh_build.glob("*.so")) and not list(fresh_build.glob("*.tmp"))


@pytest.mark.parametrize("entry", ["hash", "indexer", "tree", "capi"])
def test_cxx_false_makes_the_first_call_raise_and_nothing_falls_back(
        fresh_build, monkeypatch, entry):
    monkeypatch.setenv("CXX", "false")
    call = {
        "hash": lambda: tokens.compute_block_hashes(list(range(32)), 16),
        "indexer": lambda: KvIndexer(block_size=16),
        "tree": lambda: native.NativeRadixTree(),
        "capi": lambda: native.CApi(),
    }[entry]
    for _ in range(2):  # no failure is remembered as "use Python"
        with pytest.raises(RuntimeError, match=r"native \(false .* exit 1\)"):
            call()
    assert native._lib is None
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="cannot run 'no-such-compiler-xyz'"):
        call()
    # the compiler restored, the same call loads (or builds) the shared
    # library and answers natively
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(_build, "BUILD_DIR", SHARED_BUILD_DIR)
    call()
    assert native._lib is not None
    assert not list(fresh_build.glob("native-*.so"))


def test_the_library_is_named_by_sources_compiler_and_flags(monkeypatch):
    base = _build.library_path("native")
    assert base == _build.library_path("native")
    monkeypatch.setenv("CXX", "g++")
    assert _build.library_path("native") != base
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(_build, "CXX_FLAGS", _build.CXX_FLAGS + ["-g"])
    assert _build.library_path("native") != base
    deps = []
    for src in _build.HOST_SOURCES["native"]:
        _build._sources(_build.CSRC / src, deps)
    assert [p.name for p in deps] == ["indexer.cc", "xxhash64.h", "capi.cc"]
