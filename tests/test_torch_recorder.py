"""The port's KV event recorder against the reference's.

- the same events published on each package's in-process hub are recorded
  as the same JSONL lines (``{"ts", "event"}``, the event's wire dict;
  exact but for the wall time);
- a file the port records replays into the reference's indexer, and a
  file the reference records into the port's (native and plain trees),
  with equal scores and frequencies on every chain (exact);
- ``max_bytes`` rotates the file to ``<path>.<unix seconds>`` (``.<n>``
  past the first rotation of a second) and the files hold every event
  once, in order; ``stop`` closes the handle.
"""

import asyncio
import json
import random

import pytest

from dynamo_tpu.kv_router.indexer import KvIndexer as RefIndexer
from dynamo_tpu.kv_router.publisher import KvEventPublisher as RefPublisher
from dynamo_tpu.kv_router.recorder import KvRecorder as RefRecorder
from dynamo_tpu.kv_router.recorder import iter_recorded_events as ref_iter
from dynamo_tpu.kv_router.recorder import replay_events as ref_replay
from dynamo_tpu.runtime.component import DistributedRuntime as RefDrt
from dynamo_tpu.runtime.transports.memory import MemoryHub as RefHub
from dynamo_tpu_torch.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.kv_router.protocols import KV_EVENT_SUBJECT
from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher
from dynamo_tpu_torch.kv_router.recorder import (
    KvRecorder,
    iter_recorded_events,
    replay_events,
)
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
from dynamo_tpu_torch.tokens import compute_block_hashes

TIMEOUT_S = 30
BLOCK = 4


def _stream(seed, n_events=60):
    """Seeded (worker, kind, hashes, parent) events over a few chains, and
    the chains to score against."""
    rng = random.Random(seed)
    chains = [compute_block_hashes([rng.randrange(500) for _ in
                                    range(BLOCK * rng.randrange(2, 9))], BLOCK)
              for _ in range(6)]
    events = []
    for _ in range(n_events):
        worker, chain = f"w{rng.randrange(3)}", rng.choice(chains)
        if rng.random() < 0.75:
            start = rng.randrange(len(chain))
            end = rng.randrange(start, len(chain)) + 1
            events.append((worker, "stored", chain[start:end],
                           chain[start - 1] if start else None))
        else:
            events.append((worker, "removed",
                           rng.sample(chain, rng.randrange(1, len(chain) + 1)),
                           None))
    return chains, events


async def _record(pkg, path, events, max_bytes=None, raw_events=None):
    """Record ``events`` (published by per-worker publishers) or
    ``raw_events`` (wire dicts published on the subject as they are) with
    the package's recorder; returns the recorder's count."""
    hub_cls, drt_cls, rec_cls, pub_cls = pkg
    drt = drt_cls.in_process(hub_cls())
    comp = drt.namespace("rec").component("backend")
    rec = await rec_cls(comp, path, max_bytes=max_bytes).start()
    want = 0
    if raw_events is not None:
        for ev in raw_events:
            await comp.publish_event(KV_EVENT_SUBJECT, ev)
        want = len(raw_events)
    else:
        pubs = {}
        for worker, kind, hashes, parent in events:
            pub = pubs.get(worker)
            if pub is None:
                pub = pubs[worker] = pub_cls(comp, worker)
                pub.start()
            if kind == "stored":
                pub.publish_stored(hashes, parent)
            else:
                pub.publish_removed(hashes)
        want = len(events)
    for _ in range(2000):  # the recorder has written what was published
        if rec.count >= want:
            break
        await asyncio.sleep(0.005)
    await rec.stop()
    assert rec._fh is None and rec._io is None
    await drt.close()
    return rec.count


PORT = (MemoryHub, DistributedRuntime, KvRecorder, KvEventPublisher)
REF = (RefHub, RefDrt, RefRecorder, RefPublisher)


def _scores(indexer, chains):
    out = []
    for chain in chains:
        for q in (chain[:1], chain):
            m = indexer.find_matches(q)
            out.append((m.scores, m.frequencies))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("recorded_by", ["port", "reference"])
def test_a_recorded_file_replays_into_either_package(tmp_path, seed, recorded_by):
    chains, events = _stream(seed)
    path = str(tmp_path / "events.jsonl")
    pkg = PORT if recorded_by == "port" else REF
    n = asyncio.run(asyncio.wait_for(_record(pkg, path, events), TIMEOUT_S))
    assert n == len(events)
    indexers = {"native": KvIndexer(BLOCK), "plain": KvIndexer(BLOCK, use_native=False),
                "reference": RefIndexer(BLOCK, use_native=False)}
    counts = {"native": replay_events(path, indexers["native"]),
              "plain": replay_events(path, indexers["plain"]),
              "reference": ref_replay(path, indexers["reference"])}
    assert set(counts.values()) == {len(events)}
    want = _scores(indexers["reference"], chains)
    assert _scores(indexers["native"], chains) == want
    assert _scores(indexers["plain"], chains) == want
    assert any(s for s, _ in want)  # the stream left holders to score
    assert [e.to_wire() for e in iter_recorded_events(path)] == [
        e.to_wire() for e in ref_iter(path)]
    # events in publish order per worker, with the workers' own ids
    by_worker = {}
    for e in iter_recorded_events(path):
        by_worker.setdefault(e.worker_id, []).append(e.event_id)
    assert all(ids == sorted(ids) for ids in by_worker.values())


def test_the_same_events_make_the_same_lines(tmp_path):
    _, events = _stream(7, n_events=20)
    raw = [dict(worker_id=w, event_id=i, **(
        {"stored": {"block_hashes": h, "parent_hash": p}} if kind == "stored"
        else {"removed": {"block_hashes": h}}))
        for i, (w, kind, h, p) in enumerate(events)]
    raw.append(dict(worker_id="w0", event_id=99, tier="cold",
                    stored={"block_hashes": [2**64 - 1, 5], "parent_hash": None}))
    lines = {}
    for name, pkg in (("port", PORT), ("reference", REF)):
        path = str(tmp_path / f"{name}.jsonl")
        asyncio.run(asyncio.wait_for(
            _record(pkg, path, None, raw_events=raw), TIMEOUT_S))
        with open(path) as f:
            lines[name] = [json.loads(line) for line in f]
    assert [sorted(rec) for rec in lines["port"]] == [["event", "ts"]] * len(raw)
    assert ([rec["event"] for rec in lines["port"]]
            == [rec["event"] for rec in lines["reference"]] == raw)


def _rotation_key(p):
    """``<name>.<seconds>[.<n>]`` in rotation order."""
    parts = p.name[len("events.jsonl."):].split(".")
    return int(parts[0]), int(parts[1]) if len(parts) > 1 else 0


@pytest.mark.parametrize("max_bytes", [1500, 6000])
def test_max_bytes_rotates_and_keeps_every_event(tmp_path, max_bytes):
    """Rotations within one second each keep their file (the reference's
    rename would overwrite the previous one: ROADMAP §3), and the files in
    rotation order hold every event once, in order."""
    chains, events = _stream(3, n_events=40)
    path = tmp_path / "events.jsonl"
    n = asyncio.run(asyncio.wait_for(
        _record(PORT, str(path), events, max_bytes=max_bytes), TIMEOUT_S))
    assert n == len(events)
    rotated = sorted((p for p in tmp_path.iterdir() if p.name != "events.jsonl"),
                     key=_rotation_key)
    assert rotated and all(p.name.startswith("events.jsonl.") for p in rotated)
    files = rotated + [path]
    recorded = [e for p in files for e in iter_recorded_events(str(p))]
    assert len(recorded) == len(events)
    assert all(p.stat().st_size <= max_bytes + 400 for p in rotated)
    both, ref = KvIndexer(BLOCK), RefIndexer(BLOCK, use_native=False)
    for p in files:
        replay_events(str(p), both)
        ref_replay(str(p), ref)
    assert _scores(both, chains) == _scores(ref, chains)
    seen = {}
    for e in recorded:
        seen.setdefault(e.worker_id, []).append(e.event_id)
    assert all(ids == list(range(1, len(ids) + 1)) for ids in seen.values())


def test_timed_replay_sleeps_the_recorded_gaps(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    ev = {"worker_id": "w", "event_id": 1, "removed": {"block_hashes": [1]}}
    path.write_text("".join(json.dumps({"ts": t, "event": ev}) + "\n"
                            for t in (10.0, 10.25, 13.0)) + "\n")
    slept = []
    monkeypatch.setattr("dynamo_tpu_torch.kv_router.recorder.time.sleep",
                        slept.append)
    assert replay_events(str(path), KvIndexer(BLOCK), timed=True) == 3
    assert slept == [0.25, 1.0]
