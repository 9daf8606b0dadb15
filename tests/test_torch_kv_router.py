"""The port's KV router against the reference's.

- the reference's ``tests/test_kv_router.py`` scenarios on the port's
  modules (radix tree, orphan parents, sharding, the cost function, the
  staleness bound, a routed request over the in-process hub);
- ``RadixTree`` / ``KvIndexer`` fed the same seeded event streams as the
  reference's pure-Python tree: the same scores, frequencies and sizes
  after every event;
- ``KvScheduler`` decisions under a seeded ``random.Random`` equal to the
  reference's under ``random.seed`` of the same seed;
- the wire forms of events and metrics read by the other package;
- the processor's re-route when the router's choice is gone, and the
  model registration a frontend's ``ModelWatcher`` reads.
"""

import asyncio
import random

import msgpack
import numpy as np
import pytest

from dynamo_tpu.kv_router.indexer import KvIndexer as RefIndexer
from dynamo_tpu.kv_router.indexer import OverlapScores as RefOverlap
from dynamo_tpu.kv_router.protocols import ForwardPassMetrics as RefMetrics
from dynamo_tpu.kv_router.protocols import KvCacheRemoved as RefRemoved
from dynamo_tpu.kv_router.protocols import KvCacheStored as RefStored
from dynamo_tpu.kv_router.protocols import RouterEvent as RefEvent
from dynamo_tpu.kv_router.scheduler import KvScheduler as RefScheduler
from dynamo_tpu_torch.kv_router.indexer import KvIndexer, OverlapScores, ShardedKvIndexer
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheRemoved,
    KvCacheStored,
    RouterEvent,
)
from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher, KvMetricsPublisher
from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.kv_router.scheduler import AllWorkersBusy, KvScheduler
from dynamo_tpu_torch.llm.processor import KvRoutedClient
from dynamo_tpu_torch.protocols.common import PreprocessedRequest, StopConditions
from dynamo_tpu_torch.runtime.client import Client
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub
from dynamo_tpu_torch.runtime.wire import packb, unpackb
from dynamo_tpu_torch.tokens import compute_block_hashes

TIMEOUT_S = 30


def stored(worker, hashes, parent=None):
    return RouterEvent(worker_id=worker, stored=KvCacheStored(hashes, parent))


def removed(worker, hashes):
    return RouterEvent(worker_id=worker, removed=KvCacheRemoved(hashes))


# ------------------------------------------------ the reference's scenarios


def test_radix_tree_match_and_remove():
    idx = KvIndexer(block_size=4)
    h = compute_block_hashes(list(range(16)), 4)  # 4 blocks
    idx.apply_event(stored("w1", h))
    idx.apply_event(stored("w2", h[:2]))
    scores = idx.find_matches(h)
    assert scores.scores == {"w1": 4, "w2": 2}
    assert scores.frequencies == [2, 2, 1, 1]
    other = compute_block_hashes(list(range(8)) + [99] * 8, 4)
    assert idx.find_matches(other).scores == {"w1": 2, "w2": 2}
    idx.apply_event(removed("w1", [h[1]]))
    scores3 = idx.find_matches(h)
    assert scores3.scores["w1"] == 1 and scores3.scores["w2"] == 2
    idx.remove_worker("w2")
    assert "w2" not in idx.find_matches(h).scores


def test_radix_tree_orphan_parent():
    idx = KvIndexer(block_size=4)
    idx.apply_event(stored("w1", [111, 222], parent=999))  # 999 never stored
    assert idx.find_matches([111, 222]).scores == {"w1": 2}


def test_sharded_indexer_merges():
    idx = ShardedKvIndexer(num_shards=3, block_size=4)
    h = compute_block_hashes(list(range(12)), 4)
    for w in ("a", "b", "c", "d"):
        idx.apply_event(stored(w, h[:2] if w == "d" else h))
    scores = idx.find_matches(h)
    assert scores.scores["a"] == 3 and scores.scores["d"] == 2
    idx.remove_worker("a")
    assert "a" not in idx.find_matches(h).scores


def _metrics(active, total, blocks, cap):
    return ForwardPassMetrics(request_active_slots=active,
                              request_total_slots=total,
                              kv_active_blocks=blocks, kv_total_blocks=cap)


def test_scheduler_cost_function():
    sched = KvScheduler(block_size=4)
    sched.update_metrics("idle", _metrics(0, 8, 0, 100))
    sched.update_metrics("busy", _metrics(8, 8, 90, 100))
    assert sched.schedule(16, OverlapScores()).worker_id == "idle"
    d2 = sched.schedule(16, OverlapScores(scores={"busy": 4}))
    assert d2.worker_id == "busy" and d2.prefix_hit_tokens == 16
    before = sched.workers["idle"].predicted_active
    sched.schedule(16, OverlapScores())
    assert sched.workers["idle"].predicted_active == before + 1


def test_scheduler_all_busy_and_no_metrics():
    with pytest.raises(AllWorkersBusy, match="no workers with metrics"):
        KvScheduler(block_size=4).schedule(4, OverlapScores())
    sched = KvScheduler(block_size=4, require_free_slot=True)
    sched.update_metrics("w", _metrics(8, 8, 0, 10))
    with pytest.raises(AllWorkersBusy):
        sched.schedule(4, OverlapScores())


def test_scheduler_staleness_bound():
    t = {"now": 0.0}
    sched = KvScheduler(block_size=4, staleness_bound_s=2.0, clock=lambda: t["now"])
    sched.update_metrics("wedged", _metrics(0, 8, 0, 100))
    sched.update_metrics("alive", _metrics(6, 8, 50, 100))
    assert sched.schedule(16, OverlapScores()).worker_id == "wedged"
    t["now"] = 5.0
    sched.update_metrics("alive", _metrics(6, 8, 50, 100))
    assert sched.schedule(16, OverlapScores()).worker_id == "alive"
    assert sched.stale_skips == 1
    # every snapshot stale: route on old data, no skip counted
    t2 = {"now": 0.0}
    sched2 = KvScheduler(block_size=4, staleness_bound_s=1.0, clock=lambda: t2["now"])
    sched2.update_metrics("w1", _metrics(0, 8, 0, 10))
    t2["now"] = 60.0
    assert sched2.schedule(4, OverlapScores()).worker_id == "w1"
    assert sched2.stale_skips == 0
    # no bound: trusted forever
    sched3 = KvScheduler(block_size=4, clock=lambda: 1e6)
    sched3.update_metrics("w1", _metrics(0, 8, 0, 10))
    assert sched3.schedule(4, OverlapScores()).worker_id == "w1"


def test_kv_router_end_to_end_over_hub():
    """Two token-level workers publish KV events + metrics; the router sends
    a request with a matching prefix to the worker holding it, and a dead
    worker's index entries go with its lease."""

    async def main():
        hub = MemoryHub()
        w1_drt, w2_drt, r_drt = (DistributedRuntime.in_process(hub) for _ in range(3))
        served = {"w-one": 0, "w-two": 0}

        def make_worker(drt, instance_id):
            ep = drt.namespace("prod").component("backend").endpoint("generate")

            async def handler(payload, ctx):
                served[instance_id] += 1
                req = PreprocessedRequest.from_wire(payload)
                yield {"token_ids": [req.token_ids[0]], "finish_reason": "length"}

            return ep, handler, _metrics(0, 4, 10, 100)

        pubs, servings = {}, {}
        for drt, iid in ((w1_drt, "w-one"), (w2_drt, "w-two")):
            ep, h, m = make_worker(drt, iid)
            pubs[iid] = KvEventPublisher(ep.component, iid)
            pubs[iid].start()
            servings[iid] = await ep.serve(
                h, instance_id=iid,
                stats_handler=KvMetricsPublisher(m.to_wire).stats_handler)
        r_ep = r_drt.namespace("prod").component("backend").endpoint("generate")
        client = Client(r_ep)
        router = await KvRouter(r_ep.component, client, block_size=4,
                                poll_interval=0.02).start()
        await client.wait_for_instances(2)
        prompt = list(range(100, 116))
        hashes = compute_block_hashes(prompt, 4)
        pubs["w-two"].publish_stored(hashes, None)
        # wait on observable state: the event applied and both workers scraped
        while not (router.indexer.events_applied == 1
                   and len(router.scheduler.workers) == 2):
            await asyncio.sleep(0.01)
        scores = router.indexer.find_matches(hashes).scores
        routed = KvRoutedClient(client, router)
        req = PreprocessedRequest(token_ids=prompt,
                                  stop_conditions=StopConditions(max_tokens=1))
        outs = [o async for o in routed.generate(Context(req))]
        stats = router.stats()
        await servings["w-two"].stop()
        hub.expire_lease((await w2_drt.discovery.primary_lease()).id)
        while "w-two" in router.indexer.find_matches(hashes).scores:
            await asyncio.sleep(0.01)
        await router.stop()
        await servings["w-one"].stop()
        for d in (w1_drt, w2_drt, r_drt):
            await d.close()
        return scores, outs, dict(served), stats, pubs["w-two"].published

    scores, outs, served, stats, published = asyncio.run(
        asyncio.wait_for(main(), TIMEOUT_S))
    assert scores == {"w-two": 4}
    assert outs and served == {"w-one": 0, "w-two": 1}
    assert stats["decisions"] == 1 and stats["events_applied"] == 1
    assert stats["event_lag_ms"]["n"] == 1 and published == 1


# ---------------------------------------- seeded streams against the reference


def _event_stream(seed, n_events=300, workers=("w0", "w1", "w2"), bs=4):
    """Seeded stored / removed events over a few shared prompt families:
    chained hashes of real token blocks, parents known, unknown and
    absent, removals of stored and unknown blocks, and whole-worker drops."""
    rng = np.random.default_rng(seed)
    families = [list(rng.integers(0, 50, 40)) for _ in range(4)]
    chains = [compute_block_hashes([int(t) for t in f], bs) for f in families]
    held = {w: [] for w in workers}
    out = []
    for _ in range(n_events):
        w = workers[int(rng.integers(len(workers)))]
        r = rng.random()
        if r < 0.55:
            c = chains[int(rng.integers(len(chains)))]
            a = int(rng.integers(0, len(c)))
            b = int(rng.integers(a + 1, len(c) + 1))
            parent = c[a - 1] if a > 0 else None
            if rng.random() < 0.05:
                parent = 12345  # an unknown parent: rooted standalone
            out.append(("stored", w, c[a:b], parent))
            held[w].extend(c[a:b])
        elif r < 0.9 and held[w]:
            k = int(rng.integers(1, min(4, len(held[w])) + 1))
            picks = [held[w][int(i)] for i in rng.choice(len(held[w]), k)]
            if rng.random() < 0.1:
                picks.append(999)  # never stored
            out.append(("removed", w, picks, None))
        elif r > 0.97:
            out.append(("drop", w, None, None))
            held[w] = []
    return out, chains


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indexer_matches_reference_on_seeded_streams(seed):
    events, chains = _event_stream(seed)
    ref = RefIndexer(block_size=4, use_native=False)
    port = KvIndexer(block_size=4)
    queries = [c[:k] for c in chains for k in (1, 3, len(c))]
    for kind, w, hashes, parent in events:
        if kind == "drop":
            ref.remove_worker(w)
            port.remove_worker(w)
        elif kind == "stored":
            ref.apply_event(RefEvent(worker_id=w, stored=RefStored(list(hashes), parent)))
            port.apply_event(stored(w, list(hashes), parent))
        else:
            ref.apply_event(RefEvent(worker_id=w, removed=RefRemoved(list(hashes))))
            port.apply_event(removed(w, list(hashes)))
        assert len(port.tree) == len(ref.tree)
        assert port.worker_ids == ref.worker_ids
        for q in queries:
            a, b = port.find_matches(q), ref.find_matches(q)
            assert (a.scores, a.frequencies) == (b.scores, b.frequencies)
    assert port.events_applied == ref.events_applied


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_decisions_match_reference_under_a_seeded_random(seed):
    """The same metrics refreshes and overlaps: every decision (worker,
    matched blocks, predicted loads, the pull hint's blocks) equals the
    reference's, ties broken by ``random.Random(seed)`` against
    ``random.seed(seed)``; the runs include exact ties (identical idle
    workers). The pull hint's owner equals the reference's where one
    worker holds the longest prefix; among tied owners the port's is the
    first in the overlap's order, the reference's whichever its set of
    worker ids yields first under this process's hash seed."""
    rng = np.random.default_rng(100 + seed)
    workers = [f"w{i}" for i in range(4)]
    ref = RefScheduler(block_size=4, clock=lambda: 0.0)
    port = KvScheduler(block_size=4, clock=lambda: 0.0, rng=random.Random(seed))
    random.seed(seed)
    for step in range(60):
        if step % 10 == 0:
            for w in workers:
                tie = rng.random() < 0.5
                vals = dict(request_active_slots=0 if tie else int(rng.integers(0, 8)),
                            request_total_slots=8,
                            kv_active_blocks=0 if tie else int(rng.integers(0, 100)),
                            kv_total_blocks=100)
                ref.update_metrics(w, RefMetrics(**vals))
                port.update_metrics(w, ForwardPassMetrics(**vals))
        isl = int(rng.integers(1, 64))
        scores = {w: int(rng.integers(0, 5)) for w in workers if rng.random() < 0.3}
        a = port.schedule(isl, OverlapScores(scores=dict(scores)))
        b = ref.schedule(isl, RefOverlap(scores=dict(scores)))
        assert (a.worker_id, a.matched_blocks, a.prefix_hit_tokens,
                a.best_prefix_blocks) == (
            b.worker_id, b.matched_blocks, b.prefix_hit_tokens,
            b.best_prefix_blocks), step
        owners = [w for w, n in scores.items()
                  if n > 0 and n == max(scores.values())]
        assert a.best_prefix_worker == (owners[0] if owners else None), step
        if len(owners) < 2:
            assert a.best_prefix_worker == b.best_prefix_worker, step
        else:
            assert b.best_prefix_worker in owners, step
        assert {w: (s.predicted_active, s.predicted_blocks)
                for w, s in port.workers.items()} == {
            w: (s.predicted_active, s.predicted_blocks)
            for w, s in ref.workers.items()}


def test_event_and_metrics_wire_forms_cross_the_packages():
    """A port event's wire dict (u64 hashes, the publisher's ``ts`` key)
    reads as the reference's ``RouterEvent`` and the reverse; the metrics
    too."""
    h = [2 ** 64 - 1, 2 ** 63, 7]
    ev = RouterEvent(worker_id="w", stored=KvCacheStored(h, 2 ** 63 + 5),
                     event_id=9)
    wire = dict(ev.to_wire(), ts=1.5)
    back = RefEvent.from_wire(msgpack.unpackb(packb(wire), raw=False))
    assert back.stored.block_hashes == h and back.stored.parent_hash == 2 ** 63 + 5
    ref_ev = RefEvent(worker_id="w", removed=RefRemoved(h), event_id=3)
    mine = RouterEvent.from_wire(unpackb(msgpack.packb(ref_ev.to_wire(),
                                                       use_bin_type=True)))
    assert mine == RouterEvent(worker_id="w", removed=KvCacheRemoved(h), event_id=3)
    m = ForwardPassMetrics(request_active_slots=2, kv_total_blocks=9,
                           gpu_prefix_cache_hit_rate=0.25)
    assert RefMetrics.from_wire(unpackb(packb(m.to_wire()))).to_wire() == m.to_wire()
    # a publisher's stats handler keeps the engine's extra keys
    extra = KvMetricsPublisher(lambda: dict(m.to_wire(), prefix_hit_tokens=64)
                               ).stats_handler()
    assert extra["prefix_hit_tokens"] == 64 and extra["kv_total_blocks"] == 9


def test_processor_reroutes_when_the_chosen_worker_is_gone():
    """The router's choice names a worker that left discovery between its
    last scrape and the dispatch: ``KvRoutedClient`` drops the choice and
    lets the client's own mode pick a live instance (reference
    ``llm/processor.py:80-90``); a router that cannot decide falls back to
    the client's mode too."""
    from dynamo_tpu_torch.kv_router.scheduler import SchedulingDecision

    class StaleRouter:
        def __init__(self, worker_id):
            self.worker_id = worker_id
            self.calls = 0

        async def schedule(self, token_ids, trace_id=None, model=None):
            self.calls += 1
            if self.worker_id is None:
                raise AllWorkersBusy("no workers with metrics")
            return SchedulingDecision(self.worker_id, 0, 0, len(token_ids))

        async def stop(self):
            pass

    async def main():
        hub = MemoryHub()
        drt = DistributedRuntime.in_process(hub)
        ep = drt.namespace("p").component("backend").endpoint("generate")

        async def handler(payload, ctx):
            yield {"token_ids": [7], "finish_reason": "length", "from": "live"}

        serving = await ep.serve(handler, instance_id="w-live")
        client = await Client(ep).start()
        await client.wait_for_instances(1)
        req = PreprocessedRequest(token_ids=[1, 2, 3],
                                  stop_conditions=StopConditions(max_tokens=1))
        out = {}
        for name, router in (("gone", StaleRouter("w-gone")),
                             ("busy", StaleRouter(None))):
            routed = KvRoutedClient(client, router)
            out[name] = ([o["from"] async for o in routed.generate(Context(req))],
                         router.calls)
        await serving.stop()
        await drt.close()
        return out

    out = asyncio.run(asyncio.wait_for(main(), TIMEOUT_S))
    assert out == {"gone": (["live"], 1), "busy": (["live"], 1)}


def test_model_registration_and_endpoint_paths():
    """``register_model`` writes a lease-scoped record that ``list_models``
    reads back and the reference's msgpack decodes; ``parse_endpoint_path``
    takes the ``dyn://`` prefix or not and refuses anything but three
    parts; the record goes with its lease."""
    from dynamo_tpu.http.service import parse_endpoint_path as ref_parse
    from dynamo_tpu_torch.http.service import (
        list_models,
        model_registry_key,
        parse_endpoint_path,
        register_model,
    )

    for path in ("dyn://ns.comp.ep", "ns.comp.ep"):
        assert parse_endpoint_path(path) == ref_parse(path) == ("ns", "comp", "ep")
    for bad in ("dyn://a.b", "a.b.c.d"):
        with pytest.raises(ValueError, match="want dyn://ns.comp.ep"):
            parse_endpoint_path(bad)

    async def main():
        hub = MemoryHub()
        drt = DistributedRuntime.in_process(hub)
        await register_model(drt, "ns", "tiny", "dyn://ns.processor.chat",
                             model_type="both", mdc={"context_length": 256})
        listed = await list_models(drt, "ns")
        raw = await drt.discovery.kv_get(model_registry_key("ns", "both", "tiny"))
        hub.expire_lease((await drt.discovery.primary_lease()).id)
        after = await list_models(drt, "ns")
        await drt.close()
        return listed, raw, after

    listed, raw, after = asyncio.run(asyncio.wait_for(main(), TIMEOUT_S))
    want = {"name": "tiny", "endpoint": "dyn://ns.processor.chat",
            "model_type": "both", "mdc": {"context_length": 256}}
    assert listed == [want] and msgpack.unpackb(raw, raw=False) == want
    assert after == []
