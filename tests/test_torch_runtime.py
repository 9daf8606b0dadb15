"""The port's distributed runtime against the reference's.

The scenarios of the reference's ``tests/test_runtime.py`` run on the
port's modules (the in-process hub and a real dynstore TCP server), and
the two packages are wired together: the port's broker serves the
reference's ``DistributedRuntime.connect`` clients and the reverse, and a
worker of one package streams a dial-back response to a client of the
other. Every test runs its own event loop under its own timeout; every
server binds port 0.
"""

import asyncio
import types

import pytest

import dynamo_tpu.runtime as ref_rt
import dynamo_tpu_torch.runtime as port_rt
from dynamo_tpu.runtime.client import Client as RefClient
from dynamo_tpu.runtime.transports.dynstore import DynStoreServer as RefServer
from dynamo_tpu.runtime.transports.memory import MemoryHub as RefHub
from dynamo_tpu_torch.runtime.client import Client as PortClient
from dynamo_tpu_torch.runtime.messaging import subject_matches
from dynamo_tpu_torch.runtime.transports.dynstore import DynStoreServer as PortServer
from dynamo_tpu_torch.runtime.transports.memory import MemoryHub as PortHub
from dynamo_tpu_torch.runtime.wire import unpackb

TIMEOUT_S = 30


def _ns(mod, client, server, hub):
    return types.SimpleNamespace(
        Context=mod.Context, DistributedRuntime=mod.DistributedRuntime,
        EngineError=mod.EngineError, NoInstancesError=mod.NoInstancesError,
        ResponseStreamError=mod.ResponseStreamError,
        RouterMode=mod.RouterMode, Client=client, Server=server, Hub=hub)


PORT = _ns(port_rt, PortClient, PortServer, PortHub)
REF = _ns(ref_rt, RefClient, RefServer, RefHub)


def run(coro, timeout=TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def echo_handler_for(rt):
    async def echo_handler(payload, ctx):
        for tok in payload["text"].split():
            yield {"tok": tok}
    return echo_handler


async def slow_handler(payload, ctx):
    for i in range(1000):
        if ctx.is_stopped:
            yield {"done": "stopped"}
            return
        yield {"i": i}
        await asyncio.sleep(0.005)


def failing_handler_for(rt):
    async def failing_handler(payload, ctx):
        raise rt.EngineError("model not loaded")
        yield  # pragma: no cover
    return failing_handler


# ------------------------------------------------ the reference's scenarios


def test_roundtrip_in_memory():
    async def main():
        drt = port_rt.DistributedRuntime.in_process(PortHub())
        ep = drt.namespace("test").component("worker").endpoint("generate")
        serving = await ep.serve(echo_handler_for(PORT))
        client = await PortClient(ep).start()
        await client.wait_for_instances(1)
        out = [item["tok"] async for item in
               client.generate(port_rt.Context({"text": "hello tpu world"}))]
        await serving.stop()
        await drt.close()
        return out

    assert run(main()) == ["hello", "tpu", "world"]


def test_round_robin_across_instances():
    async def main():
        drt = port_rt.DistributedRuntime.in_process(PortHub())
        ep = drt.namespace("test").component("worker").endpoint("gen")
        hits = {"a": 0, "b": 0}

        def make(name):
            async def h(payload, ctx):
                hits[name] += 1
                yield {"from": name}
            return h

        s1 = await ep.serve(make("a"), instance_id="ia")
        s2 = await ep.serve(make("b"), instance_id="ib")
        client = await PortClient(ep, port_rt.RouterMode.ROUND_ROBIN).start()
        await client.wait_for_instances(2)
        for _ in range(6):
            async for _item in client.generate(port_rt.Context({})):
                pass
        six = dict(hits)
        rec = await client.direct({}, "ia")
        async for _ in rec:
            pass
        await s1.stop()
        await s2.stop()
        await drt.close()
        return six, hits

    six, hits = run(main())
    assert six == {"a": 3, "b": 3}
    assert hits["a"] == 4


def test_no_instances_error_and_error_prologue():
    async def main():
        drt = port_rt.DistributedRuntime.in_process(PortHub())
        ep = drt.namespace("t").component("c").endpoint("e")
        client = await PortClient(ep).start()
        with pytest.raises(port_rt.NoInstancesError):
            async for _ in client.generate(port_rt.Context({})):
                pass
        serving = await ep.serve(failing_handler_for(PORT))
        await client.wait_for_instances(1)
        with pytest.raises(port_rt.ResponseStreamError, match="model not loaded"):
            async for _ in client.generate(port_rt.Context({})):
                pass
        await serving.stop()
        await drt.close()

    run(main())


def test_stop_generating_propagates():
    async def main():
        drt = port_rt.DistributedRuntime.in_process(PortHub())
        ep = drt.namespace("t").component("c").endpoint("e")
        serving = await ep.serve(slow_handler)
        client = await PortClient(ep).start()
        await client.wait_for_instances(1)
        ctx_req = port_rt.Context({})
        received = []
        async for item in client.generate(ctx_req):
            received.append(item)
            if len(received) == 3:
                ctx_req.context.stop_generating()
        await serving.stop()
        await drt.close()
        return received

    received = run(main())
    assert received[-1] == {"done": "stopped"}
    assert len(received) < 100


def test_lease_expiry_removes_instance():
    async def main():
        hub = PortHub()
        drt = port_rt.DistributedRuntime.in_process(hub)
        ep = drt.namespace("t").component("c").endpoint("e")
        serving = await ep.serve(echo_handler_for(PORT))
        client = await PortClient(ep).start()
        await client.wait_for_instances(1)
        before = len(client.instances)
        lease = await drt.discovery.primary_lease()
        hub.expire_lease(lease.id)  # simulate worker death
        await asyncio.sleep(0.01)
        after = len(client.instances)
        await serving.stop()
        await drt.close()
        return before, after

    assert run(main()) == (1, 0)


def test_work_queue_ack_and_redelivery():
    async def main():
        drt = port_rt.DistributedRuntime.in_process(PortHub())
        m = drt.messaging
        await m.queue_push("q", b"job1")
        item = await m.queue_pop("q", timeout=1.0, visibility=0.05)
        first = item.payload
        await asyncio.sleep(0.1)  # no ack → redelivered
        item2 = await m.queue_pop("q", timeout=1.0, visibility=0.05)
        second = item2.payload
        item2.ack()
        await asyncio.sleep(0.1)
        depth = await m.queue_depth("q")
        await drt.close()
        return first, second, depth

    assert run(main()) == (b"job1", b"job1", 0)


def test_stats_scrape():
    async def main():
        drt = port_rt.DistributedRuntime.in_process(PortHub())
        ep = drt.namespace("t").component("c").endpoint("e")
        serving = await ep.serve(echo_handler_for(PORT),
                                 stats_handler=lambda: {"load": 0.5})
        client = await PortClient(ep).start()
        await client.wait_for_instances(1)
        async for _ in client.generate(port_rt.Context({"text": "x"})):
            pass
        stats = await client.scrape_stats()
        await serving.stop()
        await drt.close()
        return stats

    stats = run(main())
    assert len(stats) == 1
    info = next(iter(stats.values()))
    assert info["requests_total"] == 1 and info["data"] == {"load": 0.5}


def test_subject_matching_is_the_references():
    from dynamo_tpu.runtime.messaging import subject_matches as ref_matches

    cases = [("a.b", "a.b"), ("a.*", "a.b"), ("a.*", "a.b.c"), ("a.>", "a.b.c"),
             ("a.>", "a"), ("*.b", "x.b"), ("a.b.c", "a.b"), ("_stats.>", "_stats.x.y")]
    for pattern, subject in cases:
        assert subject_matches(pattern, subject) == ref_matches(pattern, subject)


# ---------- dynstore: real TCP servers, clients of either package ----------

# (server, worker, client): the port alone, then every mix with the reference
MIXES = {"port": (PORT, PORT, PORT), "port_server_ref_clients": (PORT, REF, REF),
         "ref_server_port_clients": (REF, PORT, PORT),
         "port_worker_ref_client": (PORT, PORT, REF),
         "ref_worker_port_client": (REF, REF, PORT)}


@pytest.mark.parametrize("mix", list(MIXES))
def test_dynstore_end_to_end(mix):
    """A broker of one package, a worker and a client of either: the
    dial-back stream, kv put/get, pub/sub and a work queue across them."""
    srv_ns, w_ns, c_ns = MIXES[mix]

    async def main():
        server = srv_ns.Server(port=0)
        await server.start()
        try:
            worker_drt = await w_ns.DistributedRuntime.connect(port=server.port)
            client_drt = await c_ns.DistributedRuntime.connect(port=server.port)
            ep_w = worker_drt.namespace("prod").component("w").endpoint("gen")
            serving = await ep_w.serve(echo_handler_for(w_ns))
            ep_c = client_drt.namespace("prod").component("w").endpoint("gen")
            client = await c_ns.Client(ep_c).start()
            await client.wait_for_instances(1)
            out = [item["tok"] async for item in
                   client.generate(c_ns.Context({"text": "over real tcp"}))]
            await client_drt.discovery.kv_put("cfg/threshold", b"123")
            kv = await worker_drt.discovery.kv_get("cfg/threshold")
            sub = await worker_drt.messaging.subscribe("events.kv")
            await client_drt.messaging.publish("events.kv", b"stored")
            msg = await asyncio.wait_for(sub.__anext__(), 2.0)
            await client_drt.messaging.queue_push("prefill", b"req-1")
            item = await worker_drt.messaging.queue_pop("prefill", timeout=2.0)
            item.ack()
            stats = await client.scrape_stats()
            await serving.stop()
            await worker_drt.close()
            await client_drt.close()
            return out, kv, msg.payload, item.payload, stats
        finally:
            await server.stop()

    out, kv, payload, job, stats = run(main())
    assert out == ["over", "real", "tcp"]
    assert (kv, payload, job) == (b"123", b"stored", b"req-1")
    assert [s["requests_total"] for s in stats.values()] == [1]


@pytest.mark.parametrize("mix", ["port", "port_server_ref_clients",
                                 "ref_server_port_clients"])
def test_dynstore_conn_drop_expires_lease(mix):
    """Worker death (its connection dropped, no reconnect): the broker
    expires its lease at once and the watching client drops the instance."""
    srv_ns, w_ns, c_ns = MIXES[mix]

    async def main():
        server = srv_ns.Server(port=0)
        await server.start()
        try:
            worker_drt = await w_ns.DistributedRuntime.connect(port=server.port)
            watcher_drt = await c_ns.DistributedRuntime.connect(port=server.port)
            ep = worker_drt.namespace("p").component("w").endpoint("g")
            await ep.serve(echo_handler_for(w_ns))
            ep2 = watcher_drt.namespace("p").component("w").endpoint("g")
            client = await c_ns.Client(ep2).start()
            await client.wait_for_instances(1)
            worker_drt.discovery.reconnect = False
            worker_drt.discovery._writer.close()
            for _ in range(100):
                if not client.instances:
                    break
                await asyncio.sleep(0.02)
            left = len(client.instances)
            await watcher_drt.close()
            return left
        finally:
            await server.stop()

    assert run(main()) == 0


def test_dynstore_lease_ttl_expires_a_silent_worker():
    """A lease whose keepalives stop (the connection stays up) expires
    after its TTL on the port's broker; a live keepalive keeps it."""

    async def main():
        server = PortServer(port=0)
        await server.start()
        try:
            drt = await port_rt.DistributedRuntime.connect(port=server.port)
            live = await drt.discovery.grant_lease(ttl=1.0)
            silent = await drt.discovery.grant_lease(ttl=0.5)
            drt.discovery._keepalive_tasks.pop(silent.id).cancel()
            await drt.discovery.kv_put("k/live", b"1", lease_id=live.id)
            await drt.discovery.kv_put("k/silent", b"1", lease_id=silent.id)
            # 3 of the live lease's TTLs (its keepalive runs every third of
            # one; the reaper every 0.5 s)
            await asyncio.sleep(3.0)
            kvs = await drt.discovery.kv_get_prefix("k/")
            await drt.close()
            return sorted(kvs)
        finally:
            await server.stop()

    assert run(main()) == ["k/live"]


def test_dynstore_broker_restart_graph_keeps_serving():
    """Kill and restart the port's broker under an active graph: the
    clients reconnect, re-register and re-arm, and requests flow again."""

    async def main():
        server = PortServer(port=0)
        await server.start()
        port = server.port
        worker_drt = await port_rt.DistributedRuntime.connect(port=port)
        client_drt = await port_rt.DistributedRuntime.connect(port=port)
        try:
            ep_w = worker_drt.namespace("prod").component("w").endpoint("gen")
            serving = await ep_w.serve(echo_handler_for(PORT))
            ep_c = client_drt.namespace("prod").component("w").endpoint("gen")
            client = await PortClient(ep_c).start()
            await client.wait_for_instances(1)
            sub = await client_drt.messaging.subscribe("events.test")
            before = [t["tok"] async for t in
                      client.generate(port_rt.Context({"text": "before restart"}))]
            await server.stop()
            await asyncio.sleep(0.2)
            server = PortServer(port=port)
            await server.start()
            await client.wait_for_instances(1)
            after = [t["tok"] async for t in
                     client.generate(port_rt.Context({"text": "after restart"}))]
            await worker_drt.messaging.publish("events.test", b"again")
            msg = await asyncio.wait_for(sub.__anext__(), 5.0)
            await serving.stop()
            return before, after, msg.payload
        finally:
            await worker_drt.close()
            await client_drt.close()
            await server.stop()

    assert run(main()) == (["before", "restart"], ["after", "restart"], b"again")


def test_registration_record_reads_in_both_packages():
    """An endpoint's discovery record written by the port decodes with
    msgpack as the reference's (and the reverse), u64-safe."""
    import msgpack

    async def main():
        out = {}
        for name, ns in (("port", PORT), ("ref", REF)):
            drt = ns.DistributedRuntime.in_process(ns.Hub())
            ep = drt.namespace("n").component("c").endpoint("e")
            serving = await ep.serve(echo_handler_for(ns),
                                     metadata={"model": "m", "h": 2 ** 64 - 1})
            kvs = await drt.discovery.kv_get_prefix("n/components/c/endpoints/")
            out[name] = next(iter(kvs.values()))
            await serving.stop()
            await drt.close()
        return out

    out = run(main())
    a, b = unpackb(out["ref"]), msgpack.unpackb(out["port"], raw=False)
    assert set(a) == set(b) == {"instance_id", "subject", "worker_id", "model", "h"}
    assert a["h"] == b["h"] == 2 ** 64 - 1
