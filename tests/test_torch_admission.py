"""The port's HTTP-edge admission control against the reference's.

- ``parse_priority`` over the same header values as the reference's
  (exact);
- one scripted sequence (limits, queue depth, deadlines, shed levels,
  draining, priorities, a cancelled waiter, ``set_limit``) through the
  port's and the reference's ``AdmissionController`` gives the same
  grants in the same order, the same rejections with the same
  ``retry_after_header`` values, the same snapshots and the same
  ``dynamo_planner_*`` samples (exact; the queue-wait histogram's counts
  only, its sums are wall time);
- through each package's ``HttpService`` over its echo engine: the 429
  status, ``Retry-After`` header and JSON error body of a full queue and
  of a shed class are the reference's, and ``X-Priority`` orders the
  grants; through the port's: a queued request whose client goes away
  gives its place back (the reference's aiohttp front, whose handlers are
  not cancelled on a disconnect, keeps it queued until a grant or its
  deadline);
- the recovery controller closes the edge's admission on a drain and
  reopens it on a successful respawn, as the reference's does.
"""

import asyncio
import json

import aiohttp
import pytest

from dynamo_tpu.http import service as ref_service
from dynamo_tpu.llm.engines.echo import EchoEngineFull as RefEcho
from dynamo_tpu.planner import admission as ref_admission
from dynamo_tpu.recovery.controller import RecoveryController as RefController
from dynamo_tpu_torch.http import service as port_service
from dynamo_tpu_torch.llm.engines.echo import EchoEngineFull
from dynamo_tpu_torch.planner import admission
from dynamo_tpu_torch.recovery.controller import RecoveryController

TIMEOUT_S = 30


@pytest.mark.parametrize("value", [
    None, "", "high", "HIGH", " low ", "normal", "0", "1", "2", "3", "-1",
    "urgent", "2.0", "１"])
def test_parse_priority_matches_the_reference(value):
    assert admission.parse_priority(value) == ref_admission.parse_priority(value)
    assert admission.PRIORITY_CLASSES == ref_admission.PRIORITY_CLASSES


def _samples(registry):
    """The controller's instruments as (name{labels}, value) lines; the
    queue-wait histogram by its counts (its sums are wall time)."""
    out = []
    for line in registry.render().splitlines():
        if line.startswith("#") or not line.startswith("dynamo_planner_"):
            continue
        if "_queue_wait_seconds_sum" in line:
            continue
        if "_queue_wait_seconds_bucket" in line and 'le="+Inf"' not in line:
            continue
        out.append(line)
    return sorted(out)


async def _script(mod):
    """The same operations on one package's controller; returns the trace."""
    ctl = mod.AdmissionController(mod.AdmissionConfig(
        limit=2, queue_depth=1, queue_timeout_s=0.3, retry_after_s=1.5))
    trace, grants = [], []

    async def ask(tag, priority):
        try:
            await ctl.acquire(priority, request_id=tag)
            grants.append(tag)
            return "admitted"
        except mod.AdmissionRejected as e:
            trace.append((tag, e.outcome, e.retry_after_header, str(e)))
            return e.outcome

    async def settle():
        for _ in range(5):
            await asyncio.sleep(0)

    def spawn(tag, priority):
        return asyncio.ensure_future(ask(tag, priority))

    # two admitted, one queued a class, the second of a class turned away
    await ask("n1", 1)
    await ask("n2", 1)
    low, high = spawn("l1", 0), spawn("h1", 2)
    await settle()
    await ask("l2", 0)
    await ask("h2", 2)
    trace.append(("depths", ctl.queue_depth(0), ctl.queue_depth(2),
                  ctl.inflight, ctl.snapshot()))
    ctl.release()  # the high class first
    await settle()
    ctl.release()
    await settle()
    assert await high == "admitted" and await low == "admitted"
    # shedding: the low class at the door and out of the queue
    queued_low = spawn("l3", 0)
    await settle()
    ctl.set_shed_level(1)
    await settle()
    await ask("l4", 0)
    trace.append(("shed", await queued_low, ctl.snapshot()))
    ctl.set_shed_level(0)
    # draining: every class at the door and out of the queue
    queued_high = spawn("h3", 2)
    await settle()
    ctl.set_draining(True)
    await settle()
    await ask("h4", 2)
    trace.append(("drain", await queued_high, ctl.draining))
    ctl.set_draining(False)
    # a deadline, then a waiter whose client went away
    await ask("n3", 1)
    cancelled = spawn("n4", 1)
    await settle()
    cancelled.cancel()
    await settle()
    trace.append(("cancelled", cancelled.cancelled(), ctl.queue_depth()))
    # a wider limit grants the queued at once
    queued = [spawn("n5", 1), spawn("h5", 2)]
    await settle()
    ctl.set_limit(4)
    await settle()
    trace.append(("widened", [await t for t in queued], ctl.inflight))
    for _ in range(ctl.inflight):
        ctl.release()
    trace.append(("end", ctl.inflight, ctl.queue_depth(), ctl.snapshot(),
                  ctl.shed_total))
    return trace, grants, _samples(ctl.registry)


def test_a_scripted_sequence_decides_as_the_reference():
    got = asyncio.run(asyncio.wait_for(_script(admission), TIMEOUT_S))
    want = asyncio.run(asyncio.wait_for(_script(ref_admission), TIMEOUT_S))
    assert got == want
    trace, grants, samples = got
    assert grants[:4] == ["n1", "n2", "h1", "l1"]
    outcomes = [t[1] for t in trace if t[0] in ("l2", "h2", "l3", "l4", "h3", "h4")]
    assert outcomes == ["queue_full", "queue_full", "shed", "shed",
                        "draining", "draining"]
    assert all(t[2] == "2" for t in trace if t[0].startswith(("l", "h")))
    assert 'dynamo_planner_admissions_total{outcome="queue_full",priority="high"} 1.0' in samples


async def _timeout_script(mod):
    ctl = mod.AdmissionController(mod.AdmissionConfig(
        limit=1, queue_depth=4, queue_timeout_s=0.05, retry_after_s=0.2))
    await ctl.acquire(1)
    try:
        await ctl.acquire(2, request_id="late")
    except mod.AdmissionRejected as e:
        got = (e.outcome, e.retry_after_header, str(e))
    ctl.release()
    return got, ctl.inflight, ctl.queue_depth(), _samples(ctl.registry)


def test_a_queue_deadline_rejects_as_the_reference():
    got = asyncio.run(_timeout_script(admission))
    assert got == asyncio.run(_timeout_script(ref_admission))
    assert got[0][:2] == ("timeout", "1") and got[1:3] == (0, 0)


# ---------------------------------------------------------------- the edge


async def _start(svc, echo, **kw):
    manager = svc.ModelManager()
    manager.add_chat_model("echo", echo())
    service = svc.HttpService(manager, host="127.0.0.1", port=0, **kw)
    await service.start()
    return service


def _chat(words, **kw):
    return dict(model="echo", stream=True,
                messages=[{"role": "user", "content": " ".join(["w"] * words)}],
                **kw)


async def _edge_script(svc, mod, echo):
    """limit 1, one queued a class: a holder streams, a high and a low
    request queue, the next low is turned away (queue full); the grants
    follow X-Priority; then the low class is shed."""
    ctl = mod.AdmissionController(mod.AdmissionConfig(
        limit=1, queue_depth=1, queue_timeout_s=20.0, retry_after_s=2.5))
    service = await _start(svc, echo, admission=ctl)
    url = f"http://127.0.0.1:{service.port}/v1/chat/completions"
    order, answers = [], {}
    try:
        async with aiohttp.ClientSession() as s:
            async def ask(tag, words, priority=None):
                headers = {} if priority is None else {"X-Priority": priority}
                async with s.post(url, json=_chat(words), headers=headers) as r:
                    body = await r.read()
                    order.append(tag)
                    answers[tag] = (r.status, r.headers.get("Retry-After"),
                                    None if r.status == 200 else json.loads(body))

            holder = asyncio.ensure_future(ask("holder", 30))
            while ctl.inflight < 1:
                await asyncio.sleep(0.005)
            low = asyncio.ensure_future(ask("low", 2, "low"))
            while ctl.queue_depth(0) < 1:
                await asyncio.sleep(0.005)
            high = asyncio.ensure_future(ask("high", 2, "high"))
            while ctl.queue_depth(2) < 1:
                await asyncio.sleep(0.005)
            await ask("full", 2, "0")
            await asyncio.gather(holder, low, high)
            ctl.set_shed_level(1)
            await ask("shed", 2, "low")
            await ask("kept", 2, "normal")
    finally:
        await service.stop()
    return order, answers, _samples(ctl.registry)


@pytest.mark.asyncio
async def test_the_edge_answers_429s_and_orders_grants_as_the_reference(monkeypatch):
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "10")
    got = await asyncio.wait_for(
        _edge_script(port_service, admission, EchoEngineFull), TIMEOUT_S)
    want = await asyncio.wait_for(
        _edge_script(ref_service, ref_admission, RefEcho), TIMEOUT_S)
    assert got == want
    order, answers, samples = got
    assert order == ["full", "holder", "high", "low", "shed", "kept"]
    assert answers["full"] == (429, "3", {"error": {
        "message": "admission queue full for priority class 'low'",
        "type": "overloaded", "code": 429}})
    assert answers["shed"][:2] == (429, "3")
    assert answers["shed"][2]["error"]["type"] == "overloaded"
    assert all(answers[t] == (200, None, None)
               for t in ("holder", "high", "low", "kept"))
    assert 'dynamo_planner_admissions_total{outcome="admitted",priority="normal"} 2.0' in samples


@pytest.mark.asyncio
async def test_a_queued_request_whose_client_leaves_gives_its_place_back(monkeypatch):
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "10")
    ctl = admission.AdmissionController(admission.AdmissionConfig(
        limit=1, queue_depth=4, queue_timeout_s=20.0))
    service = await _start(port_service, EchoEngineFull, admission=ctl)
    try:
        async with aiohttp.ClientSession() as s:
            url = f"http://127.0.0.1:{service.port}/v1/chat/completions"

            async def ask(words, priority="normal"):
                async with s.post(url, json=_chat(words),
                                  headers={"X-Priority": priority}) as r:
                    await r.read()
                    return r.status

            holder = asyncio.ensure_future(ask(40))
            while ctl.inflight < 1:
                await asyncio.sleep(0.005)
            # a raw client queues a request, then closes its connection
            body = json.dumps(_chat(3)).encode()
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           service.port)
            writer.write(b"POST /v1/chat/completions HTTP/1.1\r\n"
                         b"Host: x\r\nX-Priority: high\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
            await writer.drain()
            while ctl.queue_depth(2) < 1:
                await asyncio.sleep(0.005)
            writer.close()
            await writer.wait_closed()
            for _ in range(400):
                if ctl.queue_depth() == 0:
                    break
                await asyncio.sleep(0.005)
            assert ctl.queue_depth() == 0 and ctl.inflight == 1
            assert await holder == 200
            assert ctl.inflight == 0
            # the slot is free: the next request is admitted at once
            assert await asyncio.wait_for(ask(2, "low"), 5) == 200
            assert ctl.inflight == 0
    finally:
        await service.stop()
    lines = _samples(ctl.registry)
    assert 'dynamo_planner_admissions_total{outcome="admitted",priority="high"} 1.0' not in lines
    assert 'dynamo_planner_admissions_total{outcome="admitted",priority="normal"} 1.0' in lines


# ---------------------------------------------------------- the recovery gate


async def _drain_script(ctl_cls, mod):
    gate = mod.AdmissionController(mod.AdmissionConfig(limit=2))
    calls = []

    async def respawner(**kw):
        calls.append("respawn")

    out = []
    for respawn in (False, True):
        controller = ctl_cls(engine_id="e", respawner=respawner,
                             admission=gate)
        summary = await controller.drain(reason="admin", respawn=respawn,
                                         migrate=False)
        try:
            await gate.acquire(1)
            outcome = "admitted"
            gate.release()
        except mod.AdmissionRejected as e:
            outcome = e.outcome
        out.append((respawn, gate.draining, outcome,
                    summary.get("respawned")))
        gate.set_draining(False)
        await controller.close()
    return out, calls


def test_the_recovery_controller_gates_admission_as_the_reference():
    got = asyncio.run(_drain_script(RecoveryController, admission))
    want = asyncio.run(_drain_script(RefController, ref_admission))
    assert got == want
    assert got[0] == [(False, True, "draining", False),
                      (True, False, "admitted", True)]
