"""Cross-process trace stitching: per-hop clock offsets + one timeline.

The port's copy of ``dynamo_tpu/telemetry/stitch.py``.

A request that crosses the disagg plane (frontend → router → remote
prefill worker → transfer → decode engine, possibly → migration peer)
leaves span marks in every process it touches, each stamped against
that process's OWN clock. This module is the math that renders them on
one axis:

- **Span export.** Each process's :class:`~dynamo_tpu_torch.runtime.engine.
  AsyncEngineContext` converts its monotonic span marks to wall-clock
  stamps (``export_spans``) and ships them back on an EXISTING response
  frame — the dial-back stream's ``end`` frame, the KV transfer plane's
  ``commit`` frame, the migration plane's ``mig_end`` frame. No new
  service, no extra round trip.
- **Offset estimation.** Wall clocks skew across hosts, so each hop's
  receiver estimates the remote−local clock offset NTP-style from the
  request/response timestamp pair it already has (`estimate_offset`).
  The estimate's error is bounded by half the NETWORK round trip — the
  remote processing time between ``recv_at`` and ``resp_sent_at`` drops
  out of the formula, so even a 2-minute remote prefill yields a
  millisecond-grade offset.
- **Stitching.** Remote span sets nest (the frontend holds the decode
  worker's set, which holds the prefill worker's set); offsets compose
  down the chain, and `stitched_timeline` flattens everything onto the
  trace-origin axis with the same closing-mark attribution local spans
  use (telemetry/tracing.span_breakdown).

Wire shape of one remote span set (json-able; it rides the frames'
own codecs, ``runtime/wire.py`` and ``transfer/framing.py``)::

    {"source": "prefill_worker",
     "spans": [[name, wall_t], ...],     # remote wall-clock marks
     "recv_at": wall_t,                  # request received (remote clock)
     "resp_sent_at": wall_t,             # response sent (remote clock)
     "offset_s": float,                  # remote - local (folded locally)
     "rtt_s": float,                     # network-only round trip
     "children": [...]}                  # that process's OWN remote sets
"""

from __future__ import annotations

from typing import List, Optional, Tuple

# span sources deeper than this are dropped: a malicious/buggy frame
# must not recurse the stitcher to death
MAX_HOP_DEPTH = 8


def estimate_offset(sent_local: float, recv_remote: float,
                    resp_sent_remote: float,
                    resp_recv_local: float) -> Tuple[float, float]:
    """NTP-style per-hop clock offset from one request/response pair.

    Returns ``(offset, rtt)`` where ``offset`` is the estimated
    ``remote_clock - local_clock`` and ``rtt`` is the network-only round
    trip (total round trip minus the remote's processing time). The
    offset error is bounded by ``rtt / 2`` regardless of how long the
    remote held the request — asymmetric CLOCKS are corrected; only
    asymmetric network LEGS survive as error.
    """
    rtt = max(
        0.0,
        (resp_recv_local - sent_local) - (resp_sent_remote - recv_remote),
    )
    offset = (
        (recv_remote - sent_local) + (resp_sent_remote - resp_recv_local)
    ) / 2.0
    return offset, rtt


def estimate_offset_return_leg(resp_sent_remote: float,
                               resp_recv_local: float) -> float:
    """Offset estimate from the response leg alone, for hops whose
    forward "leg" is queue-mediated (remote prefill: submit enqueues,
    the worker dequeues whenever it gets there). The symmetric formula
    assumes both legs are network transits — a 4 s queue backlog would
    skew the estimate by ~2 s, misplacing every remote span in exactly
    the deep-queue trace the X-ray exists to diagnose. Using only
    ``resp_sent_remote − resp_recv_local`` bounds the error by the
    ONE-WAY response transit (estimate reads low by that transit),
    typically milliseconds regardless of queue depth."""
    return resp_sent_remote - resp_recv_local


def remote_span_set(source: str, spans: List, recv_at: float,
                    resp_sent_at: float, sent_local: float,
                    resp_recv_local: float,
                    children: Optional[List] = None,
                    queued_forward: bool = False) -> dict:
    """Fold one hop's exported spans into a local-clock-aware set.

    ``queued_forward`` marks hops where ``sent_local`` is a queue-submit
    time rather than a direct send: the offset then comes from the
    return leg alone (see :func:`estimate_offset_return_leg`) while the
    symmetric ``rtt`` is still reported as the conservative confidence
    envelope (the true error is only the one-way response transit).
    """
    offset, rtt = estimate_offset(
        sent_local, recv_at, resp_sent_at, resp_recv_local
    )
    if queued_forward:
        offset = estimate_offset_return_leg(resp_sent_at, resp_recv_local)
    return {
        "source": source,
        "spans": [[str(n), float(t)] for n, t in (spans or [])],
        "recv_at": float(recv_at),
        "resp_sent_at": float(resp_sent_at),
        "offset_s": round(offset, 6),
        "rtt_s": round(rtt, 6),
        "children": list(children or []),
    }


def _marks_to_spans(source: str, marks: List, t0: float,
                    offset: float) -> List[dict]:
    """[(name, remote_wall)] → closing-mark spans on the local axis.

    Same attribution as tracing.span_breakdown: span ``X`` covers the
    gap from the PREVIOUS mark to the moment ``X`` was stamped. The
    first mark opens the source's timeline (zero-length ``arrive``
    anchor is implicit in its offset).
    """
    out = []
    prev = None
    for name, wall in marks:
        start = float(wall) - offset - t0
        if prev is None:
            out.append({
                "source": source, "name": str(name),
                "start_s": round(start, 6), "duration_s": 0.0,
            })
        else:
            out.append({
                "source": source, "name": str(name),
                "start_s": round(prev, 6),
                "duration_s": round(max(0.0, start - prev), 6),
            })
        prev = start
    return out


def stitched_timeline(trace: dict) -> dict:
    """A completed trace (tracing.TraceRecorder shape) → one timeline.

    Returns ``{"sources": [...], "timeline": [...]}`` where every
    timeline row is ``{source, name, start_s, duration_s}`` on the
    TRACE-ORIGIN axis (the frontend's first mark = 0) and ``sources``
    lists each hop with its estimated clock offset and network rtt —
    the per-hop confidence bars of the rendering.
    """
    t0 = float(trace.get("t0_wall") or 0.0)
    rows: List[dict] = []
    sources: List[dict] = [{"source": "frontend", "offset_s": 0.0,
                            "rtt_s": 0.0}]
    for span in trace.get("spans") or []:
        rows.append({
            "source": "frontend", "name": span["name"],
            "start_s": span["offset_s"], "duration_s": span["duration_s"],
        })

    def walk(rs: dict, base_offset: float, depth: int) -> None:
        if depth > MAX_HOP_DEPTH:
            return
        offset = float(rs.get("offset_s") or 0.0) + base_offset
        source = str(rs.get("source") or "remote")
        sources.append({
            "source": source,
            "offset_s": round(offset, 6),
            "rtt_s": round(float(rs.get("rtt_s") or 0.0), 6),
        })
        rows.extend(_marks_to_spans(source, rs.get("spans") or [], t0,
                                    offset))
        for child in rs.get("children") or []:
            walk(child, offset, depth + 1)

    for rs in trace.get("remote") or []:
        walk(rs, 0.0, 1)
    rows.sort(key=lambda r: (r["start_s"], r["source"]))
    return {"sources": sources, "timeline": rows}


def timeline_gaps(timeline: List[dict], min_gap_s: float = 0.0) -> List[dict]:
    """Unattributed time: stretches covered by NO span of any source.

    The "where did my 900 ms go" tool: a stitched trace whose spans sum
    to 300 ms still has 600 ms of gaps — each returned row names the
    spans it falls between, so the gap is attributable to the hop
    boundary (queue transit, network, a process that stamped nothing).
    """
    if not timeline:
        return []
    covered_until = None
    gaps = []
    prev_row = None
    for row in sorted(timeline, key=lambda r: r["start_s"]):
        start, end = row["start_s"], row["start_s"] + row["duration_s"]
        if covered_until is not None and start - covered_until > min_gap_s:
            gaps.append({
                "start_s": round(covered_until, 6),
                "duration_s": round(start - covered_until, 6),
                "after": (f"{prev_row['source']}:{prev_row['name']}"
                          if prev_row else ""),
                "before": f"{row['source']}:{row['name']}",
            })
        if covered_until is None or end >= covered_until:
            covered_until = end
            prev_row = row
    return gaps
