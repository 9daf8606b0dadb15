"""Report anatomy for a finished sim run (the port's copy of
``dynamo_tpu/sim/report.py``).

Everything here is derived from virtual-time state only — record
timestamps, event timelines, and windows are all in virtual seconds, so
``json.dumps(report, sort_keys=True)`` of two same-seed runs compares
byte-identical. Floats are rounded to 6 places to keep accumulation
order from leaking into the JSON.

The headline artifact is the capacity curve: completed windows bucketed
by offered QPS, each bucket's SLO attainment, and ``capacity_qps`` —
the highest offered load the fleet shape sustained at or above the
scenario's attainment floor.
"""

from __future__ import annotations

import math
from typing import Dict, List

WINDOW_S = 60.0


def _r(x) -> float:
    return round(float(x), 6)


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


def build_report(scenario: str, seed: int, fleet, slo_floor: float,
                 duration_s: float) -> dict:
    records = fleet.records
    completed = [r for r in records if r["outcome"] == "completed"]
    shed_outcomes = ("shed", "queue_full", "timeout", "draining",
                     "quota", "cold_start_timeout")

    # -- per-window series + capacity curve -------------------------------
    n_windows = max(1, int(math.ceil(duration_s / WINDOW_S)))
    windows = []
    for wi in range(n_windows):
        lo, hi = wi * WINDOW_S, (wi + 1) * WINDOW_S
        offered = [r for r in records if lo <= r["arrival_s"] < hi]
        done = [r for r in offered if r["outcome"] == "completed"]
        met = [r for r in done if r.get("slo_met")]
        shed = [r for r in offered if r["outcome"] in shed_outcomes]
        windows.append({
            "window_s": [_r(lo), _r(hi)],
            "offered_qps": _r(len(offered) / WINDOW_S),
            "completed": len(done),
            "shed": len(shed),
            "slo_attainment": _r(len(met) / len(done)) if done else None,
        })
    replicas_by_window: Dict[int, int] = {}
    for t, n in fleet.replica_series:
        replicas_by_window[int(t // WINDOW_S)] = n
    for wi, w in enumerate(windows):
        w["replicas"] = replicas_by_window.get(wi)

    curve: Dict[float, List[dict]] = {}
    for w in windows:
        if w["slo_attainment"] is None:
            continue
        qps = _r(round(w["offered_qps"] * 2) / 2)   # 0.5-QPS buckets
        curve.setdefault(qps, []).append(w)
    capacity_curve = []
    for qps in sorted(curve):
        ws = curve[qps]
        att = [w["slo_attainment"] for w in ws]
        capacity_curve.append({
            "offered_qps": qps,
            "windows": len(ws),
            "slo_attainment": _r(sum(att) / len(att)),
            "shed_rate": _r(
                sum(w["shed"] for w in ws)
                / max(1, sum(w["shed"] + w["completed"] for w in ws))),
        })
    sustained = [p["offered_qps"] for p in capacity_curve
                 if p["slo_attainment"] >= slo_floor]
    capacity_qps = _r(max(sustained)) if sustained else 0.0

    # -- shed attribution --------------------------------------------------
    def _rates(key: str) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for r in records:
            k = str(r[key])
            row = out.setdefault(
                k, {"offered": 0, "completed": 0, "shed": 0})
            row["offered"] += 1
            if r["outcome"] == "completed":
                row["completed"] += 1
            elif r["outcome"] in shed_outcomes:
                row["shed"] += 1
        for row in out.values():
            row["shed_rate"] = _r(row["shed"] / row["offered"])
        return dict(sorted(out.items()))

    # -- latency + totals --------------------------------------------------
    ttfts = sorted(r["ttft_s"] for r in completed if "ttft_s" in r)
    outcome_totals: Dict[str, int] = {}
    for r in records:
        outcome_totals[r["outcome"]] = outcome_totals.get(
            r["outcome"], 0) + 1
    met = [r for r in completed if r.get("slo_met")]

    report = {
        "scenario": scenario,
        "seed": seed,
        "slo_floor": _r(slo_floor),
        "duration_s": _r(duration_s),
        "totals": {
            "offered": len(records),
            "outcomes": dict(sorted(outcome_totals.items())),
            "slo_attainment": (_r(len(met) / len(completed))
                               if completed else 0.0),
            "resubmits": fleet.resubmits,
            "ttft_p50_s": _r(_percentile(ttfts, 0.50)),
            "ttft_p95_s": _r(_percentile(ttfts, 0.95)),
            "prefix_hit_tokens": sum(
                r.get("prefix_hit_tokens", 0) for r in completed),
            "pulled_blocks": sum(
                r.get("pulled_blocks", 0) for r in completed),
            # every peer pull rides tcp between hosts (the reference's
            # intra-pod backend and its *_ici keys are not ported)
            "pull_transfer_s_tcp": _r(sum(
                r.get("pull_transfer_s", 0.0) for r in completed)),
            "cold_blocks": sum(
                r.get("cold_blocks", 0) for r in completed),
        },
        "capacity": {
            "floor": _r(slo_floor),
            "capacity_qps": capacity_qps,
            "curve": capacity_curve,
            "meets_floor": bool(
                completed
                and (len(met) / len(completed)) >= slo_floor),
        },
        "windows": windows,
        "shed_by_tenant": _rates("tenant"),
        "shed_by_priority": _rates("priority"),
        "timeline": [
            {k: (_r(v) if isinstance(v, float) else v)
             for k, v in ev.items()}
            for ev in fleet.events
        ],
        "kv_pressure": {
            "series": [[_r(t), _r(u)] for t, u in fleet.kv_series],
            "peak": _r(max((u for _, u in fleet.kv_series),
                           default=0.0)),
        },
        "recoveries": fleet.recovery_summaries(),
        "flight_kinds": fleet.flight_kinds(),
    }
    return report


def render_table(report: dict) -> str:
    """The human half of the report: a fixed-width text summary."""
    lines = []
    t = report["totals"]
    cap = report["capacity"]
    lines.append(
        f"scenario={report['scenario']} seed={report['seed']} "
        f"duration={report['duration_s']:.0f}s")
    lines.append(
        f"offered={t['offered']} "
        f"completed={t['outcomes'].get('completed', 0)} "
        f"attainment={t['slo_attainment']:.3f} "
        f"(floor {report['slo_floor']:.2f}) "
        f"capacity={cap['capacity_qps']:.2f} qps")
    lines.append(
        f"ttft p50={t['ttft_p50_s'] * 1000:.0f}ms "
        f"p95={t['ttft_p95_s'] * 1000:.0f}ms "
        f"resubmits={t['resubmits']}")
    lines.append("")
    lines.append(f"{'qps':>6} {'windows':>7} {'attain':>7} {'shed%':>6}")
    for p in cap["curve"]:
        lines.append(
            f"{p['offered_qps']:>6.2f} {p['windows']:>7d} "
            f"{p['slo_attainment']:>7.3f} "
            f"{100.0 * p['shed_rate']:>5.1f}%")
    lines.append("")
    lines.append(f"{'tenant':<14} {'offered':>7} {'shed':>5} {'rate':>6}")
    for tenant, row in report["shed_by_tenant"].items():
        lines.append(
            f"{tenant:<14} {row['offered']:>7d} {row['shed']:>5d} "
            f"{100.0 * row['shed_rate']:>5.1f}%")
    lines.append(f"{'priority':<14} {'offered':>7} {'shed':>5} {'rate':>6}")
    for prio, row in report["shed_by_priority"].items():
        lines.append(
            f"{prio:<14} {row['offered']:>7d} {row['shed']:>5d} "
            f"{100.0 * row['shed_rate']:>5.1f}%")
    events = report["timeline"]
    if events:
        lines.append("")
        lines.append("timeline:")
        for ev in events:
            extra = " ".join(
                f"{k}={v}" for k, v in sorted(ev.items())
                if k not in ("t", "kind"))
            lines.append(f"  t={ev['t']:>8.1f}s {ev['kind']:<14} {extra}")
    if report["recoveries"]:
        lines.append("recoveries:")
        for s in report["recoveries"]:
            lines.append(
                f"  {s['worker']}: reason={s['reason']} "
                f"respawned={s['respawned']} failed={s['failed']}")
    return "\n".join(lines)
