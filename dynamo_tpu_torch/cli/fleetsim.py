"""Trace-driven fleet simulator CLI: replay traffic against the real
control plane at 1000x and publish capacity curves (the port's copy of
``scripts/fleetsim.py``).

Runs one named scenario (see ``--list``) on a virtual clock, driving
the port's real SlaPolicy / AdmissionController / PoolManager /
RecoveryController / KvScheduler against simulated workers timed by
the device-time byte model (a floor: the bytes a step moves at the card's
peak rate, nothing of the host). It runs on no device and imports no torch. Reports a QPS-vs-SLO-attainment
capacity curve, shed rates by tenant and priority, scale / chaos /
recovery timelines, and KV pressure.

Usage:
    python3 -m dynamo_tpu_torch.cli.fleetsim --scenario diurnal --speedup 1000
    python3 -m dynamo_tpu_torch.cli.fleetsim --scenario chaos --seed 7 --json
    python3 -m dynamo_tpu_torch.cli.fleetsim --scenario replay --trace dyn_traces.jsonl
    python3 -m dynamo_tpu_torch.cli.fleetsim --scenario replay --bundle incident-123/
    python3 -m dynamo_tpu_torch.cli.fleetsim --list

The reference's ``rag_pod`` scenario is refused by name (argparse's exit 2):
the port has no plane between cards yet.

Exit status: 0 on success, 2 when the scenario's SLO-attainment floor
is violated (CI capacity gate), 3 when ``--speedup`` was requested but
not achieved. The report JSON is deterministic for a (scenario, seed)
pair — wall-clock facts (achieved speedup) go to stderr only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..sim.report import render_table
from ..sim.scenarios import REFUSED_SCENARIOS, SCENARIOS, run_scenario
from ..sim.workload import load_incident_bundle, load_trace_jsonl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fleet simulator: scenarios vs the real control plane")
    ap.add_argument("--scenario", help="scenario name (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and exit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=None,
                    metavar="SECONDS",
                    help="override the scenario's virtual duration")
    ap.add_argument("--speedup", type=float, default=None,
                    help="required virtual/wall speedup; exit 3 if the "
                         "run comes in slower")
    ap.add_argument("--slo-floor", type=float, default=None,
                    help="override the scenario's SLO-attainment floor")
    ap.add_argument("--trace", help="DYN_TRACE_JSONL sink to replay")
    ap.add_argument("--bundle",
                    help="incident bundle directory to replay "
                         "(reads traces.json)")
    ap.add_argument("--json", action="store_true",
                    help="print the report JSON instead of the table")
    ap.add_argument("--json-out", metavar="PATH",
                    help="also write the report JSON to PATH")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="write the run's /metrics exposition "
                         "(dynamo_sim_* + control-plane families)")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(SCENARIOS):
            scn = SCENARIOS[name]
            print(f"{name:<14} floor={scn.slo_floor:.2f} "
                  f"duration={scn.duration_s:.0f}s  {scn.description}")
        return 0
    if not args.scenario:
        ap.error("--scenario is required (or --list)")
    if args.scenario in REFUSED_SCENARIOS:
        ap.error(f"scenario {args.scenario!r} is refused: "
                 f"{REFUSED_SCENARIOS[args.scenario]}")
    if args.scenario not in SCENARIOS:
        ap.error(f"unknown scenario {args.scenario!r}; "
                 f"have {sorted(SCENARIOS)}")

    requests = None
    if args.trace:
        requests = load_trace_jsonl(args.trace)
    elif args.bundle:
        requests = load_incident_bundle(args.bundle)
    if args.scenario == "replay" and requests is None:
        ap.error("--scenario replay needs --trace or --bundle")

    exposition = {}
    if args.metrics_out:
        def grab(fleet):
            exposition["text"] = fleet.registry.render()
    else:
        grab = None

    t0 = time.monotonic()
    report = run_scenario(
        args.scenario,
        seed=args.seed,
        duration_s=args.duration,
        requests=requests,
        slo_floor=args.slo_floor,
        on_fleet=grab,
    )
    wall_s = max(1e-9, time.monotonic() - t0)
    achieved = report["duration_s"] / wall_s

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(report, f, sort_keys=True, indent=1)
            f.write("\n")
    if args.metrics_out:
        with open(args.metrics_out, "w", encoding="utf-8") as f:
            f.write(exposition.get("text", ""))
    if args.json:
        print(json.dumps(report, sort_keys=True, indent=1))
    else:
        print(render_table(report))
    print(f"[fleetsim] {report['duration_s']:.0f} virtual s in "
          f"{wall_s:.2f} wall s — {achieved:.0f}x realtime",
          file=sys.stderr)

    floor = report["slo_floor"]
    if not report["capacity"]["meets_floor"]:
        print(f"[fleetsim] SLO floor violated: attainment "
              f"{report['totals']['slo_attainment']:.3f} < {floor:.2f}",
              file=sys.stderr)
        return 2
    if args.speedup is not None and achieved < args.speedup:
        print(f"[fleetsim] speedup target missed: {achieved:.0f}x < "
              f"{args.speedup:.0f}x", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
