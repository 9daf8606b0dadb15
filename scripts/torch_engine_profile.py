#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving path on one card.

Serves the ``chip_smoke.py`` engine workload (Llama-3.2-1B shapes, seeded
random bf16 weights, 8 concurrent token-id requests of 100-1500 prompt
tokens and 32 new tokens each) through ``TorchServingEngine``, once per
sampling tail in the order unfused, fused, fused, unfused
(``fused_epilogue`` "off" / "auto": the epilogue kernel on a card), each
engine twice with fresh prompts (same lengths, so no prefix-cache hits
between waves): once untraced for the wall clock, once under
``torch.profiler``. It prints one JSON line with, per run, the untraced and
traced wall times, the device's busy share in the traced window (the union
of kernel intervals over the window), and device time by kernel family and
by kernel name. The first fused run's Chrome trace goes to
``chiprun_out/torch_engine_profile.json.gz``.

With ``--decode-modes sync,pipelined,chained`` (any subset) it profiles the
decode loop's modes instead, all with the fused tail and 4-step bursts:
the synchronous engine, the dispatch-ahead engine
(``decode_pipeline_depth=2``, ``device_finish="off"``) and the chained
device-finish engine, in the order given and then reversed, and adds per
run the device events per model step (a burst counts its 4 steps) and the
loop's counters, so that the idle share of the modes can be set side by
side.

Run on the card from the repository root: ``python3 scripts/torch_engine_profile.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the workload and the engine config)

FAMILIES = (
    ("paged_decode", ("paged_decode_kernel",)),
    ("paged_flash", ("paged_flash_kernel",)),
    ("paged_verify", ("paged_verify_kernel",)),
    ("sampling_epilogue", ("sampling_epilogue_kernel",)),
    ("gemm", ("gemm", "sm90_xmma", "cutlass", "gemv", "nvjet")),
    ("sort_topk", ("sort", "radix", "topk", "scan")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "index", "copy",
                     "fill", "cat", "gather", "scatter")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_run(torch, cfg, wave_a, wave_b, trace_path=None) -> dict:
    """One engine: an untraced wave, then a traced one; its breakdown."""
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine.serving import TorchServingEngine

    out = {"fused_epilogue": cfg.fused_epilogue,
           "decode_pipeline_depth": cfg.decode_pipeline_depth,
           "device_finish": cfg.device_finish,
           "multi_step_decode": cfg.multi_step_decode}

    async def run():
        engine = await TorchServingEngine.create(cfg, device="cuda")
        try:
            t0 = time.monotonic()
            res = await chip_smoke._serve(engine, wave_a)
            out["untraced_wall_s"] = time.monotonic() - t0
            out["untraced_ttft_s"] = sorted(r["ttft_s"] for r in res)
            steps0 = dict(engine.metrics())
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.monotonic()
                await chip_smoke._serve(engine, wave_b)
                torch.cuda.synchronize()
                out["traced_wall_s"] = time.monotonic() - t1
            steps1 = engine.metrics()
            out["traced_steps"] = {k: steps1[k] - steps0[k] for k in
                                   ("prefill_steps", "decode_steps",
                                    "pipeline_bursts", "device_finished_rows")}
            out["chain_len_max"] = steps1["chain_len_max"]
            out["sync_fallback"] = steps1["sync_fallback"]
        finally:
            await engine.close()
        return prof

    prof = asyncio.run(run())
    torch.cuda.empty_cache()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_family = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + us
    busy = union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    wall_us = out["traced_wall_s"] * 1e6
    out["device_events"] = len(kernels)
    # a decode pass is one model step, or multi_step_decode of them when it
    # ran as a burst (every pass of the pipelined and chained modes does;
    # the synchronous mode steps singly while prefill work waits, so its
    # figure is a lower bound on events per step)
    model_steps = (out["traced_steps"]["prefill_steps"]
                   + out["traced_steps"]["decode_steps"] * cfg.multi_step_decode)
    out["device_events_per_model_step"] = len(kernels) / max(model_steps, 1)
    out["device_busy_ms"] = busy / 1e3
    out["device_busy_share"] = busy / wall_us if wall_us else None
    out["device_ms_by_family"] = {k: v / 1e3 for k, v in sorted(
        by_family.items(), key=lambda kv: -kv[1])}
    out["top_kernels_ms"] = {k[:90]: v / 1e3 for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:15]}
    if trace_path is not None:
        trace_path.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
    return out


DECODE_MODES = {
    "sync": dict(multi_step_decode=4),
    "pipelined": dict(multi_step_decode=4, decode_pipeline_depth=2,
                      device_finish="off"),
    "chained": dict(multi_step_decode=4, decode_pipeline_depth=2),
}


def main() -> int:
    import torch

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--decode-modes", default="",
                    help="comma-separated subset of sync,pipelined,chained: "
                         "profile the decode loop's modes instead of the tails")
    modes = [m for m in ap.parse_args().decode_modes.split(",") if m]
    if any(m not in DECODE_MODES for m in modes):
        ap.error(f"unknown decode modes {modes}")
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    wave_a, _ = chip_smoke._requests(np.random.default_rng(1))
    wave_b, _ = chip_smoke._requests(np.random.default_rng(2))
    trace = ROOT / "chiprun_out" / "torch_engine_profile.json.gz"
    runs = []
    for name in modes + modes[::-1]:
        cfg = EngineConfig(model=ModelConfig(**chip_smoke.FLAGSHIP),
                           seed=chip_smoke.SEED,
                           **dict(chip_smoke.ENGINE, **DECODE_MODES[name]))
        run = profile_run(torch, cfg, wave_a, wave_b,
                          trace if name == "chained" and not any(
                              r.get("mode") == "chained" for r in runs) else None)
        runs.append(dict(mode=name, **run))
    for mode in () if modes else ("off", "auto", "auto", "off"):
        cfg = EngineConfig(model=ModelConfig(**chip_smoke.FLAGSHIP),
                           seed=chip_smoke.SEED, fused_epilogue=mode,
                           **chip_smoke.ENGINE)
        first_fused = mode == "auto" and not any(
            r["fused_epilogue"] == "auto" for r in runs)
        runs.append(profile_run(torch, cfg, wave_a, wave_b,
                                trace if first_fused else None))
    print(json.dumps({"card": smi, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
