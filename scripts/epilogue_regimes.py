#!/usr/bin/env python3
"""Time the fused sampling epilogue kernel by sampling regime on one card.

At B 8, V 128,256 (Llama-3.2-1B), bf16 logits (normal * 4), every row of
a batch in one regime: all greedy, plain temperature, top-k 50, top-p 0.9,
min-p 0.1, top-k 50 with top-p 0.95, and ``chip_smoke.EPILOGUE_ROWS``'s
mixed batch. Each regime's kernel time (CUDA events) goes beside the
plain version's (the unfused PyTorch tail), after both were checked
equal (tokens exact, logprobs within ``chip_smoke.EPILOGUE_LP_TOL``).
Since one CTA serves one row, a batch takes as long as its slowest row,
so the regimes show where the kernel's time goes.

``--baseline SRC`` (repeatable) also builds another source of the same C
entry point (an earlier version of ``csrc/sampling_epilogue.cu``), checks
it the same way and times it in turns with the current one (baseline,
current, current, baseline). Prints one JSON line per regime and the
card's ``nvidia-smi`` name and power limit.

Run on the card from the repository root:
``python3 scripts/epilogue_regimes.py [--baseline old.cu ...]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (timing, tolerances, the mixed rows)

V, B = 128256, 8
REGIMES = {
    "greedy": dict(temperature=0.0),
    "temperature_1": dict(),
    "top_k_50": dict(temperature=0.8, top_k=50),
    "top_p_0.9": dict(top_p=0.9),
    "min_p_0.1": dict(min_p=0.1),
    "top_k_50_top_p_0.95": dict(temperature=0.8, top_k=50, top_p=0.95),
}


def build_baseline(src: Path, like):
    """Build ``src`` into its own library; its entry point typed as
    ``like`` (the current build's)."""
    from dynamo_tpu_torch.ops import _build

    so = _build.BUILD_DIR / f"{src.stem}-baseline.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).sampling_epilogue
    fn.argtypes, fn.restype = like.argtypes, like.restype
    return fn


def main() -> int:
    import torch

    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.ops import epilogue as ep

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", action="append", default=[], type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    current = ep._lib()
    variants = {"current": current}
    for src in args.baseline:
        variants[src.name] = build_baseline(src, current)

    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 5)
    logits = (torch.randn(B, V, generator=g, device=dev) * 4).bfloat16()
    counts = torch.randint(0, 3, (B, V), generator=g, device=dev, dtype=torch.int32)
    seen = torch.randint(0, 2, (B, V), generator=g, device=dev).bool()
    bias = torch.randn(B, V, generator=g, device=dev) * 0.5
    u = torch.rand(B, V, generator=g, device=dev).clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    slots = torch.arange(B, device=dev)
    nocommit = torch.zeros(B, dtype=torch.bool, device=dev)  # counts stay put

    def params(rows):
        return SamplingParams(**{
            k: torch.as_tensor(v, dtype=torch.int64 if k == "top_k" else torch.float32,
                               device=dev).expand(B).contiguous()
            for k, v in rows.items()})

    base = dict(temperature=1.0, top_k=0, top_p=1.0, min_p=0.0, presence_penalty=0.0,
                frequency_penalty=0.0, repetition_penalty=1.0)
    regimes = {name: params(dict(base, **kw)) for name, kw in REGIMES.items()}
    regimes["mixed"] = params(chip_smoke.EPILOGUE_ROWS)

    def run(fn, samp):
        ep._lib = lambda: fn
        return ep.fused_sampling_epilogue(logits, gumbel, samp, counts, seen, bias,
                                          slots, nocommit)

    order = [name for name in variants if name != "current"]
    wrapper_lib = ep._lib
    try:
        print(chip_smoke.nvidia_smi_line(), flush=True)
        for regime, samp in regimes.items():
            tok_r, lps_r, _ = ep.fused_sampling_epilogue_ref(
                logits, gumbel, samp, counts, seen, bias, slots, nocommit)
            for name, fn in variants.items():
                tok, lps, _ = run(fn, samp)
                torch.cuda.synchronize()
                err = float((lps - lps_r).abs().max())
                if tok.tolist() != tok_r.tolist() or not err <= chip_smoke.EPILOGUE_LP_TOL:
                    raise AssertionError(f"{name} disagrees with the plain version "
                                         f"on {regime}: tokens {tok.tolist()} vs "
                                         f"{tok_r.tolist()}, logprob error {err:.3g}")
            times = {}
            for name in order + ["current", "current"] + order[::-1]:
                ms = chip_smoke.cuda_ms(lambda: run(variants[name], samp))
                times.setdefault(name, []).append(ms)
            plain_ms = chip_smoke.cuda_ms(lambda: ep.fused_sampling_epilogue_ref(
                logits, gumbel, samp, counts, seen, bias, slots, nocommit))
            print(json.dumps({"regime": regime, "kernel_ms": times,
                              "plain_ms": plain_ms}), flush=True)
    finally:
        ep._lib = wrapper_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
