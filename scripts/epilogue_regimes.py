#!/usr/bin/env python3
"""Time the fused sampling epilogue kernel by sampling regime on one card.

At B 8, V 128,256 (Llama-3.2-1B), bf16 logits (normal * 4), every row of
a batch in one regime: all greedy, plain temperature, top-k 50, top-k 200
(past the kernel's 128 warp maxima: no candidate bound), top-p 0.9, top-p
0.95 over a flat row (temperature 4: a nucleus the candidates cannot
hold), min-p 0.1, top-k 50 with top-p 0.95, and
``chip_smoke.EPILOGUE_ROWS``'s mixed batch. Each regime's kernel time (a
CUDA graph's replay, device time) goes beside the plain version's (the
unfused PyTorch tail, CUDA events), after both were checked equal (tokens
exact, logprobs within ``chip_smoke.EPILOGUE_LP_TOL``). Rows run side by
side, so a batch takes as long as its slowest row, and the regimes show
which path of the kernel costs what.

``--baseline NAME=CSRC_DIR`` (repeatable) also builds the epilogue of
another ``csrc`` tree (an earlier version), called by parameter name as
``scripts/kernel_ab.py`` calls it (with the arguments an older entry takes
that the wrapper no longer passes), checks it the same way and times it in
turns with the current one (baseline, current, current, baseline). Prints
one JSON line per regime and the card's ``nvidia-smi`` name and power
limit.

Run on the card from the repository root:
``python3 scripts/epilogue_regimes.py [--baseline parent=DIR ...]``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402  (timing, tolerances, the mixed rows)
import kernel_ab  # noqa: E402  (builds of another tree, called by name)

V, B = 128256, 8
REGIMES = {
    "greedy": dict(temperature=0.0),
    "temperature_1": dict(),
    "top_k_50": dict(temperature=0.8, top_k=50),
    "top_k_200": dict(temperature=0.8, top_k=200),
    "top_p_0.9": dict(top_p=0.9),
    "top_p_0.95_flat": dict(temperature=4.0, top_p=0.95),
    "min_p_0.1": dict(min_p=0.1),
    "top_k_50_top_p_0.95": dict(temperature=0.8, top_k=50, top_p=0.95),
}


def build_baseline(name: str, csrc: Path):
    """The epilogue of ``csrc`` as a function taking the current entry's
    arguments (``kernel_ab.build``)."""
    from dynamo_tpu_torch.ops import _build

    kernel_ab.KERNELS = {"sampling_epilogue": kernel_ab.KERNELS["sampling_epilogue"]}
    out = Path(tempfile.mkdtemp(prefix="epilogue_regimes-"))
    return kernel_ab.build(name, csrc, out, _build.CSRC)["sampling_epilogue"]


def main() -> int:
    import torch

    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.ops import epilogue as ep

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", action="append", default=[],
                        metavar="NAME=CSRC_DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    current = ep._lib()
    variants = {"current": current}
    for spec in args.baseline:
        name, _, csrc = spec.partition("=")
        variants[name] = build_baseline(name, Path(csrc))

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
                ms = chip_smoke.graph_ms(lambda: run(variants[name], samp))
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
