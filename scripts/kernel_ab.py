#!/usr/bin/env python3
"""Time two or more builds of the prefill attention kernels in turns.

Each argument names a build and the ``csrc`` directory it is built from:
``python3 scripts/kernel_ab.py parent=_chipcheck/parent/dynamo_tpu_torch/csrc
change=dynamo_tpu_torch/csrc``. Every directory's ``paged_flash.cu`` and
``sp_prefix.cu`` (with the headers they include) are compiled with the
port's ``nvcc`` flags into a temporary directory, and the port's wrappers
(``ops/paged_flash.py``, ``ops/sp_prefix.py``) are pointed at each build in
turn: builds in order, then in reverse (parent, change, change, parent for
two), each timed with ``chip_smoke.cuda_ms`` at three shapes:

- ``sp_prefix_14336``: kernel 6 at ``chip_smoke``'s timed shape, q [4, 512,
  32, 64] over a 14,336-key prefix of a 16-layer cache, layer 7;
- ``flash_long_dense_step``: flash at the dense ladder's last step of the
  12k prompt (B 1, S 512, base 11,776, ctx 12,000, 750 pages);
- ``flash_batch4_s128``: flash at the engine's batched chunk (4 rows at
  S 128 with their own base and ctx, one pad row).

Prints one JSON line per shape: the times of each build (ms, one a turn),
the largest difference between the first two builds' outputs, and the
card. Needs one CUDA device and ``nvcc``; builds must keep the C entry
points ``paged_flash_bf16`` and ``sp_prefix_partials_bf16``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def build(name: str, csrc: Path, out: Path):
    """The two kernels of ``csrc`` as ctypes functions."""
    from dynamo_tpu_torch.ops import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for kernel, entry, nint in (("paged_flash", "paged_flash_bf16", 10),
                                ("sp_prefix", "sp_prefix_partials_bf16", 11)):
        so = out / f"{name}-{kernel}.so"
        res = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(csrc / f"{kernel}.cu")], capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"{name}: {kernel} did not build:\n{res.stdout}{res.stderr}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = [p] * 7 + [i] * nint + [ctypes.c_float, p]
        fn.restype = i
        fns[kernel] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=CSRC_DIR")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import sp_prefix as spx

    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab-"))
    builds = {}
    for spec in args.builds:
        name, _, csrc = spec.partition("=")
        builds[name] = build(name, Path(csrc), tmp)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    L, N, BS, KVH, D, H = 16, 1024, 16, 8, 64, 32
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    row = torch.randperm(N, generator=g, device=dev).int()[None]
    q6 = torch.randn(cs.SP_RANKS, cs.SP_ROWS, H, D, generator=g, device=dev).bfloat16()
    bt6 = row.expand(cs.SP_RANKS, N)
    ql = torch.randn(1, 512, H, D, generator=g, device=dev).bfloat16()
    btl = row[:, :cs.LONG_DENSE_PAGES].contiguous()
    basel = torch.tensor([cs.LONG_DENSE_STEP[0]], dtype=torch.int32, device=dev)
    ctxl = torch.tensor([cs.LONG_DENSE_STEP[1]], dtype=torch.int32, device=dev)
    qb = torch.randn(4, 128, H, D, generator=g, device=dev).bfloat16()
    btb = torch.randperm(N, generator=g, device=dev)[:4 * 128].reshape(4, 128).int()
    btb[3] = 0
    baseb = torch.tensor([0, 384, 1024, 0], dtype=torch.int32, device=dev)
    ctxb = torch.tensor([128, 512, 1100, 1], dtype=torch.int32, device=dev)
    shapes = {
        "sp_prefix_14336": lambda: spx.paged_prefix_attention_partials(
            q6, k, v, bt6, 14336, 7)[0],
        "flash_long_dense_step": lambda: pf.paged_flash_attention(
            ql, k, v, btl, basel, ctxl, layer_idx=7),
        "flash_batch4_s128": lambda: pf.paged_flash_attention(
            qb, k, v, btb, baseb, ctxb, layer_idx=7),
    }
    names = list(builds)
    times = {s: {n: [] for n in names} for s in shapes}
    outs = {}
    for name in names + names[::-1]:
        fns = builds[name]
        pf._lib = lambda fn=fns["paged_flash"]: fn
        spx._lib = lambda fn=fns["sp_prefix"]: fn
        for shape, fn in shapes.items():
            times[shape][name].append(cs.cuda_ms(fn))
            outs.setdefault((shape, name), fn())
    torch.cuda.synchronize()
    card = cs.nvidia_smi_line()
    for shape in shapes:
        a, b = (outs[(shape, n)] for n in (names * 2)[:2])
        # flash rows past ctx are discarded by the caller: compare the rest
        if shape == "flash_long_dense_step":
            a, b = [x[0, :cs.LONG_DENSE_STEP[1] - cs.LONG_DENSE_STEP[0]]
                    for x in (a, b)]
        if shape == "flash_batch4_s128":
            a, b = [torch.cat([x[0], x[1], x[2, :76]]) for x in (a, b)]
        print(json.dumps({"shape": shape, "ms": times[shape],
                          "max_abs_diff_first_two": float(
                              (a.float() - b.float()).abs().max()),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
