#!/usr/bin/env python3
"""Time two or more builds of the attention kernels in turns.

Each argument names a build and the ``csrc`` directory it is built from:
``python3 scripts/kernel_ab.py parent=_chipcheck/parent/dynamo_tpu_torch/csrc
change=dynamo_tpu_torch/csrc``. Every directory's ``paged_flash.cu``,
``sp_prefix.cu``, ``paged_decode.cu`` and ``paged_verify.cu`` (with the
headers they include) are compiled with the port's ``nvcc`` flags into a
temporary directory, and the port's wrappers are pointed at each build in
turn: builds in order, then in reverse (parent, change, change, parent for
two), each timed at these shapes:

- ``sp_prefix_14336``: kernel 6 at ``chip_smoke``'s timed shape, q [4, 512,
  32, 64] over a 14,336-key prefix of a 16-layer cache, layer 7;
- ``flash_long_dense_step``: flash at the dense ladder's last step of the
  12k prompt (B 1, S 512, base 11,776, ctx 12,000, 750 pages);
- ``flash_batch4_s128``: flash at the engine's batched chunk (4 rows at
  S 128 with their own base and ctx, one pad row);
- ``decode_b8``: decode at ``chip_smoke``'s timed shape (B 8, ctx 1 to
  2,048 over a 128-page table), layer 7, and ``decode_b8_layers`` with the
  layer cycling through the 16 (each call finds its keys outside the L2);
- ``decode_long_context``: ``engine_sp``'s decode batch (ctx 12,032,
  6,032, 332, 932 over a 1,024-page table, distinct pages of a 4-layer
  cache), layer 1, and ``decode_long_context_layers`` cycling the 4;
- ``verify_s5``: verify at S 5 over the decode contexts plus a pad row,
  layer 7, and ``verify_s5_layers``.

Prefill shapes are timed with ``chip_smoke.cuda_ms``, decode and verify
with ``chip_smoke.graph_ms`` (device time). Prints one JSON line per
shape: the times of each build (ms, one a turn),
the largest difference between the first two builds' outputs, and the
card. Needs one CUDA device and ``nvcc``. A build's C entry points are
called by parameter name, read from its source: an older build whose
entry takes fewer arguments (the decode and verify kernels before the
split-KV core took no workspace) gets the ones it names.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


# kernel → (wrapper module, C entry point)
KERNELS = {
    "paged_flash": ("paged_flash", "paged_flash_bf16"),
    "sp_prefix": ("sp_prefix", "sp_prefix_partials_bf16"),
    "paged_decode": ("paged_decode", "paged_decode_bf16"),
    "paged_verify": ("paged_verify", "paged_verify_bf16"),
}
_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


def entry_params(source: str, entry: str):
    """[(C type, name)] of ``extern "C" int entry(...)`` in ``source``."""
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)", source, re.S)
    if m is None:
        raise SystemExit(f"no extern \"C\" {entry} in the source")
    params = []
    for decl in m.group(1).split(","):
        words = decl.replace("const ", "").replace("*", "* ").split()
        params.append(("".join(words[:-1]), words[-1]))
    return params


def build(name: str, csrc: Path, out: Path, current: Path):
    """The kernels of ``csrc`` as ctypes functions taking the arguments of
    ``current``'s entry points (the ones the wrappers pass), by name."""
    from dynamo_tpu_torch.ops import _build

    fns = {}
    for kernel, (_, entry) in KERNELS.items():
        src = csrc / f"{kernel}.cu"
        so = out / f"{name}-{kernel}.so"
        res = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"{name}: {kernel} did not build:\n{res.stdout}{res.stderr}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        params = entry_params(src.read_text(), entry)
        fn.argtypes = [_CTYPES[t] for t, _ in params]
        fn.restype = ctypes.c_int
        wanted = [n for _, n in entry_params(
            (current / f"{kernel}.cu").read_text(), entry)]
        missing = [n for _, n in params if n not in wanted]
        if missing:
            raise SystemExit(f"{name}: {entry} takes {missing}, which the "
                             "wrapper does not pass")
        idx = [wanted.index(n) for _, n in params]
        fns[kernel] = (lambda fn=fn, idx=idx:
                       lambda *args: fn(*[args[i] for i in idx]))()
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
    import importlib

    import chip_smoke as cs
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import paged_verify as pv
    from dynamo_tpu_torch.ops import sp_prefix as spx

    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab-"))
    builds = {}
    for spec in args.builds:
        name, _, csrc = spec.partition("=")
        builds[name] = build(name, Path(csrc), tmp, _build.CSRC)

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
    # decode and verify at chip_smoke's timed shapes
    ctx_d = torch.tensor([1, 15, 16, 17, 513, 2048, 700, 1500],
                         dtype=torch.int32, device=dev)
    btd = torch.randperm(N, generator=g, device=dev)[:8 * 128].reshape(8, 128).int()
    qd = torch.randn(8, 1, H, D, generator=g, device=dev).bfloat16()
    btv = torch.cat([btd, torch.zeros_like(btd[:1])])
    ctxv = torch.cat([ctx_d, torch.ones_like(ctx_d[:1])])
    basev = torch.clamp(ctxv - 5, min=0)
    qv = torch.randn(9, 5, H, D, generator=g, device=dev).bfloat16()
    # engine_sp's decode batch: distinct pages of a 4-layer 2,048-page cache
    kl4 = torch.randn(4, 2048, BS, KVH, D, generator=g, device=dev).bfloat16()
    vl4 = torch.randn(4, 2048, BS, KVH, D, generator=g, device=dev).bfloat16()
    perm = torch.randperm(2048, generator=g, device=dev).int()
    btlc = torch.zeros(4, cs.LONG_DECODE_PAGES, dtype=torch.int32, device=dev)
    at = 0
    for i, c in enumerate(cs.LONG_DECODE_CTX):
        n_pg = -(-c // BS)
        btlc[i, :n_pg] = perm[at:at + n_pg]
        at += n_pg
    ctxlc = torch.tensor(cs.LONG_DECODE_CTX, dtype=torch.int32, device=dev)
    qlc = torch.randn(4, 1, H, D, generator=g, device=dev).bfloat16()
    turn = iter(range(1 << 30))

    def cycling(fn, layers):
        return lambda: fn(next(turn) % layers)

    shapes = {
        "sp_prefix_14336": lambda: spx.paged_prefix_attention_partials(
            q6, k, v, bt6, 14336, 7)[0],
        "flash_long_dense_step": lambda: pf.paged_flash_attention(
            ql, k, v, btl, basel, ctxl, layer_idx=7),
        "flash_batch4_s128": lambda: pf.paged_flash_attention(
            qb, k, v, btb, baseb, ctxb, layer_idx=7),
        "decode_b8": lambda: pd.paged_decode_attention(
            qd, k, v, btd, ctx_d, layer_idx=7),
        "decode_b8_layers": cycling(lambda li: pd.paged_decode_attention(
            qd, k, v, btd, ctx_d, layer_idx=li), L),
        "decode_long_context": lambda: pd.paged_decode_attention(
            qlc, kl4, vl4, btlc, ctxlc, layer_idx=1),
        "decode_long_context_layers": cycling(
            lambda li: pd.paged_decode_attention(
                qlc, kl4, vl4, btlc, ctxlc, layer_idx=li), 4),
        "verify_s5": lambda: pv.paged_verify_attention(
            qv, k, v, btv, basev, ctxv, layer_idx=7),
        "verify_s5_layers": cycling(lambda li: pv.paged_verify_attention(
            qv, k, v, btv, basev, ctxv, layer_idx=li), L),
    }
    names = list(builds)
    times = {s: {n: [] for n in names} for s in shapes}
    outs = {}
    wrappers = {kernel: importlib.import_module(f"dynamo_tpu_torch.ops.{mod}")
                for kernel, (mod, _) in KERNELS.items()}
    for name in names + names[::-1]:
        for kernel, mod in wrappers.items():
            mod._lib = lambda fn=builds[name][kernel]: fn
        for shape, fn in shapes.items():
            # decode and verify run faster than their wrappers launch them:
            # their device time comes from a CUDA graph's replay
            timer = cs.graph_ms if shape.startswith(("decode", "verify")) else cs.cuda_ms
            times[shape][name].append(timer(fn))
            if not shape.endswith("_layers"):
                outs.setdefault((shape, name), fn())
    torch.cuda.synchronize()
    card = cs.nvidia_smi_line()
    for shape in shapes:
        if shape.endswith("_layers"):
            print(json.dumps({"shape": shape, "ms": times[shape],
                              "card": card}), flush=True)
            continue
        a, b = (outs[(shape, n)] for n in (names * 2)[:2])
        # flash rows past ctx are discarded by the caller: compare the rest
        if shape == "flash_long_dense_step":
            a, b = [x[0, :cs.LONG_DENSE_STEP[1] - cs.LONG_DENSE_STEP[0]]
                    for x in (a, b)]
        if shape == "flash_batch4_s128":
            a, b = [torch.cat([x[0], x[1], x[2, :76]]) for x in (a, b)]
        if shape == "verify_s5":  # the pad row's queries past ctx
            a, b = a[:-1], b[:-1]
        print(json.dumps({"shape": shape, "ms": times[shape],
                          "max_abs_diff_first_two": float(
                              (a.float() - b.float()).abs().max()),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
