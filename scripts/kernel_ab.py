#!/usr/bin/env python3
"""Time two or more builds of the port's kernels in turns.

Each argument names a build and the ``csrc`` directory it is built from:
``python3 scripts/kernel_ab.py parent=_chipcheck/parent/dynamo_tpu_torch/csrc
change=dynamo_tpu_torch/csrc``. Every directory's ``paged_flash.cu``,
``sp_prefix.cu``, ``paged_decode.cu``, ``paged_verify.cu``,
``mla_decode.cu`` and ``sampling_epilogue.cu`` (with the headers they
include) are compiled with the port's ``nvcc`` flags into a
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
  layer 7, and ``verify_s5_layers``;
- ``decode_b8_d128``, ``verify_s5_d128`` and ``flash_batch4_s128_d128``:
  the same rows at head_dim 128 (H 32, KVH 8) over a 4-layer cache of
  256 pages, layer 2;
- ``decode_b8_d256``, ``verify_s5_d256``, ``verify_s17_d256``,
  ``flash_batch4_s128_d256`` and ``flash_long_step_d256`` (S 512 at base
  4,608, ctx 5,000: ``chip_smoke``'s 5,000-token prompt's last chunk): the
  same rows in gemma-2-9b's attention form
  (H 16, KVH 8, head_dim 256, scale 256^-0.5, softcap 50) over a 2-layer
  cache of 1,024 pages, layer 1 (builds from before head_dim 256 cannot
  run them: pick shapes with ``--shapes``);
- ``mla_decode_b8``: the MLA decode kernel at ``chip_smoke``'s shape (B 8,
  H 16, the decode contexts over 128-page tables of a 27-layer latent
  cache), layer 13, and ``mla_decode_b8_layers`` cycling the 27;
- ``epilogue_b8_v128256`` and ``epilogue_b8_v102400``: the sampling
  epilogue's plain form at ``chip_smoke``'s rows (``EPILOGUE_ROWS``), B 8,
  bf16 logits, no count commit; ``epilogue_finish_extra_b8_v128256``: its
  ``finish`` + ``extra_bias`` form (a guided row, ``chip_smoke``'s finish
  rows).

``--shapes a,b`` times only those shapes, ``--kernels k`` builds only
those kernels from each tree. Kernel 6 (``sp_prefix_14336``) is timed
with ``chip_smoke.cuda_ms``, every other shape with ``chip_smoke.graph_ms``
(device time by a CUDA graph's replay: eager times of calls under ~0.1 ms
are the wrapper's launch rate, and swing by tens of percent). Prints one JSON line per shape: the
times of each build (ms, one a turn), the largest difference between the
first two builds' outputs (the epilogue's logprobs, and its tokens when
they differ), and the card. Needs one CUDA device and ``nvcc``. A build's
C entry points are called by parameter name, read from its source: an
older build whose entry takes other arguments gets the ones it names,
those the wrappers no longer pass made by ``LEGACY`` (the MLA kernel's
partials and keys per split before it merged in one launch, the
epilogue's scratch row before it held the row in a cluster's shared
memory).
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

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


# kernel → (wrapper module, C entry point)
KERNELS = {
    "paged_flash": ("paged_flash", "paged_flash_bf16"),
    "sp_prefix": ("sp_prefix", "sp_prefix_partials_bf16"),
    "paged_decode": ("paged_decode", "paged_decode_bf16"),
    "paged_verify": ("paged_verify", "paged_verify_bf16"),
    "mla_decode": ("mla_decode", "mla_decode_bf16"),
    "sampling_epilogue": ("epilogue", "sampling_epilogue"),
}
_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}
_buffers = {}


def _buffer(shape):
    """An f32 device buffer kept per shape (allocated outside any capture)."""
    import torch

    if shape not in _buffers:
        _buffers[shape] = torch.empty(shape, dtype=torch.float32, device="cuda")
    return _buffers[shape].data_ptr()


def _legacy_mla(named, params):
    """The MLA entry before the one-launch kernel took its own partials
    (part_acc [B, splits, H, R], part_ml [B, splits, H, 2]) and keys per
    split from the SM count instead of the workspace, counters and chunk."""
    import torch

    b, h, r = named["B"], named["H"], named["R"]
    keys = named["W"] * named["bs"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-keys // 64)
    kps = 64 * max(1, -(-(b * tiles * -(-h // 16)) // (2 * sms)))
    splits = -(-keys // kps)
    return dict(kps=kps, splits=splits,
                part_acc=_buffer((b, splits, h, r)),
                part_ml=_buffer((b, splits, h, 2)))


def _legacy_epilogue(named, params):
    """The epilogue entry before the cluster kernel took a [B, V] f32
    scratch row."""
    return dict(scratch=_buffer((named["B"], named["V"])))


# C entry → the arguments an older entry takes that the wrappers no longer
# pass (or pass with another meaning), from the ones they pass, by name
LEGACY = {"mla_decode_bf16": _legacy_mla, "sampling_epilogue": _legacy_epilogue}


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


def build(name: str, csrc: Path, out: Path, current: Path, kernels):
    """The ``kernels`` of ``csrc`` as ctypes functions taking the arguments
    of ``current``'s entry points (the ones the wrappers pass), by name."""
    from dynamo_tpu_torch.ops import _build

    fns = {}
    for kernel in kernels:
        entry = KERNELS[kernel][1]
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
        names = [n for _, n in params]
        legacy = LEGACY.get(entry) if set(names) - set(wanted) else None
        missing = [n for n in names if n not in wanted]
        if missing and legacy is None:
            raise SystemExit(f"{name}: {entry} takes {missing}, which the "
                             "wrapper does not pass")

        def call(*args, fn=fn, names=names, wanted=wanted, legacy=legacy):
            named = dict(zip(wanted, args))
            if legacy is not None:
                named.update(legacy(named, names))
            return fn(*[named[n] for n in names])

        fns[kernel] = call
    return fns



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=CSRC_DIR")
    ap.add_argument("--shapes", default="",
                    help="comma-separated subset of the shapes to time")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels to build from each tree (the others "
                         "run the port's own build)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import importlib

    import chip_smoke as cs
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import epilogue as ep
    from dynamo_tpu_torch.ops import mla_decode as md
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import paged_verify as pv
    from dynamo_tpu_torch.ops import sp_prefix as spx

    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab-"))
    kernels = args.kernels.split(",")
    builds = {}
    for spec in args.builds:
        name, _, csrc = spec.partition("=")
        builds[name] = build(name, Path(csrc), tmp, _build.CSRC, kernels)

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
    # head_dim 128: the decode, verify and flash rows over a 4-layer cache
    k128 = torch.randn(4, 256, BS, KVH, 128, generator=g, device=dev).bfloat16()
    v128 = torch.randn(4, 256, BS, KVH, 128, generator=g, device=dev).bfloat16()
    bt128 = torch.stack([torch.randperm(256, generator=g, device=dev)[:128]
                         for _ in range(9)]).int()
    bt128[8] = 0
    qd128 = torch.randn(8, 1, H, 128, generator=g, device=dev).bfloat16()
    qv128 = torch.randn(9, 5, H, 128, generator=g, device=dev).bfloat16()
    qb128 = torch.randn(4, 128, H, 128, generator=g, device=dev).bfloat16()
    btb128 = bt128[:4].clone()
    btb128[3] = 0
    # gemma-2-9b's attention form: head_dim 256, G 2, softcap 50
    k256 = torch.randn(2, N, BS, KVH, 256, generator=g, device=dev).bfloat16()
    v256 = torch.randn(2, N, BS, KVH, 256, generator=g, device=dev).bfloat16()
    gem = dict(layer_idx=1, scale=256 ** -0.5, softcap=50.0)
    qd256 = torch.randn(8, 1, 16, 256, generator=g, device=dev).bfloat16()
    qv256 = torch.randn(9, 5, 16, 256, generator=g, device=dev).bfloat16()
    q17_256 = torch.randn(9, 17, 16, 256, generator=g, device=dev).bfloat16()
    base17 = torch.clamp(ctxv - 17, min=0)
    qb256 = torch.randn(4, 128, 16, 256, generator=g, device=dev).bfloat16()
    ql256 = torch.randn(1, 512, 16, 256, generator=g, device=dev).bfloat16()
    basel256 = torch.tensor([cs.SOFTCAP_LONG_STEP[0]], dtype=torch.int32,
                            device=dev)
    ctxl256 = torch.tensor([cs.SOFTCAP_LONG_STEP[1]], dtype=torch.int32,
                           device=dev)
    # MLA decode at chip_smoke's shape: V2-Lite's 16 heads, a 27-layer
    # stacked latent cache, the decode contexts over 128-page tables
    ML = 27
    cm = torch.randn(ML, N, BS, 1, 512, generator=g, device=dev).bfloat16()
    krm = torch.randn(ML, N, BS, 1, 64, generator=g, device=dev).bfloat16()
    qlm = (torch.randn(8, 1, 16, 512, generator=g, device=dev) * 0.5).bfloat16()
    qrm = (torch.randn(8, 1, 16, 64, generator=g, device=dev) * 0.5).bfloat16()
    # the epilogue at chip_smoke's rows, B 8, bf16 logits, no count commit
    samp = SamplingParams(**{
        name: torch.tensor(vals, dtype=torch.int64 if name == "top_k"
                           else torch.float32, device=dev)
        for name, vals in cs.EPILOGUE_ROWS.items()})
    slots = torch.tensor([3, 0, 5, 1, 6, 2, 4, 7], device=dev)
    nocommit = torch.zeros(8, dtype=torch.bool, device=dev)

    def epilogue_inputs(V):
        logits = (torch.randn(8, V, generator=g, device=dev) * 4).bfloat16()
        u = torch.rand(8, V, generator=g, device=dev).clamp_(min=1e-30)
        counts = torch.randint(0, 3, (8, V), generator=g, device=dev,
                               dtype=torch.int32)
        seen = torch.randint(0, 2, (8, V), generator=g, device=dev).bool()
        bias = torch.randn(8, V, generator=g, device=dev) * 0.5
        return logits, -torch.log(-torch.log(u)), samp, counts, seen, bias, slots

    e128 = epilogue_inputs(128256)
    e102 = epilogue_inputs(102400)
    extra = torch.zeros(8, 128256, device=dev)
    extra[5] = -1e9
    extra[5, [17, 128254]] = 0.0
    live = torch.ones(8, dtype=torch.bool, device=dev)
    tok0 = ep.fused_sampling_epilogue_ref(*e128[:3], e128[3].clone(), *e128[4:],
                                          live, extra_bias=extra)[0]
    fin = cs._finish_rows(torch, dev, tok0.tolist(), np.ones(8, bool), 128256)
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
        "decode_b8_d128": lambda: pd.paged_decode_attention(
            qd128, k128, v128, bt128[:8], ctx_d, layer_idx=2),
        "verify_s5_d128": lambda: pv.paged_verify_attention(
            qv128, k128, v128, bt128, basev, ctxv, layer_idx=2),
        "flash_batch4_s128_d128": lambda: pf.paged_flash_attention(
            qb128, k128, v128, btb128, baseb, ctxb, layer_idx=2),
        "decode_b8_d256": lambda: pd.paged_decode_attention(
            qd256, k256, v256, btd, ctx_d, **gem),
        "verify_s5_d256": lambda: pv.paged_verify_attention(
            qv256, k256, v256, btv, basev, ctxv, **gem),
        "verify_s17_d256": lambda: pv.paged_verify_attention(
            q17_256, k256, v256, btv, base17, ctxv, **gem),
        "flash_batch4_s128_d256": lambda: pf.paged_flash_attention(
            qb256, k256, v256, btb, baseb, ctxb, **gem),
        "flash_long_step_d256": lambda: pf.paged_flash_attention(
            ql256, k256, v256, btl, basel256, ctxl256, **gem),
        "mla_decode_b8": lambda: md.mla_paged_decode_attention(
            qlm, qrm, cm, krm, btd, ctx_d, layer_idx=13, scale=0.11472),
        "mla_decode_b8_layers": cycling(lambda li: md.mla_paged_decode_attention(
            qlm, qrm, cm, krm, btd, ctx_d, layer_idx=li, scale=0.11472), ML),
        "epilogue_b8_v128256": lambda: ep.fused_sampling_epilogue(
            *e128, nocommit)[:2],
        "epilogue_b8_v102400": lambda: ep.fused_sampling_epilogue(
            *e102, nocommit)[:2],
        "epilogue_finish_extra_b8_v128256": lambda: ep.fused_sampling_epilogue(
            *e128, nocommit, extra_bias=extra, finish=fin,
            max_model_len=cs.EPILOGUE_MAX_LEN)[:2],
    }
    if args.shapes:
        shapes = {name: shapes[name] for name in args.shapes.split(",")}
    names = list(builds)
    times = {s: {n: [] for n in names} for s in shapes}
    outs = {}
    wrappers = {kernel: importlib.import_module(
        f"dynamo_tpu_torch.ops.{KERNELS[kernel][0]}") for kernel in kernels}
    for name in names + names[::-1]:
        for kernel, mod in wrappers.items():
            mod._lib = lambda fn=builds[name][kernel]: fn
        for shape, fn in shapes.items():
            # most kernels run faster than their wrappers launch them: their
            # device time comes from a CUDA graph's replay
            timer = cs.cuda_ms if shape.startswith("sp_prefix") else cs.graph_ms
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
        if shape.startswith("epilogue"):  # tokens must agree; logprobs
            if not torch.equal(a[0], b[0]):
                print(json.dumps({"shape": shape, "tokens_differ": [
                    a[0].tolist(), b[0].tolist()]}), flush=True)
            a, b = a[1], b[1]
        # flash rows past ctx are discarded by the caller: compare the rest
        if shape == "flash_long_dense_step":
            a, b = [x[0, :cs.LONG_DENSE_STEP[1] - cs.LONG_DENSE_STEP[0]]
                    for x in (a, b)]
        if shape == "flash_long_step_d256":
            a, b = [x[0, :cs.SOFTCAP_LONG_STEP[1] - cs.SOFTCAP_LONG_STEP[0]]
                    for x in (a, b)]
        if shape.startswith("flash_batch4_s128"):
            a, b = [torch.cat([x[0], x[1], x[2, :76]]) for x in (a, b)]
        if shape.startswith("verify_s"):  # the pad row's queries past ctx
            a, b = a[:-1], b[:-1]
        print(json.dumps({"shape": shape, "ms": times[shape],
                          "max_abs_diff_first_two": float(
                              (a.float() - b.float()).abs().max()),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
