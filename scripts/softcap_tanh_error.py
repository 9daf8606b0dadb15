#!/usr/bin/env python3
"""Measure, on the card, the error of three ways to take tanh for the
attention kernels' logit softcap, ``cap * tanh(score / cap)``.

The forms: ``tanhf`` (CUDA's accurate libdevice function), PTX's
``tanh.approx.f32``, and ``1 - 2 / (2^(2 x log2 e) + 1)`` on
``ex2.approx`` (the kernels' ``tanh_ex2``, taken from
``csrc/paged_splitkv.cuh`` itself). Each is evaluated on the card over
2^22 scores evenly spaced in [-4 cap, 4 cap] for a cap of 50 (Gemma-2's
attention cap) and of 5, and held against numpy's float64 tanh of the same
f32 inputs. Prints one JSON line per cap: the largest absolute error of
the capped score in logit units for each form, and the card.

Run from the repository root on a machine with one CUDA device and
``nvcc``: ``python3 scripts/softcap_tanh_error.py``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

SOURCE = r"""
#include "paged_splitkv.cuh"

__global__ void tanh_forms(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  float approx;
  asm("tanh.approx.f32 %0, %1;" : "=f"(approx) : "f"(v));
  out[i] = tanhf(v);
  out[n + i] = approx;
  out[2 * n + i] = paged_splitkv::tanh_ex2(v);
}

extern "C" int run(const void* x, void* out, int n) {
  tanh_forms<<<(n + 255) / 256, 256>>>(static_cast<const float*>(x),
                                       static_cast<float*>(out), n);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : (int)cudaDeviceSynchronize();
}
"""
FORMS = ("tanhf", "tanh.approx.f32", "ex2.approx: 1 - 2 / (2^(2x log2 e) + 1)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("softcap_tanh_error: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dynamo_tpu_torch.ops import _build

    tmp = Path(tempfile.mkdtemp(prefix="tanh_forms-"))
    (tmp / "tanh_forms.cu").write_text(SOURCE)
    so = tmp / "tanh_forms.so"
    res = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(so), str(tmp / "tanh_forms.cu")], capture_output=True, text=True)
    if res.returncode:
        print(res.stdout + res.stderr, file=sys.stderr)
        return 1
    fn = ctypes.CDLL(str(so)).run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    card = cs.nvidia_smi_line()
    n = 1 << 22
    for cap in (50.0, 5.0):
        scores = np.linspace(-4 * cap, 4 * cap, n, dtype=np.float32)
        x = (scores / np.float32(cap)).astype(np.float32)
        xd = torch.from_numpy(x).cuda()
        out = torch.empty(3 * n, dtype=torch.float32, device="cuda")
        rc = fn(xd.data_ptr(), out.data_ptr(), n)
        if rc:
            raise RuntimeError(f"tanh_forms: cudaError {rc}")
        got = out.cpu().numpy().reshape(3, n).astype(np.float64)
        want = np.tanh(x.astype(np.float64))
        err = {form: float(cap * np.abs(got[i] - want).max())
               for i, form in enumerate(FORMS)}
        print(json.dumps({"cap": cap, "scores": [-4 * cap, 4 * cap, n],
                          "max_abs_logit_error": err, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
