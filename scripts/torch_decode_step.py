#!/usr/bin/env python3
"""Time of one single-token decode step of the PyTorch/CUDA port's runner.

Builds a ``ModelRunner`` at the ``chip_smoke.py`` Llama-3.2-1B shapes
(seeded random bf16 weights, 8 rows at the decode contexts {1, 15, 16, 17,
513, 2048, 700, 1500}, every KV slot the drop sentinel, greedy rows) and
times ``--steps`` calls of ``runner.step`` on the host clock, in
``--rounds`` rounds, each ended by one ``torch.cuda.synchronize()``: the
rate at which the host can dispatch steps, which is what bounds a
host-bound decode loop. It uses only what every tree of the port has
(``ModelRunner.step``), so two checkouts can be timed in turns inside one
call on one card:

    python3 scripts/torch_decode_step.py --tree . --tree _chipcheck/parent \\
        --tree _chipcheck/parent --tree .

Each ``--tree`` runs in a process of its own with that directory first on
``sys.path``. Prints one JSON line per tree.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def measure(steps: int, rounds: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.model_runner import ModelRunner

    cfg = EngineConfig(model=ModelConfig(**chip_smoke.FLAGSHIP),
                       seed=chip_smoke.SEED, **chip_smoke.ENGINE)
    runner = ModelRunner(cfg, device="cuda")
    runner.warmup()
    b, w = cfg.max_batch_size, cfg.blocks_per_seq
    ctx = np.asarray([1, 15, 16, 17, 513, 2048, 700, 1500][:b], np.int32)
    bt = np.arange(b * w, dtype=np.int32).reshape(b, w) % cfg.num_kv_blocks
    args = (np.zeros((b, 1), np.int32), (ctx - 1)[:, None], bt,
            np.full((b, 1), -1, np.int32), ctx, np.zeros(b, np.int32),
            np.zeros(b, np.float32), np.zeros(b, np.int32),
            np.ones(b, np.float32))
    for _ in range(5):
        runner.step(*args, want_top=False)
    torch.cuda.synchronize()
    per_step = []
    for _ in range(rounds):
        t0 = time.monotonic()
        for _ in range(steps):
            runner.step(*args, want_top=False)
        torch.cuda.synchronize()
        per_step.append(1e3 * (time.monotonic() - t0) / steps)
    return dict(card=chip_smoke.nvidia_smi_line(), steps=steps,
                step_ms=per_step, step_ms_min=min(per_step),
                step_ms_median=sorted(per_step)[len(per_step) // 2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="checkout to time (repeat to take turns); none = "
                         "this process, this checkout")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=5)
    a = ap.parse_args()
    if not a.tree:
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        print(json.dumps(measure(a.steps, a.rounds)), flush=True)
        return 0
    for tree in a.tree:
        root = Path(tree).resolve()
        code = (f"import sys, json; sys.path.insert(0, {str(root)!r}); "
                f"sys.path.insert(0, {str(Path(__file__).resolve().parent)!r}); "
                "import torch_decode_step as m; "
                f"print(json.dumps(dict(tree={tree!r}, "
                f"**m.measure({a.steps}, {a.rounds}))), flush=True)")
        rc = subprocess.run([sys.executable, "-c", code], cwd=str(root)).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
