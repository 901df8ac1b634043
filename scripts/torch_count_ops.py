"""Count the tensor operations the port dispatches for one call of a stage.

    python scripts/torch_count_ops.py

On a card nearly every dispatched operation is one kernel launch (views are
counted too and launch nothing), and a launch costs the host some
microseconds, so this count is what bounds a stage that is bound by the
host. The count does not depend on the device, so this runs on the CPU, at
the main path's shapes: the device-chained LM solve on a (201, 52) sync
array and the 12-step decoder (its op count does not depend on the image
size; a small one keeps the run short).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class OpCounter(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    counter = OpCounter()
    with torch.inference_mode(), counter:
        fn()
    return counter.count


def main() -> None:
    from macvo_tpu_torch.backend.two_frame_pgo import solve_sync_packed
    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov
    from macvo_tpu_torch.odometry.layout import COL_KEEP, OBS_COLS, PACKED_SYNC_WIDTH

    rng = np.random.default_rng(0)
    n = 200
    sync = np.zeros((n + 1, PACKED_SYNC_WIDTH), np.float32)
    for name, lo_hi in (("pixel1_uv", (100, 500)), ("pixel2_uv", (100, 500)),
                        ("pixel1_d", (2, 10)), ("pixel2_d", (2, 10)), ("pixel2_disp", (5, 20))):
        lo, hi = OBS_COLS[name]
        sync[:n, lo:hi] = rng.uniform(*lo_hi, (n, hi - lo))
    for name, value in (("pixel2_uv_cov", [0.25, 0.25, 0.0]), ("pixel2_disp_cov", [0.25]),
                        ("obs1_covTc", np.eye(3).ravel() * 0.01), ("obs2_covTc", np.eye(3).ravel() * 0.01)):
        lo, hi = OBS_COLS[name]
        sync[:n, lo:hi] = value
    sync[:n, COL_KEEP] = 1.0
    sync[n, 3:7] = [0, 0, 0, 1.0]
    anchor = torch.tensor([0, 0, 0, 0, 0, 0, 1.0])
    cam = torch.tensor([320.0, 320.0, 320.0, 320.0])
    solve_ops = count(lambda: solve_sync_packed(torch.from_numpy(sync), anchor, cam, torch.tensor(0.25), "disp"))

    model = FlowFormerCov(FlowFormerConfig(decoder_depth=12, inference_only=True)).eval()
    ctx, mem, maps = torch.randn(2, 8, 12, 256), torch.randn(2 * 96, 8, 128), torch.randn(2, 96, 8, 12)
    decoder_ops = count(lambda: model.memory_decoder(mem, ctx, maps))
    print(json.dumps({"solve_sync_packed_ops": solve_ops, "decoder_12_steps_ops": decoder_ops}))


if __name__ == "__main__":
    main()
