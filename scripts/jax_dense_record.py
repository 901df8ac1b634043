"""Dense-evaluation record of the JAX package on the real clip: the reference
for the ``dense`` phase of ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python scripts/jax_dense_record.py [--frames 10] [--decoder_depth 12]

Runs ``FlowFormerCovMatcher`` and ``FlowFormerCovDepth`` (fp32, the shipped
checkpoint ``model/MACVO_FrontendCov.npz``, ``enforce_positive_disparity``
off) on the first ``--frames`` frames of the 640x640 TartanAir v2 clip with
ground truth, and prints one JSON line: ``evaluate_flow`` and
``evaluate_flowcov`` over the consecutive pairs, ``evaluate_depth`` and
``evaluate_depthcov`` over the frames, the settings and the wall time. Each
module estimates a pair or a frame once; the two evaluations of a module
read that one estimate. No random draws: fp32 on both sides of the card's
comparison.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CLIP = ROOT / "assets/test_sequence/TartanAir2_abs_P000"


class Memo:
    """Estimates of ``module`` remembered by the frames' time stamps."""

    def __init__(self, module) -> None:
        self.module, self.seen, self.calls = module, {}, 0

    def estimate(self, *frames):
        key = tuple(int(f.time_ns[0]) for f in frames)
        if key not in self.seen:
            self.calls += 1
            self.seen[key] = self.module.estimate(*frames)
        return dataclasses.replace(self.seen[key])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--decoder_depth", type=int, default=12)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from macvo_tpu.data.datasets.tartanair import TartanAirV2
    from macvo_tpu.evaluation import dense
    from macvo_tpu.modules.frontend_network import FlowFormerCovDepth, FlowFormerCovMatcher

    cfg = SimpleNamespace(weight=str(ROOT / "model/MACVO_FrontendCov.npz"), enc_dtype="fp32", dec_dtype="fp32",
                          decoder_depth=args.decoder_depth, enforce_positive_disparity=False)
    seq = TartanAirV2({"root": str(CLIP), "compressed": True, "gtFlow": True, "gtDepth": True, "gtPose": True})
    frames = [seq[i] for i in range(args.frames)]
    start = time.perf_counter()
    matcher, depth = Memo(FlowFormerCovMatcher(cfg)), Memo(FlowFormerCovDepth(cfg))
    rec = {"flow": dataclasses.asdict(dense.evaluate_flow(matcher, frames)),
           "flowcov": dataclasses.asdict(dense.evaluate_flowcov(matcher, frames)),
           "depth": dataclasses.asdict(dense.evaluate_depth(depth, frames)),
           "depthcov": dataclasses.asdict(dense.evaluate_depthcov(depth, frames))}
    print(json.dumps({"frames": args.frames, "decoder_depth": args.decoder_depth, "size": [640, 640],
                      "estimates": {"matcher": matcher.calls, "depth": depth.calls},
                      "jax": jax.__version__, "wall_s": time.perf_counter() - start, **rec}), flush=True)


if __name__ == "__main__":
    main()
