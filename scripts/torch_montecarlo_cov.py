#!/usr/bin/env python
"""Monte-Carlo check of the 2D->3D covariance projection of the PyTorch/CUDA
port (counterpart of ``scripts/montecarlo_cov.py``).

Samples pixel and depth observations from known distributions, backprojects
them, and compares their empirical 3D covariance with the closed form of
``macvo_tpu_torch/ops/cov_project.py``. Prints the relative Frobenius error
of each case and exits 1 if the worst is at or above ``--tol``:

    python scripts/torch_montecarlo_cov.py [--samples 2000000] [--tol 0.05] [--seed 0]

Host-side numpy and torch on the CPU: no card is needed.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

# (u, v, depth, sigma_uu, sigma_vv, sigma_uv, sigma_dd)
CASES = [
    (320.0, 240.0, 5.0, 1.0, 1.0, 0.0, 0.01),      # principal point
    (480.0, 120.0, 10.0, 2.0, 0.5, 0.3, 0.05),     # off-center, correlated
    (100.0, 400.0, 2.0, 0.5, 0.5, -0.2, 0.002),    # near, anti-correlated
]


def empirical_covariance(u, v, d, fx, fy, cx, cy) -> np.ndarray:
    pts = np.stack([d, (u - cx) * d / fx, (v - cy) * d / fy], axis=1)
    return np.cov(pts.T)


def main(argv=None) -> int:
    """Run the cases; returns the exit code (0 when the worst error is under ``--tol``)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--samples", type=int, default=2_000_000)
    parser.add_argument("--tol", type=float, default=0.05)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    from macvo_tpu_torch.ops.cov_project import covariance_2to3_full

    rng = np.random.default_rng(args.seed)
    fx = fy = 320.0
    cx, cy = 320.0, 240.0
    worst = 0.0
    for u0, v0, d0, suu, svv, suv, sdd in CASES:
        uv = rng.multivariate_normal([u0, v0], np.array([[suu, suv], [suv, svv]]), size=args.samples)
        d = rng.normal(d0, np.sqrt(sdd), size=args.samples)
        emp = empirical_covariance(uv[:, 0], uv[:, 1], d, fx, fy, cx, cy)
        one = [torch.tensor([x], dtype=torch.float64) for x in (suu, suv, svv, sdd, u0, v0, d0)]
        pred = covariance_2to3_full(*one, fx, fy, cx, cy)[0].numpy()
        rel = float(np.linalg.norm(pred - emp) / np.linalg.norm(emp))
        worst = max(worst, rel)
        print(f"u={u0:6.1f} v={v0:6.1f} d={d0:5.1f}: relative error {rel:.4f}")
    print(f"worst-case relative error: {worst:.4f} (tol {args.tol})")
    return 0 if worst < args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
