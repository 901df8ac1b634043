"""Batched multi-sequence odometry: one frontend forward for N sequences
(port of ``macvo_tpu/parallel/batch_odometry.py``).

MAC-VO's learned frontend already batches a frame's two pairs (stereo t1 and
flow t0 -> t1). Here N sequences run in lockstep: their pairs stack into one
padded FlowFormerCov forward of batch 2N, which makes one latent-attention
launch for all of them, and each sequence's keypoint pipeline, map and
backend solve proceed on their own behind a frontend shim that hands back
the outputs staged for it. The forward's launches, and the host's cost of
making them, are paid once a step instead of once a sequence.

On one card the whole batch runs there. With a ``DeviceMesh`` of several
ranks (one process a card, :mod:`.mesh`), each rank runs its contiguous
share of the sequences: the counterpart of the JAX package's batch sharded
over the ``data`` axis.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Optional, Sequence

import torch

from ..data.frame import StereoData
from ..modules.frontend import DepthOutput, IFrontend, MatchOutput
from ..modules.frontend_network import DEVICE_SECTION, _FlowFormerRunner, flow_to_depth
from ..odometry import MACVO
from ..utils import timer
from ..utils.device import resolve_device


class _PrecomputedFrontend(IFrontend):
    """Frontend shim fed by the batched runner: returns the outputs staged
    for this sequence at the current step."""

    def __init__(self, config: SimpleNamespace | None = None, device="cuda") -> None:
        super().__init__(config or SimpleNamespace(), device)
        self.staged: Optional[tuple[DepthOutput, MatchOutput]] = None
        self.staged_depth: Optional[DepthOutput] = None

    @property
    def provide_cov(self) -> tuple[bool, bool]:
        return True, True

    def estimate_depth(self, frame: StereoData) -> DepthOutput:
        assert self.staged_depth is not None
        return self.staged_depth

    def estimate_pair(self, frame_t1: StereoData, frame_t2: StereoData):
        assert self.staged is not None
        return self.staged

    @classmethod
    def is_valid_config(cls, config) -> None:
        return


class BatchedFrontend:
    """N-sequence FlowFormerCov forward on one device: one padded forward of
    every sequence's pairs, split back into per-sequence outputs.

    On the card the forward autotunes its convolutions (``cudnn.benchmark``
    for its own duration): at batch 4 and more cuDNN's heuristic picks an
    FFT algorithm for fp32 convolutions with TF32 off that takes 1.3–3.9 s a
    640x640 forward on an H100, against ~0.13 s for one pair
    (``PERF.md``, PR 12)."""

    def __init__(self, config: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self.runner = _FlowFormerRunner(config, self.device)
        self.enforce_positive = bool(getattr(config, "enforce_positive_disparity", False))

    def _depth(self, flow, cov, frame: StereoData) -> DepthOutput:
        return flow_to_depth(flow, cov, frame.frame_baseline, frame.fx, self.enforce_positive)

    def _inference(self, img_a, img_b):
        benchmark = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = self.device.type == "cuda" or benchmark
        try:
            return self.runner.inference(img_a, img_b)
        finally:
            torch.backends.cudnn.benchmark = benchmark

    @torch.inference_mode()
    def forward_pairs(self, frames0: Sequence[StereoData], frames1: Sequence[StereoData]):
        """One forward for all sequences' (stereo t1, flow t0 -> t1) pairs,
        stacked as ``[L(t1)...] + [L(t0)...]`` against ``[R(t1)...] + [L(t1)...]``.
        Returns per-sequence (DepthOutput_t1, MatchOutput_01)."""
        with timer.cpu_time("Frontend.forward"), timer.device_time(DEVICE_SECTION, self.device):
            img_a = torch.cat([f1.imageL for f1 in frames1] + [f0.imageL for f0 in frames0], dim=0)
            img_b = torch.cat([f1.imageR for f1 in frames1] + [f1.imageL for f1 in frames1], dim=0)
            flow, cov = self._inference(img_a, img_b)
            n = len(frames0)
            return [(self._depth(flow[i:i + 1], cov[i:i + 1], frames1[i]),
                     MatchOutput.from_partial_cov(flow=flow[n + i:n + i + 1], cov=cov[n + i:n + i + 1]))
                    for i in range(n)]

    @torch.inference_mode()
    def forward_depths(self, frames: Sequence[StereoData]) -> list[DepthOutput]:
        """One stereo forward for every sequence's first frame."""
        img_a = torch.cat([f.imageL for f in frames], dim=0)
        img_b = torch.cat([f.imageR for f in frames], dim=0)
        flow, cov = self._inference(img_a, img_b)
        return [self._depth(flow[i:i + 1], cov[i:i + 1], f) for i, f in enumerate(frames)]


class BatchedOdometry:
    """Run N sequences in lockstep behind one batched frontend.

    ``cfg`` is a MACVO config whose frontend is a ``FlowFormerCovFrontend``;
    its args build the shared frontend and every sequence gets its own MACVO
    with the shim in its place. With ``mesh`` (a 1-D ``DeviceMesh``), this
    rank runs sequences ``rank*k .. rank*k+k-1`` of the N, k = N / mesh size;
    :attr:`indices` names them. ``frontend`` shares an existing
    :class:`BatchedFrontend` (and its model) instead of building one."""

    def __init__(self, cfg, n_sequences: int, mesh=None, device: str | torch.device = "cuda",
                 frontend: BatchedFrontend | None = None) -> None:
        self.device = resolve_device(device)
        ranks, rank = (1, 0) if mesh is None else (mesh.size(), mesh.get_rank())
        if n_sequences % ranks:
            raise ValueError(f"{n_sequences} sequences do not split over {ranks} ranks")
        k = n_sequences // ranks
        self.indices = list(range(rank * k, rank * k + k))
        self.frontend = frontend or BatchedFrontend(cfg.Odometry.frontend.args, self.device)
        self.systems: list[MACVO] = []
        self.shims: list[_PrecomputedFrontend] = []
        for _ in self.indices:
            system = MACVO.from_config(_with_precomputed_frontend(cfg), device=self.device)
            assert isinstance(system.Frontend, _PrecomputedFrontend)
            self.systems.append(system)
            self.shims.append(system.Frontend)

    def step(self, frames: Sequence) -> None:
        """Advance every sequence by one frame: ``frames`` holds one frame of
        each of the N sequences (on the device); this rank takes its own."""
        frames = [frames[i] for i in self.indices]
        if any(not s.is_initiated for s in self.systems):
            for shim, d in zip(self.shims, self.frontend.forward_depths([f.stereo for f in frames])):
                shim.staged_depth = d
        else:
            pairs = self.frontend.forward_pairs([s.prev_keyframe[0].stereo for s in self.systems],
                                                [f.stereo for f in frames])
            for shim, out in zip(self.shims, pairs):
                shim.staged = out
        for system, frame in zip(self.systems, frames):
            system.run(frame)

    def finish(self) -> None:
        """Flush every sequence's pending sync and backend solve."""
        for system in self.systems:
            system.terminate()

    def run(self, sequences: Sequence, max_frames: Optional[int] = None) -> None:
        """Step through the shortest sequence (at most ``max_frames``), each
        frame moved to the device, then :meth:`finish`."""
        n = min(len(s) for s in sequences)
        if max_frames is not None:
            n = min(n, max_frames)
        for i in range(n):
            self.step([seq[i].to(self.device) for seq in sequences])
        self.finish()


def _with_precomputed_frontend(cfg):
    """A copy of the config with the frontend swapped for the shim."""
    cfg2 = copy.deepcopy(cfg)
    cfg2.Odometry.frontend = SimpleNamespace(type="_PrecomputedFrontend", args=SimpleNamespace())
    return cfg2
