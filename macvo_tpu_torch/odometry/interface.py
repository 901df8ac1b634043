"""Odometry runtime base: the receive-frames loop (port of ``macvo_tpu/odometry/interface.py``).

``receive_frames`` runs every frame, keeps the GT poses, and at the end
(also after an error, which it then re-raises) terminates the system and,
given an output directory, writes ``poses.npy`` (time + body-frame SE3),
``ref_poses.npy`` and ``tensor_map.npz``. With ``profile`` set, frame 2 runs
under ``torch.profiler`` and its trace goes to ``trace/frame2.json`` in the
output directory (Chrome trace format; card activity where there is a card).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Generic, Iterable, Optional, TypeVar

import numpy as np
import torch

from ..data.frame import StereoFrame
from ..geometry import se3_np
from ..utils.logging import Logger
from ..worldmap import VisualMap

T_Frame = TypeVar("T_Frame", bound=StereoFrame)


class IOdometry(Generic[T_Frame]):
    def __init__(self, profile: bool = False) -> None:
        self.profile = profile
        self.gt_poses: list[np.ndarray] = []
        self.terminated = False

    def run(self, frame: T_Frame) -> None:
        raise NotImplementedError

    def get_map(self) -> VisualMap:
        raise NotImplementedError

    def terminate(self) -> None:
        self.terminated = True

    def receive_frames(self, sequence: Iterable[T_Frame], saveto: Optional[Path] = None,
                       on_frame_finished: Optional[Callable[[T_Frame, "IOdometry"], None]] = None) -> None:
        if self.profile and saveto is None:
            Logger.warning("profile: true needs an output directory for its trace; none is written")
        try:
            for i, frame in enumerate(sequence):
                if self.profile and i == 2 and saveto is not None:
                    self.run_traced(frame, Path(saveto) / "trace")
                else:
                    self.run(frame)
                if frame.gt_pose is not None:
                    self.gt_poses.append(np.asarray(frame.gt_pose).reshape(7))
                if on_frame_finished is not None:
                    on_frame_finished(frame, self)
        finally:
            self.terminate()
            if saveto is not None:
                self.save_results(Path(saveto))

    def run_traced(self, frame: T_Frame, trace_dir: Path) -> None:
        """``run(frame)`` under ``torch.profiler``; the trace goes to
        ``trace_dir/frame2.json``."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        trace_dir.mkdir(parents=True, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            self.run(frame)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace_dir / "frame2.json"))

    def save_results(self, saveto: Path) -> None:
        saveto.mkdir(parents=True, exist_ok=True)
        graph = self.get_map()
        frames = graph.frames
        n = len(frames)
        if n > 0:
            poses = frames.data["pose"][:n].astype(np.float64)
            T_BS = frames.data["T_BS"][:n].astype(np.float64)
            body = se3_np.mul(se3_np.mul(T_BS, poses), se3_np.inv(T_BS))
            time_s = frames.data["time_ns"][:n].astype(np.float64)[:, None] / 1e9
            np.save(saveto / "poses.npy", np.concatenate([time_s, body], axis=1))
            np.save(saveto / "need_interp.npy", frames.data["need_interp"][:n])
            graph.save(saveto / "tensor_map.npz")
        if self.gt_poses:
            gt = np.stack(self.gt_poses).astype(np.float64)
            time_s = frames.data["time_ns"].astype(np.float64)[: gt.shape[0], None] / 1e9
            np.save(saveto / "ref_poses.npy", np.concatenate([time_s, gt], axis=1))
