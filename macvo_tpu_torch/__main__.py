"""MAC-VO runner of the PyTorch/CUDA port (counterpart of ``macvo.py``).

Usage:
    python -m macvo_tpu_torch --odom configs/experiment/macvo/MACVO_Performant.yaml \\
                              --data configs/sequence/TartanAirv2_RealAsset.yaml
    python -m macvo_tpu_torch --odom configs/experiment/baseline/TartanVO.yaml \\
                              --data configs/sequence/TartanAirv2_RealAsset.yaml
    python -m macvo_tpu_torch --odom configs/experiment/macvo/MACVO_Performant.yaml \\
                              --data configs/sequence/GeneralStereo_example.yaml --preload

Builds the odometry class the config's ``Odometry.type`` names (``MACVO``,
the default, or the ``TartanVO`` baseline), reads the sequence (any
registered loader: TartanAir v1/v2, KITTI, EuRoC, VBR, GeneralStereo,
SyntheticStereo), applies the config's ``Preprocess`` transforms (e.g.
``SmartResizeFrame`` for KITTI and GeneralStereo), runs it over the sequence on
``--device`` (``cuda`` by default) and writes into a new result sandbox
``<resultRoot>/<name>/<%m_%d_%H%M%S>`` (``_1``, ``_2``, ... appended when a run
of the same name already holds that stamp): ``metadata.yaml`` (time, git
commit, command line), ``config.yaml`` (the odometry config, with the
sequence config as ``Data``), ``poses.npy`` / ``ref_poses.npy`` /
``need_interp.npy`` / ``tensor_map.npz`` (and, with ``profile: true``, a trace
of frame 2 under ``trace/``). Unless ``--noeval`` it prints ATE, RTE, ROE and
RPE against the ground truth interpolated onto the estimate's timestamps.

``--timing`` prints the time of each stage (``Odom_Runtime``, ``Frontend.estimate``,
``Frontend.forward``, ``KP pipeline``, ``Sync consume``, ``TwoframePGO.dispatch``:
host time; ``Frontend.forward (device)``: the frontend's work on the card from
CUDA events) and writes them to ``elapsed_time.json``; ``--saveplt`` writes
the trajectory and error figures into ``<sandbox>/plots`` (it needs
matplotlib, and says so before the run when it is missing); ``--autoremove``
deletes the sandbox when the process exits.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path


def build_sequence(data_cfg, odom_cfg, seq_from=None, seq_to=None, preload=False):
    """The sequence a run reads, as ``macvo.py`` builds it: clipped, then
    wrapped in the odometry config's ``Preprocess`` transforms, then (with
    ``preload``) read into RAM."""
    from .data import SequenceBase, smart_transform

    seq = SequenceBase.from_config(data_cfg.Sequence if hasattr(data_cfg, "Sequence") else data_cfg)
    if seq_from is not None or seq_to is not None:
        seq.clip(seq_from, seq_to)
    if hasattr(odom_cfg, "Preprocess"):
        seq = smart_transform(seq, odom_cfg.Preprocess)
    if preload:
        seq = seq.preload()
    return seq


def main(argv=None):
    """Run as the module doc says; returns the run's :class:`Sandbox`."""
    parser = argparse.ArgumentParser(description="MAC-VO odometry runner (PyTorch/CUDA port)")
    parser.add_argument("--odom", type=str, required=True, help="odometry config yaml")
    parser.add_argument("--data", type=str, default=None,
                        help="sequence config yaml (default: Data section of --odom)")
    parser.add_argument("--seq_from", type=int, default=None, help="clip start frame")
    parser.add_argument("--seq_to", type=int, default=None, help="clip end frame")
    parser.add_argument("--resultRoot", type=str, default="./results")
    parser.add_argument("--preload", action="store_true", help="RAM-preload the sequence")
    parser.add_argument("--autoremove", action="store_true", help="remove the result sandbox on exit")
    parser.add_argument("--noeval", action="store_true", help="skip metric evaluation")
    parser.add_argument("--timing", action="store_true", help="time each stage; writes elapsed_time.json")
    parser.add_argument("--saveplt", action="store_true", help="save trajectory/error figures into the sandbox")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    if args.saveplt and importlib.util.find_spec("matplotlib") is None:
        raise ImportError("--saveplt draws its figures with matplotlib, which is not installed here; run "
                          "without --saveplt and plot the sandbox later with "
                          "python -m macvo_tpu_torch.evaluation.plot_seq --spaces <sandbox>")

    from .data import DevicePrefetcher
    from .evaluation import evaluate_sandbox
    from .odometry import build_odometry
    from .utils import timer
    from .utils.config import load_config, save_config
    from .utils.device import resolve_device
    from .utils.logging import print_as_table
    from .utils.sandbox import Sandbox

    device = resolve_device(args.device)
    odom_cfg, odom_dict = load_config(Path(args.odom))
    if args.data is not None:
        data_cfg, odom_dict["Data"] = load_config(Path(args.data))
    else:
        data_cfg = odom_cfg.Data
    seq = build_sequence(data_cfg, odom_cfg, args.seq_from, args.seq_to, args.preload)
    name = getattr(odom_cfg.Odometry, "name", "MACVO")
    sandbox = Sandbox.create(args.resultRoot, name)
    if args.autoremove:
        sandbox.set_autoremove()
    save_config(odom_dict, sandbox.path("config.yaml"))
    timer.setup(args.timing)
    timer.reset()

    system = build_odometry(odom_cfg, device=device)
    print(f"Running {name} on {seq} ({device}) -> {sandbox.folder}", flush=True)
    system.receive_frames(DevicePrefetcher(seq, device), saveto=sandbox)

    if args.timing:
        timer.report()
        timer.save_elapsed(sandbox.path("elapsed_time.json"))

    if args.saveplt and sandbox.path("ref_poses.npy").exists():
        from .evaluation.plot_seq import plot_separately

        plot_separately([str(sandbox.folder)], sandbox.path("plots"))
        print(f"figures saved to {sandbox.path('plots')}", flush=True)

    if not args.noeval and sandbox.path("ref_poses.npy").exists():
        metrics = evaluate_sandbox(sandbox)
        print_as_table(["metric", "mean", "std", "rmse", "max"],
                       [[k, f"{v.mean:.6f}", f"{v.std:.6f}", f"{v.rmse:.6f}", f"{v.max:.6f}"]
                        for k, v in metrics.items()],
                       title=f"Evaluation — {name}")
    return sandbox


if __name__ == "__main__":
    main()
