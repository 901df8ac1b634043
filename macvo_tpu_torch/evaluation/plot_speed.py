"""Per-frame speed comparison across result sandboxes (port of
``macvo_tpu/evaluation/plot_speed.py``; reference: Evaluation/PlotSpeed.py:12-51).

Reads each sandbox's ``elapsed_time.json`` (the timer's section records; the
``Odom_Runtime`` section is per-frame wall time in ms) and plots the
cumulative density of per-frame time, one curve per run:

    python -m macvo_tpu_torch.evaluation.plot_speed --spaces <sandbox...> \
        [--recursive] [--out Results/speed.png] [--section Odom_Runtime]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..utils.logging import Logger
from ..utils.sandbox import Sandbox
from ..viz.plot_trajectory import plot_speed_figure


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spaces", type=str, nargs="+", required=True)
    ap.add_argument("--recursive", action="store_true")
    ap.add_argument("--out", type=str, default="Results/speed.png")
    ap.add_argument("--section", type=str, default="Odom_Runtime",
                    help="timer section to plot (per-frame wall time)")
    args = ap.parse_args(argv)

    spaces = list(args.spaces)
    if args.recursive:
        expanded = []
        for space in spaces:
            expanded.extend(str(c.folder) for c in Sandbox.load(space).get_leaves())
        spaces = expanded

    named = []
    for space in spaces:
        box = Sandbox.load(space)
        p = box.path("elapsed_time.json")
        if not p.exists():
            Logger.warning(f"{space}: no elapsed_time.json (run with --timing), skipped")
            continue
        with open(p) as f:
            records = json.load(f)
        if args.section not in records:
            Logger.warning(f"{space}: section '{args.section}' not recorded "
                           f"(has {sorted(records)}), skipped")
            continue
        elapsed_s = np.asarray(records[args.section], dtype=np.float64) / 1e3
        odom_cfg = getattr(box.config, "Odometry", None)
        name = getattr(odom_cfg, "name", None) or Path(space).name
        named.append((name, elapsed_s))

    if not named:
        Logger.error("nothing to plot")
        return
    out = plot_speed_figure(named, args.out)
    Logger.info(f"saved {out}")


if __name__ == "__main__":
    main()
