"""Where a frame's time goes on the card.

    python scripts/torch_profile_frame.py [--odom CONFIG ...] [--out DIR] [--tree DIR]

For each odometry config (default: MACVO_Performant, MACVO_Fast and the
TartanVO baseline) on the real 640x640 clip: warms up on the first frames, then

* times each stage of one steady-state frame with CUDA events (median of
  ``--reps`` repeats). MAC-VO: Twins features of the two new images, context
  of the left image, all-pairs correlation, the cost perceiver (its input
  stage is the latent-attention kernel on the folded weights, also timed
  alone), the 12-step decoder, the keypoint pipeline, the dense-mapping
  pipeline and the device-chained solve. TartanVO: the matcher (PWC net
  alone, and its five local-correlation kernel calls alone), the stereo
  depth (net alone), the pose-net input and the pose net;
* runs ``--profiled`` whole frames plain (wall time per frame, with a sync
  after each), then ``--profiled`` more under ``torch.profiler``: device time
  per frame (summed kernel and copy time; one stream, so little overlap), the
  device's busy share (that over the plain wall time) and the kernels with
  the most device time.

``--tree`` imports ``macvo_tpu_torch`` from another checkout (an earlier
commit unpacked with ``git archive`` into a directory ``.gitignore`` lists),
with the weights and the clip still read from this one, so that two versions
of the package can be profiled in turns in one call on one card.

Prints one JSON object per config and writes it to ``<out>/profile_<name>.json``.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CLIP = ROOT / "assets" / "test_sequence" / "TartanAir2_abs_P000"


def _timed(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_tartanvo(cfg, frames, reps: int, profiled: int) -> tuple[object, int, dict]:
    """Per-stage times of the TartanVO baseline on its last steady pair."""
    from macvo_tpu_torch.models.tartanvo import normalize_image
    from macvo_tpu_torch.modules.frontend_tartanvo import crop_margins
    from macvo_tpu_torch.odometry import TartanVO
    from macvo_tpu_torch.ops.correlation import local_correlation

    system = TartanVO.from_config(cfg, device=torch.device("cuda"))
    warm = len(frames) - 2 * profiled
    for f in frames[:warm]:
        system.run(f)
    torch.cuda.synchronize()
    f0, f1 = system.prev_frame.stereo, frames[warm].stereo
    match, depth, motion = system.match_estimator, system.depth_estimator, system.tartanvo
    mh, mw, h64, w64 = crop_margins(f1.height, f1.width)
    crop = (slice(None), slice(mh, mh + h64), slice(mw, mw + w64))
    i1, i2, r2 = (normalize_image(x[crop]) for x in (f0.imageL, f1.imageL, f1.imageR))
    stages = {}
    with torch.inference_mode():
        feats = [f.split(1, dim=0) for f in match.net.pyramid(torch.cat([i1, i2]).permute(0, 3, 1, 2).contiguous())]
        pairs = [(feats[lvl][0].contiguous(), feats[lvl][1].contiguous()) for lvl in range(5, 0, -1)]
        stages["matcher_total"] = _timed(lambda: match.estimate(f0, f1), reps)
        stages["pwc_net"] = _timed(lambda: match.net(i1, i2), reps)
        stages["correlation_kernel_5_calls"] = _timed(lambda: [local_correlation(a, b) for a, b in pairs], reps)
        stages["depth_total"] = _timed(lambda: depth.estimate(f1), reps)
        stages["stereo_net"] = _timed(lambda: depth.net(i2, r2), reps)
        flow, dep = match.estimate(f0, f1).flow, depth.estimate(f1).depth
        stack = motion.motion_input(frames[warm], flow, dep)
        stages["pose_input"] = _timed(lambda: motion.motion_input(frames[warm], flow, dep), reps)
        stages["pose_net"] = _timed(lambda: motion.net(stack), reps)
        prev_pose = motion.prev_pose
        stages["motion_predict"] = _timed(lambda: motion.predict(frames[warm], flow, dep), reps)
        motion.prev_pose = prev_pose
    return system, warm, stages


def profile_config(cfg_path: Path, reps: int, profiled: int) -> dict:
    from macvo_tpu_torch.data import DevicePrefetcher
    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
    from macvo_tpu_torch.models.flowformer.encoder import all_pairs_correlation
    from macvo_tpu_torch.models.flowformer.network import _DTYPES, precision_scope
    from macvo_tpu_torch.odometry import MACVO
    from macvo_tpu_torch.ops.latent_attn import latent_attn_folded
    from macvo_tpu_torch.utils.config import load_config

    device = torch.device("cuda")
    cfg = load_config(cfg_path)[0]
    seq = TartanAirV2({"root": str(CLIP), "compressed": True, "gtFlow": False, "gtDepth": False, "gtPose": True})
    frames = list(DevicePrefetcher(seq, device))
    if getattr(cfg.Odometry, "type", "MACVO") == "TartanVO":
        for node, ckpt in ((cfg.Odometry.match, "flow"), (cfg.Odometry.depth, "stereo"),
                           (cfg.Odometry.tartanvo, "posenet")):
            node.args.weight = str(ROOT / "model" / f"TartanVO_{ckpt}.npz")
        system, warm, stages = profile_tartanvo(cfg, frames, reps, profiled)
        return _profile_frames(cfg_path, system, frames, warm, profiled, stages)
    cfg.Odometry.frontend.args.weight = str(ROOT / "model/MACVO_FrontendCov.npz")
    system = MACVO.from_config(cfg, device=device)
    warm = len(frames) - 2 * profiled
    for f in frames[:warm]:
        system.run(f)
    torch.cuda.synchronize()

    # -- per-stage times on the next pair (frame warm-1 -> warm) ------------
    fe = system.Frontend
    model, rcfg = fe.runner.model, fe.runner.cfg
    f0, f1 = system.prev_keyframe[0], frames[warm]
    _, f_l1, c_l1 = fe._feat_cache
    l2, r2 = f1.stereo.imageL, f1.stereo.imageR
    stages = {}
    with torch.inference_mode():
        feats = model.features(torch.cat([l2, r2], 0))
        f_l2, f_r2 = torch.chunk(feats, 2, 0)
        c_l2 = model.context(l2)
        fa, fb, ctx = torch.cat([f_l2, f_l1]), torch.cat([f_r2, f_l2]), torch.cat([c_l2, c_l1])
        enc = lambda: precision_scope(device, rcfg.encoder_dtype)           # noqa: E731
        dec = lambda: precision_scope(device, rcfg.decoder_dtype)           # noqa: E731
        with enc():
            cost_maps = all_pairs_correlation(fa, fb)
            perceiver = model.memory_encoder.perceiver
            tokens = perceiver.tokenize(cost_maps)
            folded = perceiver.fold_m, perceiver.fold_wvp, perceiver.fold_c
            memory = perceiver(cost_maps, ctx)
        stages["features_2_images"] = _timed(lambda: model.features(torch.cat([l2, r2], 0)), reps)
        stages["context_1_image"] = _timed(lambda: model.context(l2), reps)

        def run_enc(fn):
            with enc():
                return fn()

        stages["correlation"] = _timed(lambda: run_enc(lambda: all_pairs_correlation(fa, fb)), reps)
        stages["tokenize"] = _timed(lambda: run_enc(lambda: perceiver.tokenize(cost_maps)), reps)
        stages["latent_attn_kernel"] = _timed(lambda: latent_attn_folded(tokens, *folded), reps)
        stages["perceiver_total"] = _timed(lambda: run_enc(lambda: perceiver(cost_maps, ctx)), reps)

        def run_dec():
            with dec():
                return model.memory_decoder(memory, ctx.float(), cost_maps,
                                            compute_dtype=_DTYPES[rcfg.decoder_dtype])

        stages["decoder_total"] = _timed(run_dec, reps)
        depth1, match01 = fe.estimate_pair(f0.stereo, f1.stereo)
        _, _, depth0 = system.prev_keyframe
        pose = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], device=device)

        def cached_pair():
            fe._feat_cache = (f0.stereo, f_l1, c_l1)      # the steady state: l1 encoded last frame
            return fe.estimate_pair(f0.stereo, f1.stereo)

        stages["frontend_pair_total"] = _timed(cached_pair, reps)
        packed = system.keypoint_pipeline(f0.stereo, f1.stereo, depth0, depth1, match01, pose, pose)
        stages["keypoint_pipeline"] = _timed(lambda: system.keypoint_pipeline(
            f0.stereo, f1.stereo, depth0, depth1, match01, pose, pose), reps)
        stages["mapping_pipeline"] = _timed(lambda: system.mapping_pipeline(
            f0.stereo, depth0, depth1, match01, pose), reps)
        cam, baseline = system._calibration(f1.stereo)
        from macvo_tpu_torch.backend.two_frame_pgo import solve_sync_packed

        stages["solve_sync_packed"] = _timed(lambda: solve_sync_packed(
            packed, pose, cam, baseline, system.Optimizer.context["graph_type"]), reps)
    # the stage timings re-ran estimate_pair: restore the cache the next frame expects
    fe._feat_cache = (f0.stereo, f_l1, c_l1)
    return _profile_frames(cfg_path, system, frames, warm, profiled, stages)


def _profile_frames(cfg_path: Path, system, frames, warm: int, profiled: int, stages: dict) -> dict:
    # -- whole frames: plain for the wall time, then under the profiler -----
    torch.cuda.synchronize()
    walls = []
    for f in frames[warm:warm + profiled]:
        start = time.perf_counter()
        system.run(f)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - start) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for f in frames[warm + profiled:]:
            system.run(f)
        torch.cuda.synchronize()
    system.terminate()
    # Only the device's own events (kernels, copies): the CPU-side ops that launch
    # them report the same time again as their "self device time".
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    return {
        "config": str(cfg_path.relative_to(ROOT)), "device": torch.cuda.get_device_name(0),
        "stage_ms": {k: round(v, 4) for k, v in stages.items()},
        "profiled_frames": profiled, "wall_ms_per_frame": walls,
        "device_ms_per_frame": total_dev_ms / profiled,
        "device_busy_share": total_dev_ms / profiled / statistics.mean(walls),
        "top_kernels": [{"name": e.key[:90], "ms_per_frame": e.self_device_time_total / 1e3 / profiled,
                         "calls_per_frame": e.count / profiled} for e in top],
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="per-stage and per-kernel time of a frame on the card")
    parser.add_argument("--odom", nargs="*", default=[
        "configs/experiment/macvo/MACVO_Performant.yaml", "configs/experiment/macvo/MACVO_Fast.yaml",
        "configs/experiment/baseline/TartanVO.yaml"])
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--profiled", type=int, default=2,
                        help="frames timed plain, then as many under the profiler, at the end of the clip")
    parser.add_argument("--out", type=str, default="chiprun_out")
    parser.add_argument("--tree", type=str, default=None,
                        help="import macvo_tpu_torch from this checkout instead of this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs an NVIDIA card")
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for odom in args.odom:
        rec = profile_config(ROOT / odom, args.reps, args.profiled)
        rec["package"] = str(Path(sys.modules["macvo_tpu_torch"].__file__).parent.relative_to(ROOT))
        (out / f"profile_{Path(odom).stem}.json").write_text(json.dumps(rec, indent=1))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
