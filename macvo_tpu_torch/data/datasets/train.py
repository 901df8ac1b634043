"""Multi-sequence training dataset: pair sampling over a dataset mixture
(port of ``macvo_tpu/data/datasets/train.py``).

Batches are assembled on the host as numpy, with fixed (H, W) crops, by a
one-deep prefetch thread (assembly overlaps the device step), and shipped
compressed: uint8 images and float16 flow. :func:`upcast_batch` moves a batch
to the device through pinned memory and restores float32 there. The same
configs and seed give the same batches as the JAX package, bit for bit.
"""

from __future__ import annotations

import concurrent.futures as futures
from types import SimpleNamespace
from typing import Iterator, Sequence

import numpy as np
import torch

from ...utils.logging import Logger
from ..sequence import SequenceBase
from ..transform import IDataTransform


def _quantize_img(a) -> np.ndarray:
    """float [0,1] image -> uint8 for a cheap host->device copy (the sources
    are 8-bit, so this is lossless up to the additive train noise)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.dtype == np.uint8:
        return a
    return np.clip(a * 255.0, 0.0, 255.0).round().astype(np.uint8)


def _host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def upcast_batch(batch: dict, device: torch.device | str) -> dict[str, torch.Tensor]:
    """Move a batch of host arrays (or tensors) to ``device`` — to a card
    through pinned memory, without blocking — then restore it there: uint8
    images -> float32 in [0,1], any other flow dtype -> float32. float32
    inputs pass through, so uncompressed batches work too."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if t.device.type == "cpu" and device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        if k in ("img1", "img2") and t.dtype == torch.uint8:
            t = t.float() / 255.0
        elif k == "gt_flow" and t.dtype != torch.float32:
            t = t.float()
        out[k] = t
    return out


def _to_ns_list(cfgs) -> list:
    return [SimpleNamespace(**c) if isinstance(c, dict) else c for c in cfgs]


class TrainPairDataset:
    """Mixture of sequences yielding consecutive-frame training pairs.

    ``configs``: list of ``{type, args}`` sequence specs, instantiated
    concurrently (threads: instantiation is I/O-bound directory scanning).
    ``transforms``: list of ``{type, args}`` transform specs applied to every
    frame at sample time. With probability ``stereo_prob`` a drawn sample is
    the stereo pair (imageL, imageR) with gt_flow = (-disparity, 0) from
    gt_depth: the same network serves the temporal-flow and the disparity
    pass of the VO frontend.
    """

    def __init__(self, configs: Sequence, transforms: Sequence | None = None,
                 stereo_prob: float = 0.0) -> None:
        self.stereo_prob = float(stereo_prob)
        configs = _to_ns_list(configs)
        with futures.ThreadPoolExecutor(max_workers=max(1, len(configs))) as ex:
            self.sequences: list[SequenceBase] = list(
                ex.map(lambda c: SequenceBase.instantiate(c.type, c.args), configs))
        self.transforms: list[IDataTransform] = [
            IDataTransform.instantiate(t.type, t.args) for t in _to_ns_list(transforms or [])]
        # Global pair index: (sequence_id, local_frame) for every consecutive pair.
        self._pairs = [(si, fi) for si, seq in enumerate(self.sequences) for fi in range(len(seq) - 1)]
        if not self._pairs:
            raise ValueError("TrainPairDataset: no frame pairs in any sequence")
        Logger.info(f"TrainPairDataset: {len(self.sequences)} sequences, {len(self._pairs)} pairs")

    def __len__(self) -> int:
        return len(self._pairs)

    def get_pair(self, index: int):
        si, fi = self._pairs[index]
        seq = self.sequences[si]
        f0, f1 = seq[fi], seq[fi + 1]
        for t in self.transforms:
            f0, f1 = t(f0), t(f1)
        return f0, f1

    def draw(self, batch_size: int, height: int, width: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
        """One batch of ``batch_size`` pairs drawn uniformly with ``rng``, in
        the calling thread (:meth:`batches` draws them ahead on its own)."""
        return self.assemble(rng.integers(0, len(self._pairs), size=batch_size), height, width, rng)

    def assemble(self, idx: np.ndarray, height: int, width: int,
                 rng: np.random.Generator) -> dict[str, np.ndarray]:
        """The batch of the pairs ``idx``: each a stereo sample with probability
        ``stereo_prob``, randomly cropped to (height, width) with ``rng``."""
        img1, img2, gt_flow, mask = [], [], [], []
        for i in idx:
            f0, f1 = self.get_pair(int(i))
            s = f0.stereo
            stereo = self.stereo_prob > 0 and rng.random() < self.stereo_prob and s.gt_depth is not None
            if not stereo and s.gt_flow is None:
                raise ValueError("training needs gt_flow")
            # Random crop (train-time augmentation).
            h0 = rng.integers(0, max(1, s.height - height))
            w0 = rng.integers(0, max(1, s.width - width))
            sl = (slice(None), slice(h0, h0 + height), slice(w0, w0 + width))
            img1.append(_host(s.imageL)[sl])
            if stereo:
                # The right camera sits at +baseline along +u: a point at depth d
                # moves u -> u - fx*b/d.
                img2.append(_host(s.imageR)[sl])
                disp = float(s.fx) * float(s.frame_baseline) / np.maximum(_host(s.gt_depth)[sl], 1e-6)
                gt_flow.append(np.concatenate([-disp, np.zeros_like(disp)], -1))
                mask.append(np.isfinite(disp))
            else:
                img2.append(_host(f1.stereo.imageL)[sl])
                gt_flow.append(_host(s.gt_flow)[sl])
                mask.append(np.ones(gt_flow[-1].shape[:-1] + (1,), bool)
                            if s.flow_mask is None else _host(s.flow_mask)[sl])
        # Clip to an f16-safe magnitude before the cast: a near-zero depth gives
        # a disparity beyond f16's max. 1e4 is 25x the loss's max_flow cutoff,
        # so every clipped pixel is already outside the loss.
        batch = {
            "img1": _quantize_img(np.concatenate(img1, 0)),
            "img2": _quantize_img(np.concatenate(img2, 0)),
            "gt_flow": np.clip(np.concatenate(gt_flow, 0), -1e4, 1e4).astype(np.float16),
        }
        if mask:
            batch["flow_mask"] = np.concatenate(mask, 0)
        return batch

    def batches(self, batch_size: int, height: int, width: int,
                seed: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """Infinite uniform-over-pairs batch stream with a one-deep threaded
        prefetch (host assembly overlaps the device step)."""
        rng = np.random.default_rng(seed)
        pool = futures.ThreadPoolExecutor(max_workers=1)
        pending = pool.submit(self.draw, batch_size, height, width, rng)
        try:
            while True:
                batch = pending.result()
                pending = pool.submit(self.draw, batch_size, height, width, rng)
                yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def make_eval_pairs(seq: SequenceBase, height: int, width: int,
                    max_frames: int = 8) -> list[dict[str, np.ndarray]]:
    """Deterministic center-cropped pairs from a held-out sequence for
    eval-during-training: the temporal pair of each frame and, where the
    frame has depth, its stereo pair with disparity ground truth."""
    out = []
    n = min(max_frames, len(seq) - 1)
    for i in range(n):
        f0, f1 = seq[i], seq[i + 1]
        s = f0.stereo
        if s.gt_flow is None:
            continue
        h0 = max(0, (s.height - height) // 2)
        w0 = max(0, (s.width - width) // 2)
        sl = (slice(None), slice(h0, h0 + height), slice(w0, w0 + width))
        d = {
            "img1": _quantize_img(_host(s.imageL)[sl]),
            "img2": _quantize_img(_host(f1.stereo.imageL)[sl]),
            "gt_flow": _host(s.gt_flow)[sl].astype(np.float32),
        }
        if s.flow_mask is not None:
            d["flow_mask"] = _host(s.flow_mask)[sl]
        out.append(d)
        if s.gt_depth is not None:
            disp = float(s.fx) * float(s.frame_baseline) / np.maximum(_host(s.gt_depth)[sl], 1e-6)
            out.append({
                "img1": d["img1"],
                "img2": _quantize_img(_host(s.imageR)[sl]),
                "gt_flow": np.concatenate([-disp, np.zeros_like(disp)], -1).astype(np.float32),
                "flow_mask": np.isfinite(disp),
            })
    return out
