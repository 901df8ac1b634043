"""Eval-during-training record of the JAX package, the reference for the
PyTorch port's ``train`` phase in ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python scripts/jax_train_eval_record.py \
        [--config configs/train/FlowFormerCov_synth_cov.yaml] [--weight model/MACVO_FrontendCov.npz]

Runs ``macvo_tpu.train.run.make_eval_fn`` over the ``Eval`` sequence of the
config (``make_eval_pairs`` at the config's crop, ``Eval.max_frames`` frames:
a temporal and a stereo pair each) with the checkpoint in fp32 and prints the
means of epe, px1, px3 and nll over the pairs as one JSON line, as the runner
aggregates them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=str(ROOT / "configs/train/FlowFormerCov_synth_cov.yaml"))
    parser.add_argument("--weight", default=str(ROOT / "model/MACVO_FrontendCov.npz"))
    args = parser.parse_args()

    from macvo_tpu.data import SequenceBase
    from macvo_tpu.data.datasets.train import make_eval_pairs
    from macvo_tpu.models.flowformer import FlowFormerConfig, FlowFormerCov
    from macvo_tpu.models.flowformer.weights import load_params
    from macvo_tpu.train.run import make_eval_fn
    from macvo_tpu.utils.config import load_config

    cfg, _ = load_config(Path(args.config))
    h, w = int(cfg.Train.image_height), int(cfg.Train.image_width)
    pairs = make_eval_pairs(SequenceBase.from_config(cfg.Eval.Sequence), h, w,
                            max_frames=int(getattr(cfg.Eval, "max_frames", 8)))
    model = FlowFormerCov(FlowFormerConfig(decoder_depth=int(cfg.Model.decoder_depth),
                                           encoder_dtype="fp32", decoder_dtype="fp32"))
    probe = jnp.zeros((1, h, w, 3), jnp.float32)
    template = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), probe, probe)["params"])
    params = load_params(args.weight, template)
    fn = make_eval_fn(model, float(cfg.Train.max_flow))
    start = time.perf_counter()
    ms = [jax.device_get(fn(params, b)) for b in pairs]
    rec = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
    print(json.dumps({"config": str(Path(args.config).relative_to(ROOT)), "weight": Path(args.weight).name,
                      "pairs": len(pairs), "crop_hw": [h, w], "decoder_depth": int(cfg.Model.decoder_depth),
                      "dtype": "fp32", "platform": jax.default_backend(), "jax": jax.__version__,
                      "per_pair": [{k: float(v) for k, v in m.items()} for m in ms],
                      "seconds": round(time.perf_counter() - start, 1), **rec}), flush=True)


if __name__ == "__main__":
    main()
