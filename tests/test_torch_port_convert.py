"""The port's ``.pth`` converter (``macvo_tpu_torch/models/flowformer/
torch_convert.py``) against the JAX package's, on a seeded state_dict of the
reference's covariance branch (``tests/test_torch_convert.py``'s torch
modules, with the DataParallel ``module.`` prefix): the same npz key for key
and array for array, the same checkpoint after a merge, and the port's
covariance branch on the merged checkpoint equal to the JAX branch's."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from macvo_tpu_torch.models.flowformer import torch_convert

ROOT = Path(__file__).parent.parent
CKPT = ROOT / "model/MACVO_FrontendCov.npz"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(path of a .pth holding {"state_dict": ...}, the torch block it came from)."""
    from tests.test_torch_convert import TorchCovUpdateBlock

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        block = TorchCovUpdateBlock().eval()
    state = {f"module.memory_decoder.cov_update.{k}": v for k, v in block.state_dict().items()}
    path = tmp_path_factory.mktemp("pth") / "FlowFormerCov.pth"
    torch.save({"state_dict": state}, path)
    return path, block


@pytest.fixture(scope="module")
def checkpoint():
    with np.load(CKPT) as data:
        return {k: data[k] for k in data.files}


def test_strip_ddp_prefix_and_layouts_match_jax():
    from macvo_tpu.models.flowformer import torch_convert as jconvert

    rng = np.random.default_rng(0)
    state = {"module.a.weight": torch.from_numpy(rng.standard_normal((8, 3, 3, 5)).astype(np.float32)),
             "module.a.bias": torch.from_numpy(rng.standard_normal(8).astype(np.float32)),
             "b.weight": torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))}
    ours, ref = torch_convert.strip_ddp_prefix(state), jconvert.strip_ddp_prefix(state)
    assert list(ours) == list(ref) == ["a.weight", "a.bias", "b.weight"]
    for fn in ("convert_conv", "convert_linear"):
        name = "a" if fn == "convert_conv" else "b"
        got, want = getattr(torch_convert, fn)(ours, name), getattr(jconvert, fn)(ref, name)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_cov_branch_npz_matches_jax(reference, tmp_path):
    from macvo_tpu.models.flowformer import torch_convert as jconvert

    pth, _ = reference
    ours = torch_convert.convert_cov_branch_pth(pth, tmp_path / "port.npz")
    ref = jconvert.convert_cov_branch_pth(pth, tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(ours) == sorted(ref)
        assert len(a.files) == 2 * (6 + 4 + 2)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _jax_params(flat):
    import jax
    import jax.numpy as jnp

    from macvo_tpu.models.flowformer import FlowFormerConfig, FlowFormerCov
    from macvo_tpu.models.flowformer.weights import unflatten_params

    model = FlowFormerCov(FlowFormerConfig(decoder_depth=2))
    probe = jnp.zeros((1, 64, 64, 3), jnp.float32)
    template = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), probe, probe)["params"])
    return unflatten_params(template, flat)


@pytest.fixture(scope="module")
def merged(reference, checkpoint):
    """The shipped checkpoint with the converted branch merged in: (port's flat
    dict, JAX's params tree)."""
    from macvo_tpu.models.flowformer import torch_convert as jconvert

    state = torch_convert.load_torch_checkpoint(reference[0])
    ours = torch_convert.merge_into_params(checkpoint, torch_convert.convert_cov_branch_tree(state))
    ref = jconvert.merge_into_params(_jax_params(checkpoint), jconvert.convert_cov_branch_tree(state))
    return ours, ref


def test_merge_into_the_checkpoint_matches_jax(merged, checkpoint):
    """The merged flat checkpoint equals JAX's merged tree, flattened, key for
    key and value for value (each in the checkpoint's dtype); only the 24
    branch arrays changed; bad paths and shapes raise."""
    from macvo_tpu.models.flowformer.weights import flatten_params

    ours, ref = merged
    ref = flatten_params(ref)
    assert sorted(ours) == sorted(ref) == sorted(checkpoint)
    changed = [k for k in ours if not np.array_equal(ours[k], checkpoint[k])]
    assert len(changed) == 24 and all("cov_gru" in k or "cov_head" in k or "cov_mask" in k for k in changed)
    for key in ours:
        assert ours[key].dtype == checkpoint[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    with pytest.raises(KeyError):
        torch_convert.merge_into_params(checkpoint, {"memory_decoder": {"nope": {"kernel": np.zeros(1)}}})
    with pytest.raises(ValueError):
        torch_convert.merge_into_params(checkpoint, {"memory_decoder/cov_mask/conv2/bias": np.zeros(3)})


def test_cov_branch_on_the_merged_checkpoint_matches_jax(merged, reference):
    """The merged checkpoint through the port's loader: its SepConvGRU,
    CovHead and mask head equal the JAX blocks on the merged params and the
    reference's own torch block, within the cov-head bound of
    tests/test_torch_convert.py (2e-5)."""
    import jax.numpy as jnp

    from macvo_tpu.models.flowformer.decoder import CovHead, MaskHead, SepConvGRU
    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov, flax_to_torch
    from macvo_tpu_torch.models.flowformer.weights import load_state, transposed_convs

    ours, ref = merged
    model = FlowFormerCov(FlowFormerConfig(decoder_depth=2)).eval()
    load_state(model, flax_to_torch(ours, transposed_convs(model)))
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 8, 12, 128)).astype(np.float32)
    x = rng.standard_normal((2, 8, 12, 384)).astype(np.float32)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    def nhwc(t):
        return t.detach().numpy().transpose(0, 2, 3, 1)

    dec = ref["memory_decoder"]
    with torch.no_grad():
        net = model.memory_decoder.iteration.cov_gru(nchw(h), nchw(x))
        dcov = model.memory_decoder.iteration.cov_head(net)
        mask = 0.25 * model.memory_decoder.cov_mask(net)
        net_t, dcov_t, mask_t = reference[1](nchw(h), nchw(x))
    net_j = SepConvGRU(128).apply({"params": dec["iteration"]["cov_gru"]}, jnp.asarray(h), jnp.asarray(x))
    dcov_j = CovHead().apply({"params": dec["iteration"]["cov_head"]}, net_j)
    mask_j = 0.25 * MaskHead().apply({"params": dec["cov_mask"]}, net_j)
    for got, jax_out, torch_out, what in ((net, net_j, net_t, "gru"), (dcov, dcov_j, dcov_t, "cov head"),
                                          (mask, mask_j, mask_t, "mask head")):
        np.testing.assert_allclose(nhwc(got), np.asarray(jax_out), atol=2e-5, err_msg=what)
        np.testing.assert_allclose(nhwc(got), nhwc(torch_out), atol=2e-5, err_msg=what)
