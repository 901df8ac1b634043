"""The port's driver entry points (``macvo_tpu_torch/entry.py``) against
``__graft_entry__.py``: the forward function on the JAX entry's own
parameters, and the multi-process dry run on 2 ``gloo`` processes."""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_entry_matches_the_jax_entry_on_its_params():
    """JAX's ``entry()`` parameters (FlowFormerCov, 4 decoder steps, flax init
    from PRNGKey(0)) carried into the port's state_dict layout: the port's
    ``fn`` gives the JAX ``fn``'s flow and normalized covariance on a seeded
    1x64x96 pair within the network parity bound of
    test_torch_port_network.py (1e-4)."""
    import jax

    import __graft_entry__ as graft
    from macvo_tpu.models.flowformer.weights import flatten_params
    from macvo_tpu_torch.entry import entry
    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov, flax_to_torch
    from macvo_tpu_torch.models.flowformer.weights import transposed_convs

    jfn, (jparams, jimg1, jimg2) = graft.entry()
    fn, (state, img1, img2) = entry(device="cpu")
    assert tuple(img1.shape) == tuple(jimg1.shape) == (1, 64, 96, 3)
    carried = flax_to_torch(flatten_params(jparams), transposed_convs(FlowFormerCov(FlowFormerConfig(decoder_depth=4))))
    assert set(carried) == set(state)
    rng = np.random.default_rng(0)
    a = rng.random((1, 64, 96, 3), dtype=np.float32)
    b = np.clip(np.roll(a, 2, axis=2) + 0.01 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    ref_flow, ref_cov = jax.jit(jfn)(jparams, a, b)
    flow, cov = fn(carried, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(flow.numpy(), np.asarray(ref_flow), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(cov.numpy(), np.asarray(ref_cov), atol=1e-4, rtol=1e-4)
    # the example arguments run as they are
    flow0, cov0 = fn(state, img1, img2)
    assert flow0.shape == cov0.shape == (1, 64, 96, 2) and torch.isfinite(cov0).all()


def test_dryrun_multichip_on_two_gloo_processes(capsys):
    """``dryrun_multichip(2)`` on the CPU: one data-parallel cov step (finite
    loss), the observation-sharded solve within 1e-6 of the single solve, and
    BatchedOdometry frames/s for one sequence and for two over two ranks."""
    from macvo_tpu_torch.entry import dryrun_multichip

    rec = dryrun_multichip(2, device="cpu")
    assert rec["ranks"] == 2 and rec["backend"] == "gloo"
    assert np.isfinite(rec["loss"]) and rec["solve_max_abs_diff"] < 1e-6
    assert rec["frames_per_s_1seq"] > 0 and rec["frames_per_s_nseq"] > 0
    assert "dryrun_multichip(2)" in capsys.readouterr().out


def test_dryrun_multichip_fails_on_a_failing_process(monkeypatch):
    """A process that raises fails the dry run (and leaves no process)."""
    from macvo_tpu_torch.parallel.mesh import spawn_group

    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_group(_failing_worker, 2, device="cpu", timeout_s=60)


def test_spawn_group_times_out_a_hang():
    """A process that outlives the limit fails the group in about that time."""
    import time

    from macvo_tpu_torch.parallel.mesh import spawn_group

    start = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn_group(_hanging_worker, 2, device="cpu", timeout_s=15)
    assert time.monotonic() - start < 60


def _failing_worker(rank, size, device):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    return rank


def _hanging_worker(rank, size, device):
    import time

    time.sleep(600)
