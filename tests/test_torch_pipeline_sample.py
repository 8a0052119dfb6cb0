"""``make_hybrid_fn(sample=True)``: the VAE decodes ``mu + eps * exp(0.5 *
logvar)`` with eps drawn from the ``torch.Generator`` given to the returned
function (the JAX function draws it from its ``key``; the two draw other
numbers from one seed, so the port is held to its own VAE forward on the
same eps). One seed gives one output; another seed another; the fused
kernel is deterministic, so ``sample=True`` with ``use_fused_vae=True``
raises, as in ``shm_tpu/pipeline.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from shm_tpu_torch.data.windows import normalize_windows
from shm_tpu_torch.models.cnn import stack_vae_residual_nhwc
from shm_tpu_torch.pipeline import make_hybrid_fn, run_hybrid_batched
from shm_tpu_torch.tools.workload import load_trained_workload

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workload():
    wl = load_trained_workload(ROOT / "data" / "4dof")
    idx = np.linspace(0, len(wl.W) - 1, 60).astype(int)
    args = (torch.as_tensor(wl.mean), torch.as_tensor(wl.std),
            torch.tensor(wl.threshold, dtype=torch.float32))
    return wl, torch.from_numpy(wl.W[idx]), args


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_one_seed_one_output(workload):
    wl, W, args = workload
    fn = make_hybrid_fn(wl.vae, wl.cnn, sample=True)
    a, b = fn(W, *args, generator=_gen(7)), fn(W, *args, generator=_gen(7))
    c = fn(W, *args, generator=_gen(8))
    for k in a._fields:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert not torch.equal(a.mse, c.mse)
    det = make_hybrid_fn(wl.vae, wl.cnn)(W, *args)
    assert not torch.equal(a.mse, det.mse)


def test_sample_is_the_vae_forward_on_the_same_eps(workload):
    wl, W, (mean, std, thr) = workload
    out = make_hybrid_fn(wl.vae, wl.cnn, sample=True)(W, mean, std, thr,
                                                      generator=_gen(3))
    Z = normalize_windows(W, mean, std)
    eps = torch.randn((len(W), wl.vae.latent_dim), generator=_gen(3))
    with torch.no_grad():
        recon, mu, logvar = wl.vae(Z, sample=True, eps=eps)
        logits = wl.cnn(stack_vae_residual_nhwc(Z, recon))
    mse = ((Z - recon) ** 2).mean(dim=(1, 2))
    assert torch.equal(out.mse, mse)
    assert torch.equal(out.logits, logits)
    assert torch.equal(out.anomalous, mse > thr)
    assert torch.equal(out.y_pred, torch.where(
        mse > thr, logits.argmax(1).to(torch.int32) + 1, 0).to(torch.int32))


def test_batches_draw_from_the_generator_in_turn(workload):
    """``run_hybrid_batched`` passes its generator to every padded batch in
    turn: 60 windows in batches of 32 are the two calls on one generator."""
    wl, W, (mean, std, thr) = workload
    fn = make_hybrid_fn(wl.vae, wl.cnn, sample=True)
    got = run_hybrid_batched(fn, W.numpy(), mean, std, thr, batch_size=32,
                             generator=_gen(5))
    g = _gen(5)
    first = fn(W[:32], mean, std, thr, generator=g).mse
    second = fn(torch.cat([W[32:], torch.zeros(4, *W.shape[1:])]), mean, std,
                thr, generator=g).mse
    assert got["mse"].shape == (len(W),)
    np.testing.assert_array_equal(got["mse"],
                                  torch.cat([first, second[:28]]).numpy())


def test_sample_with_the_fused_kernel_raises(workload):
    wl, _, _ = workload
    with pytest.raises(ValueError, match="deterministic"):
        make_hybrid_fn(wl.vae, wl.cnn, sample=True, use_fused_vae=True)
