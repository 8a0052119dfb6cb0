"""What the forward kernels keep for the backward, against the JAX package's forward.

``lstm2_scan_stash_reference`` is the plain version the forward kernels are
held to on the card (``chip_smoke.py`` phase 6): the stash of pre-step
states [T,4H,B], the final state [4H,B] and, for the decoder, recon [T,D,B]
through the output head. Here each is held against what the Pallas forward
itself writes (``shm_tpu.ops.lstm_train._enc_fwd_impl`` / ``_dec_fwd_impl``,
in interpret mode, float32, ``batch_tile=16``) on the same numpy-seeded
inputs, at ``tests/test_lstm_train.py``'s shapes, with the dropout mask and
with a unit mask (an array of ones on the JAX side, None on the port's).
Tolerance as in ``tests/test_torch_lstm_train.py``: FWD_ATOL = 2e-6, float32
on both sides, summed in other orders.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.ops.lstm_train import _dec_fwd_impl, _enc_fwd_impl
from shm_tpu_torch.ops import lstm2_scan_stash_reference
from shm_tpu_torch.ops.lstm_train import _stack_weights

torch.set_num_threads(1)

FWD_ATOL = 2e-6
T, DIN, B, H, D_OUT = 12, 6, 32, 8, 5


@functools.cache
def _inputs():
    """The inputs of ``tests/test_lstm_train.py::scan_setup``."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(T, DIN, B)).astype(np.float32)
    dm = ((rng.random((T, H, B)) > 0.3) / 0.7).astype(np.float32)
    w = lambda *shape: (rng.normal(size=shape) * 0.3).astype(np.float32)
    ws = [w(4 * H, DIN), w(4 * H, H), w(4 * H, 1),
          w(4 * H, H), w(4 * H, H), w(4 * H, 1)]
    head = [w(D_OUT, H), w(D_OUT, 1)]
    din = rng.normal(size=(DIN, B)).astype(np.float32)
    return xs, dm, ws, head, din


@functools.cache
def _outputs(stack: str, masked: bool):
    """{output: (port's plain version, JAX forward)} as numpy arrays."""
    xs, dm, ws, head, din = _inputs()
    jdm = dm if masked else np.ones_like(dm)
    t = lambda a: torch.from_numpy(a)
    tw = [t(a) for a in ws]
    dm_port = t(dm) if masked else None
    J = lambda *a: [jnp.asarray(x) for x in a]
    if stack == "encoder":
        h1s, stash, _, fin = lstm2_scan_stash_reference(t(xs), dm_port, *tw)
        h_last, jstash, jfin = _enc_fwd_impl(*J(xs, jdm, *ws), 16, jnp.float32, True)
        port = dict(stash=stash, fin=fin, h_last=h1s[-1])
        jax_ = dict(stash=jstash, fin=jfin, h_last=h_last)
    else:
        h1s, stash, _, fin = lstm2_scan_stash_reference(t(din), dm_port, *tw, T=T)
        recon = t(head[0]) @ h1s + t(head[1])
        jrecon, jstash, jfin = _dec_fwd_impl(*J(din, jdm, *ws, *head), T, 16,
                                             jnp.float32, True)
        port = dict(stash=stash, fin=fin, recon=recon)
        jax_ = dict(stash=jstash, fin=jfin, recon=jrecon)
    return {k: (port[k].numpy(), np.asarray(jax_[k])) for k in port}


CASES = [("encoder", "stash"), ("encoder", "fin"), ("encoder", "h_last"),
         ("decoder", "stash"), ("decoder", "fin"), ("decoder", "recon")]


@pytest.mark.parametrize("masked", [True, False], ids=["dropout_mask", "unit_mask"])
@pytest.mark.parametrize("stack, output", CASES, ids=[f"{s}-{o}" for s, o in CASES])
def test_stash_reference_matches_the_jax_forward(stack, output, masked):
    got, want = _outputs(stack, masked)[output]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0,
                               err_msg=f"{stack} {output}")


@pytest.mark.parametrize("in_dim", [DIN, H], ids=["encoder", "decoder"])
def test_stack_weights_are_the_matrices_as_given(in_dim):
    """The kernels read [4H, in] as given: no transposed copy, no copy at all
    of a contiguous float32 tensor, six entries in the C entries' order."""
    rng = np.random.default_rng(1)
    ws = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for s in [(4 * 32, in_dim), (4 * 32, 32), (4 * 32, 1),
                    (4 * 32, 32), (4 * 32, 32), (4 * 32, 1)]]
    got = _stack_weights(torch.device("cpu"), in_dim, 32, *ws)
    assert len(got) == 6
    for g, w in zip(got, ws):
        assert g.shape == w.shape and g.data_ptr() == w.data_ptr()
        assert g.is_contiguous()
