"""The attention block's training dropout against flax's.

flax's ``MultiHeadDotProductAttention`` (which ``shm_tpu/models/attention.py``
uses with ``dropout_rate``) has ``broadcast_dropout=True``: one mask of shape
(1, 1, T, T) a call, shared by every window and head. The port's block draws
the same shape; its two residual dropouts stay full-shape, as flax's plain
``nn.Dropout`` layers are. The two frameworks' random streams differ, so
these tests pin the mask's shape and sharing, and the block's output given
the generator's draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from shm_tpu_torch.models.attention import TransformerBlock, flax_layer_norm

torch.set_num_threads(1)

B, T, H, HEADS, DROP = 5, 12, 16, 4, 0.3


def _tied_block(seed: int = 0) -> TransformerBlock:
    """A block whose query, key and value weights repeat one head's rows, so
    that every head computes the same attention weights and values."""
    g = torch.Generator().manual_seed(seed)
    blk = TransformerBlock(H, HEADS, dropout=DROP)
    hd = H // HEADS
    with torch.no_grad():
        for lin in (blk.query, blk.key, blk.value):
            w = torch.randn(hd, H, generator=g) / math.sqrt(H)
            b = torch.randn(hd, generator=g) * 0.1
            lin.weight.copy_(w.repeat(HEADS, 1))
            lin.bias.copy_(b.repeat(HEADS))
    return blk.train()


def _attention_context(blk, x, generator):
    """The block's attention output before ``out`` ([B, T, heads * hd])."""
    seen = []
    hook = blk.out.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    try:
        blk(x, generator)
    finally:
        hook.remove()
    return seen[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attention_weight_mask_is_shared_by_windows_and_heads(seed):
    """Identical windows through head-tied weights: with one (1, 1, T, T)
    mask the context is the same for every window and head. A mask drawn
    per window or per head (the fault) makes them differ."""
    blk = _tied_block(seed)
    x = torch.randn(1, T, H, generator=torch.Generator().manual_seed(10 + seed))
    ctx = _attention_context(blk, x.expand(B, T, H).contiguous(),
                             torch.Generator().manual_seed(seed))
    heads = ctx.view(B, T, HEADS, H // HEADS)
    assert torch.equal(heads, heads[:1, :, :1].expand_as(heads))
    # the dropout did act: the context differs from the eval-mode one
    ctx_eval = _attention_context(blk.eval(), x, None)
    assert not torch.allclose(ctx[:1], ctx_eval, atol=1e-6)


def test_block_output_from_the_generators_draws():
    """The training-mode block equals the block computed by hand from the
    generator's three draws in order: the (1, 1, T, T) attention-weight
    mask, then the [B, T, H] masks after ``out`` and after ``mlp_out``.
    rtol 1e-6: the same float32 operations in the same order."""
    blk = _tied_block(3)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(B, T, H, generator=torch.Generator().manual_seed(8))
    state = g.get_state()
    got = blk(x, g)

    g.set_state(state)
    keep = 1.0 - DROP
    m_w = (torch.rand(1, 1, T, T, generator=g) < keep).float() / keep
    m_1 = (torch.rand(B, T, H, generator=g) < keep).float() / keep
    m_2 = (torch.rand(B, T, H, generator=g) < keep).float() / keep
    hd = H // HEADS
    eps = blk.attn_norm.eps
    h = flax_layer_norm(x, blk.attn_norm.weight, blk.attn_norm.bias, eps)
    split = lambda t: t.view(B, T, HEADS, hd).transpose(1, 2)
    q = split(blk.query(h)) / math.sqrt(hd)
    k, v = split(blk.key(h)), split(blk.value(h))
    w = torch.softmax(q @ k.transpose(-1, -2), dim=-1) * m_w
    y = x + blk.out((w @ v).transpose(1, 2).reshape(B, T, H)) * m_1
    z = flax_layer_norm(y, blk.mlp_norm.weight, blk.mlp_norm.bias, eps)
    want = y + blk.mlp_out(torch.nn.functional.gelu(
        blk.mlp_in(z), approximate="tanh")) * m_2
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_flax_attention_dropout_is_one_broadcast_mask():
    """The reference's side: flax's attention defaults to a broadcast mask,
    and the weights it drops are the same for every window and head."""
    assert fnn.MultiHeadDotProductAttention(num_heads=HEADS).broadcast_dropout
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(1, T, 1, H // HEADS)).astype(np.float32)
    k1 = rng.normal(size=(1, T, 1, H // HEADS)).astype(np.float32)
    q = jnp.asarray(np.broadcast_to(q1, (B, T, HEADS, H // HEADS)))
    k = jnp.asarray(np.broadcast_to(k1, (B, T, HEADS, H // HEADS)))
    w = np.asarray(fnn.dot_product_attention_weights(
        q, k, dropout_rng=jax.random.PRNGKey(0), dropout_rate=DROP,
        deterministic=False))                         # [B, heads, T, T]
    assert w.shape == (B, HEADS, T, T)
    assert (w == w[:1, :1]).all()
    assert (w == 0).any()                             # the mask dropped some


def test_eval_mode_and_zero_rate_draw_nothing():
    blk = _tied_block(4)
    x = torch.randn(B, T, H, generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    blk.eval()(x, g)
    assert torch.equal(g.get_state(), state)
    blk.train().dropout = 0.0
    blk(x, g)
    assert torch.equal(g.get_state(), state)
