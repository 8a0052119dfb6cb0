"""Two-layer LSTM training scans with hand-written CUDA forward and backward.

Counterpart of ``shm_tpu/ops/lstm_train.py``, with its public layouts (batch
last) so the two can be compared like with like:

- :func:`lstm2_enc_last`: xs [T, D, B], inverted-dropout mask dm [T, H, B]
  (multiplies layer 0's output before layer 1; constant, no gradient),
  weights [4H, in] with gates i|f|g|o, biases [4H, 1] -> the top layer's
  last hidden state h_last [H, B]. Nothing else of the scan is kept.
- :func:`lstm2_dec_head`: dec_in [K, B], fed to layer 0 at every one of T
  steps (projected once), same mask and weights, output head out_w [D, H],
  out_b [D, 1] folded in -> recon [T, D, B].
- :func:`vae_train_forward`: the training-mode VAE forward built on the two
  ops; LayerNorm, the latent heads, the reparameterisation and
  ``tanh(fc_latent_to_hidden)`` are plain PyTorch under autograd.

On CUDA tensors each op is a ``torch.autograd.Function`` whose forward and
backward launch the kernels of ``csrc/lstm_train.cu`` (built with nvcc for
``sm_90a`` at first use) and count their launches in ``<op>.fwd_launches`` and
``<op>.bwd_launches``; a failed launch raises, and nothing falls back. For a
backward the forward stashes the pre-step state (h0, c0, h1, c1) and the gate
activations of both layers per step; the backward's reverse scan reads them
and recomputes nothing. Both scans run on clusters of 8 blocks that hold the
stack's three [4H, H] matrices in shared memory, each block a slice, and take
the weights as given (a card that cannot place such a cluster raises:
:func:`fwd_scan_info`, :func:`bwd_scan_info`). Under ``torch.no_grad()`` no
stash is written.
On CPU tensors the ops run their plain versions, :func:`lstm2_scan_reference`
and :func:`lstm2_dec_head_reference` (a Python time loop under autograd), which
the tests hold against the JAX package and ``chip_smoke.py`` holds the kernels
against. Computation is float32 with float32 accumulation. ``dm=None`` means
a unit mask.

``dtype`` (the JAX ops' name; float32 here by default, bf16 there) is the type
of every product's two operands: ``torch.bfloat16`` rounds both to bf16
(nearest even) where the JAX kernels' ``_mm`` / ``_mmT`` round them and sums
the exact products in float32; the cell, the carries, the stash, the bias
sums and every other sum stay float32. A CUDA tensor launches the kernels'
bf16 instances (counted in ``bf16_fwd_launches`` / ``bf16_bwd_launches``); a
CPU tensor runs the plain versions at ``dtype`` forward and, for the
backward, the explicit reverse scan and gradient pass
(:func:`enc_backward_reference`, :func:`dec_backward_reference`). Autograd
through a bf16 forward would round the gradient at the casts, which the JAX
kernels' backward does not. Any other type raises ``ValueError``.

The kernels are built for H in {32, 64, 128}. On a CUDA tensor the ops run
any other width H <= 128 at the next one (:func:`enc_last_padded`,
:func:`dec_head_padded`): the weights, the head and the mask are padded with
zero units by differentiable operations outside the ``autograd.Function``
(a padded unit's gates are i = f = o = 1/2, g = 0, so its c and h stay 0),
and the output sliced back, so autograd slices the gradients back too and
an optimizer never sees a padded weight. Inputs wider than ``D <= 32`` (the
encoder's) or ``K <= 128`` (the decoder's) and H > 128 raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.ops._build import count_launch, load_library, raise_on_error
from shm_tpu_torch.ops._gate import (
    INSTANCE_WIDTHS, bf16_round, instance_width, pad_units,
)

_H_MAX, _D_MAX, _K_MAX = 128, 32, 128
_T_PER_SPLIT = 4        # steps per partial sum of the weight-gradient pass


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _is_bf16(dtype) -> bool:
    """Whether ``dtype`` asks for bf16 products; float32 and bfloat16 are
    the two types the ops take, anything else raises ``ValueError``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the LSTM training ops compute with float32 or "
                         f"bfloat16 products, not {dtype}")
    return dtype == torch.bfloat16


def _rounding(dtype):
    """The rounding of a product's operands at ``dtype``: none for float32,
    to bf16 (kept in float32) for bfloat16."""
    return bf16_round if _is_bf16(dtype) else (lambda t: t)


def _cell(h, c, gates, H):
    i, f, g, o = gates.split(H, dim=0)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm2_scan_reference(xs, dm, w0i, w0h, b0, w1i, w1h, b1,
                         dtype=torch.float32) -> torch.Tensor:
    """Plain two-layer scan, same layout: the per-step top-layer outputs
    [T, H, B]. At bfloat16 the forward of the ops' bf16 mode (autograd
    through it is not their backward)."""
    r = _rounding(dtype)
    T, _, B = xs.shape
    H = w0h.shape[1]
    w0i, w0h, w1i, w1h = map(r, (w0i, w0h, w1i, w1h))
    h0 = c0 = h1 = c1 = xs.new_zeros(H, B)
    outs = []
    for t in range(T):
        h0, c0 = _cell(h0, c0, w0i @ r(xs[t]) + w0h @ r(h0) + b0, H)
        h0d = h0 if dm is None else h0 * dm[t]
        h1, c1 = _cell(h1, c1, w1i @ r(h0d) + w1h @ r(h1) + b1, H)
        outs.append(h1)
    return torch.stack(outs)


def lstm2_dec_head_reference(dec_in, dm, w0i, w0h, b0, w1i, w1h, b1,
                             out_w, out_b, T: int,
                             dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`lstm2_dec_head`: recon [T, D, B]."""
    r = _rounding(dtype)
    H, B = w0h.shape[1], dec_in.shape[1]
    w0h, w1i, w1h, out_w = map(r, (w0h, w1i, w1h, out_w))
    xp = r(w0i) @ r(dec_in) + b0                              # once
    h0 = c0 = h1 = c1 = dec_in.new_zeros(H, B)
    outs = []
    for t in range(T):
        h0, c0 = _cell(h0, c0, xp + w0h @ r(h0), H)
        h0d = h0 if dm is None else h0 * dm[t]
        h1, c1 = _cell(h1, c1, w1i @ r(h0d) + w1h @ r(h1) + b1, H)
        outs.append(out_w @ r(h1) + out_b)
    return torch.stack(outs)


def lstm2_scan_stash_reference(x, dm, w0i, w0h, b0, w1i, w1h, b1,
                               T: Optional[int] = None, dtype=torch.float32):
    """Plain two-layer scan that also returns what the forward kernels keep
    for the backward, in their layouts: (h1s [T,H,B], stash [T,4H,B] of the
    pre-step state (h0, c0, h1, c1), gates [T,2,4H,B] of the activations
    (i, f, g, o) of layer 0 then layer 1, fin [4H,B] the final state).

    ``x`` is xs [T,D,B] (encoder) or, with ``T`` given, dec_in [K,B] fed to
    layer 0 at every step (decoder; projected once)."""
    r = _rounding(dtype)
    H, B = w0h.shape[1], x.shape[-1]
    xp = None if T is None else r(w0i) @ r(x) + b0
    T = x.shape[0] if T is None else T
    w0i, w0h, w1i, w1h = map(r, (w0i, w0h, w1i, w1h))
    h0 = c0 = h1 = c1 = x.new_zeros(H, B)
    outs, stash, gates = [], [], []

    def cell(h, c, pre):
        i, f, g, o = pre.split(H, dim=0)
        act = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o))
        c = act[1] * c + act[0] * act[2]
        return act[3] * torch.tanh(c), c, torch.cat(act)

    for t in range(T):
        stash.append(torch.cat([h0, c0, h1, c1]))
        pre0 = (w0i @ r(x[t]) + w0h @ r(h0) + b0 if xp is None
                else xp + w0h @ r(h0))
        h0, c0, a0 = cell(h0, c0, pre0)
        h0d = h0 if dm is None else h0 * dm[t]
        h1, c1, a1 = cell(h1, c1, w1i @ r(h0d) + w1h @ r(h1) + b1)
        gates.append(torch.stack([a0, a1]))
        outs.append(h1)
    return (torch.stack(outs), torch.stack(stash), torch.stack(gates),
            torch.cat([h0, c0, h1, c1]))


def _cell_bwd(act, dh, dc, c_aft, c_prev):
    """Gate gradients [4H,B] of one cell from its activations act [4H,B];
    returns (dg, the cell-state gradient carried to the step before)."""
    i, f, g, o = act.chunk(4, dim=0)
    tc = torch.tanh(c_aft)
    d_c = dc + dh * o * (1.0 - tc * tc)
    dg = torch.cat([(d_c * g) * i * (1.0 - i), (d_c * c_prev) * f * (1.0 - f),
                    (d_c * i) * (1.0 - g * g), (dh * tc) * o * (1.0 - o)])
    return dg, d_c * f


def lstm2_reverse_scan_reference(stash, gates, fin, dm, w0h, w1i, w1h,
                                 d_hlast=None, d_hseq=None,
                                 dtype=torch.float32):
    """Plain reverse scan of the two-layer stack, the recurrence the backward
    kernels run: from the stash, the gate stash and the final state of
    :func:`lstm2_scan_stash_reference`, the gate gradients (dg0, dg1), each
    [T,4H,B]. The seed of the top layer's dh is ``d_hlast`` [H,B] at the last
    step (encoder) or ``d_hseq`` [T,H,B] at every step (decoder: the output
    head's ``out_w^T d_recon``). Every weight gradient and the input gradient
    are contractions of (dg0, dg1) with the stash and the inputs. At
    bfloat16 each ``W^T dg`` rounds both operands; the dg returned are the
    float32 values."""
    r = _rounding(dtype)
    T, G, B = stash.shape
    H = G // 4
    w0hT, w1iT, w1hT = r(w0h).t(), r(w1i).t(), r(w1h).t()
    dh0 = dc0 = dc1 = dh1 = stash.new_zeros(H, B)
    c0a, c1a = fin[H:2 * H], fin[3 * H:]
    if d_hlast is not None:
        dh1 = d_hlast
    dg0s, dg1s = [None] * T, [None] * T
    for t in reversed(range(T)):
        if d_hseq is not None:
            dh1 = dh1 + d_hseq[t]
        c0p, c1p = stash[t, H:2 * H], stash[t, 3 * H:]
        dg1, dc1 = _cell_bwd(gates[t, 1], dh1, dc1, c1a, c1p)
        m = 1.0 if dm is None else dm[t]
        dh0 = dh0 + (w1iT @ r(dg1)) * m
        dh1 = w1hT @ r(dg1)
        dg0, dc0 = _cell_bwd(gates[t, 0], dh0, dc0, c0a, c0p)
        dh0 = w0hT @ r(dg0)
        dg0s[t], dg1s[t] = dg0, dg1
        c0a, c1a = c0p, c1p
    return torch.stack(dg0s), torch.stack(dg1s)


def _after(stash, fin, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of the state AFTER each step [T, hi-lo, B]: the next
    step's stash entry, the final state after the last."""
    return torch.cat([stash[1:, lo:hi], fin[None, lo:hi]])


def _contract(r, a, b) -> torch.Tensor:
    """sum over t and b of r(a)[t,i,b] * r(b)[t,j,b] -> [i, j]."""
    return torch.einsum("tib,tjb->ij", r(a), r(b))


def enc_backward_reference(saved, d_hlast, need_dx=True, dtype=torch.float32):
    """Plain version of :func:`enc_backward_cuda` on what a forward keeps
    (:func:`lstm2_scan_stash_reference`'s stash, gate stash and final state
    in ``saved``): the reverse scan, then the gradient pass, rounding at
    ``dtype`` where the JAX kernel ``_enc_bwd_kernel`` rounds (the bias sums
    take the float32 dg). (dx | None, gw0i, gw0h, gb0, gw1i, gw1h, gb1)."""
    xs, dm, (w0i, w0h, _, w1i, w1h, _), stash, gates, fin = saved
    r = _rounding(dtype)
    H = w0h.shape[1]
    dg0, dg1 = lstm2_reverse_scan_reference(stash, gates, fin, dm, w0h, w1i,
                                            w1h, d_hlast=d_hlast, dtype=dtype)
    h0d = _after(stash, fin, 0, H)
    if dm is not None:
        h0d = h0d * dm
    dx = torch.einsum("gd,tgb->tdb", r(w0i), r(dg0)) if need_dx else None
    return (dx, _contract(r, dg0, xs), _contract(r, dg0, stash[:, :H]),
            dg0.sum((0, 2))[:, None], _contract(r, dg1, h0d),
            _contract(r, dg1, stash[:, 2 * H:3 * H]), dg1.sum((0, 2))[:, None])


def dec_backward_reference(saved, d_recon, dtype=torch.float32):
    """Plain version of :func:`dec_backward_cuda`, as
    :func:`enc_backward_reference`: layer 0's input is constant over T, so
    its gate gradients are summed over T in float32 first and that sum is
    rounded once for the two products it enters. (d dec_in, gw0i, gw0h, gb0,
    gw1i, gw1h, gb1, g out_w, g out_b)."""
    dec_in, dm, w, stash, gates, fin, T, _ = saved
    w0i, w0h, _, w1i, w1h, _, out_w, _ = w
    r = _rounding(dtype)
    H = w0h.shape[1]
    d_hseq = torch.einsum("dh,tdb->thb", r(out_w), r(d_recon))
    dg0, dg1 = lstm2_reverse_scan_reference(stash, gates, fin, dm, w0h, w1i,
                                            w1h, d_hseq=d_hseq, dtype=dtype)
    adg0 = dg0.sum(0)                                         # [4H, B]
    h0d = _after(stash, fin, 0, H)
    if dm is not None:
        h0d = h0d * dm
    return (r(w0i).t() @ r(adg0), r(adg0) @ r(dec_in).t(),
            _contract(r, dg0, stash[:, :H]), adg0.sum(1, keepdim=True),
            _contract(r, dg1, h0d), _contract(r, dg1, stash[:, 2 * H:3 * H]),
            dg1.sum((0, 2))[:, None],
            _contract(r, d_recon, _after(stash, fin, 2 * H, 3 * H)),
            d_recon.sum((0, 2))[:, None])


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C entries declared (built at first
    use, never at import)."""
    lib = load_library("lstm_train")
    P, I = ctypes.c_void_p, ctypes.c_int
    for t in ("f32", "bf16"):
        getattr(lib, f"shm_lstm2_enc_fwd_{t}").argtypes = [P] * 7 + [I] * 4 + [P]
        getattr(lib, f"shm_lstm2_enc_bwd_{t}").argtypes = [P] * 9 + [I] * 5 + [P]
        getattr(lib, f"shm_lstm2_dec_fwd_{t}").argtypes = [P] * 7 + [I] * 5 + [P]
        getattr(lib, f"shm_lstm2_dec_bwd_{t}").argtypes = [P] * 9 + [I] * 6 + [P]
    lib.shm_lstm2_fwd_scan_info.argtypes = [I, I, I, P]
    lib.shm_lstm2_bwd_scan_info.argtypes = [I, I, I, P]
    for t in ("f32", "bf16"):
        for op in ("enc_fwd", "enc_bwd", "dec_fwd", "dec_bwd"):
            getattr(lib, f"shm_lstm2_{op}_{t}").restype = ctypes.c_int
    lib.shm_lstm2_fwd_scan_info.restype = ctypes.c_int
    lib.shm_lstm2_bwd_scan_info.restype = ctypes.c_int
    return lib


def _entry(op: str, dtype):
    """The C entry of ``op`` (enc_fwd, enc_bwd, dec_fwd, dec_bwd) at
    ``dtype``: its float32 or its bf16 instance."""
    return getattr(_library(), f"shm_lstm2_{op}_{'bf16' if _is_bf16(dtype) else 'f32'}")


def _count(op, direction: str, dtype) -> None:
    count_launch(op, f"{'bf16_' if _is_bf16(dtype) else ''}{direction}_launches")


def _scan_info(entry, what: str, H: int, decoder: bool, bf16: bool) -> dict:
    out = (ctypes.c_int * 5)()
    raise_on_error(_library(), entry(H, int(decoder), int(bf16), out),
                   f"lstm2 {what} set-up")
    info = dict(zip(("max_active_clusters", "shared_bytes", "registers",
                     "local_bytes", "threads"), out))
    if info["max_active_clusters"] == 0:
        raise RuntimeError(
            f"the LSTM {what} (H={H}) needs clusters of 8 blocks with "
            f"{info['shared_bytes']} bytes of shared memory each, and this "
            "card places none")
    return info


@functools.cache
def fwd_scan_info(H: int, decoder: bool, bf16: bool = False) -> dict:
    """What the card makes of the forward-scan kernel of one stack at hidden
    size H, its float32 or its bf16 instance (set up at its first call): the
    clusters of 8 blocks that fit at once, the shared memory, registers and
    local (spill) bytes of one block or thread, and its threads. Raises
    where no such cluster fits."""
    return _scan_info(_library().shm_lstm2_fwd_scan_info, "forward scan", H,
                      decoder, bf16)


@functools.cache
def bwd_scan_info(H: int, decoder: bool, bf16: bool = False) -> dict:
    """The same for the backward's reverse-scan kernel."""
    return _scan_info(_library().shm_lstm2_bwd_scan_info, "reverse scan", H,
                      decoder, bf16)


def _ptrs(tensors: Sequence[Optional[torch.Tensor]]):
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _f32c(name: str, t: torch.Tensor, device, shape=None) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got {t.dtype} "
                         f"on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.detach().contiguous()


def _stack_weights(dev, in_dim, H, w0i, w0h, b0, w1i, w1h, b1):
    """Checked kernel weight list (w0i, w0h, b0, w1i, w1h, b1): the tensors
    as given, [4H, in] and [4H, 1], no copy of a contiguous one."""
    if H not in INSTANCE_WIDTHS:
        raise ValueError(f"unsupported hidden size for the LSTM training "
                         f"kernels: H={H} (<= {_H_MAX}; the ops pad it to one "
                         f"of {INSTANCE_WIDTHS})")
    w0i = _f32c("w0i", w0i, dev, (4 * H, in_dim))
    w0h = _f32c("w0h", w0h, dev, (4 * H, H))
    w1i = _f32c("w1i", w1i, dev, (4 * H, H))
    w1h = _f32c("w1h", w1h, dev, (4 * H, H))
    b0 = _f32c("b0", b0, dev, (4 * H, 1))
    b1 = _f32c("b1", b1, dev, (4 * H, 1))
    return [w0i, w0h, b0, w1i, w1h, b1]


def _check_mask(dm, dev, T, H, B):
    return None if dm is None else _f32c("dm", dm, dev, (T, H, B))


def _new_stash(keep: bool, T: int, H: int, B: int, dev):
    """(stash [T,4H,B], gates [T,2,4H,B]) for a forward that keeps them for a
    backward, else (None, None)."""
    if not keep:
        return None, None
    return (torch.empty(T, 4 * H, B, device=dev, dtype=torch.float32),
            torch.empty(T, 2, 4 * H, B, device=dev, dtype=torch.float32))


def _check_stash(stash, gates, dev, T, H, B):
    return (_f32c("stash", stash, dev, (T, 4 * H, B)),
            _f32c("gates", gates, dev, (T, 2, 4 * H, B)))


def _splits(T: int) -> int:
    return -(-T // _T_PER_SPLIT)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def enc_forward_cuda(xs, dm, w0i, w0h, b0, w1i, w1h, b1, keep_stash=True,
                     dtype=torch.float32):
    """Launch the encoder forward kernel (its instance at ``dtype``):
    (h_last [H,B], saved). ``saved`` is what :func:`enc_backward_cuda` needs:
    (xs, dm, w, stash, gates, fin), stash and gates None without a stash."""
    dev = xs.device
    T, D, B = xs.shape
    H = w0h.shape[1]
    if D > _D_MAX:
        raise ValueError(f"encoder input width {D} > {_D_MAX}")
    xs = _f32c("xs", xs, dev)
    dm = _check_mask(dm, dev, T, H, B)
    w = _stack_weights(dev, D, H, w0i, w0h, b0, w1i, w1h, b1)
    h_last = torch.empty(H, B, device=dev, dtype=torch.float32)
    fin = torch.empty(4 * H, B, device=dev, dtype=torch.float32)
    stash, gates = _new_stash(keep_stash, T, H, B, dev)
    fwd_scan_info(H, False, _is_bf16(dtype))
    with torch.cuda.device(dev):
        err = _entry("enc_fwd", dtype)(
            xs.data_ptr(), _ptr(dm), _ptrs(w), _ptr(stash), _ptr(gates),
            h_last.data_ptr(), fin.data_ptr(), T, D, H, B, _stream(xs))
    raise_on_error(_library(), err, "lstm2_enc_last forward")
    _count(lstm2_enc_last, "fwd", dtype)
    return h_last, (xs, dm, w, stash, gates, fin)


def enc_backward_cuda(saved, d_hlast, need_dx=True, dtype=torch.float32):
    """Launch the encoder backward kernels (their instances at ``dtype``,
    the forward's): (dx | None, gw0i, gw0h, gb0, gw1i, gw1h, gb1)."""
    xs, dm, w, stash, gates, fin = saved
    dev = xs.device
    T, D, B = xs.shape
    H = fin.shape[0] // 4
    stash, gates = _check_stash(stash, gates, dev, T, H, B)
    d_hlast = _f32c("d_hlast", d_hlast, dev, (H, B))
    new = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    S = _splits(T)
    bwd_scan_info(H, False, _is_bf16(dtype))
    scratch = [new(T, 4 * H, B), new(T, 4 * H, B), new(S, 4 * H, max(H, D))]
    out = [new(T, D, B) if need_dx else None, new(4 * H, D), new(4 * H, H),
           new(4 * H, 1), new(4 * H, H), new(4 * H, H), new(4 * H, 1)]
    with torch.cuda.device(dev):
        err = _entry("enc_bwd", dtype)(
            xs.data_ptr(), _ptr(dm), _ptrs(w), stash.data_ptr(),
            gates.data_ptr(), fin.data_ptr(), d_hlast.data_ptr(),
            _ptrs(scratch), _ptrs(out),
            T, D, H, B, S, _stream(xs))
    raise_on_error(_library(), err, "lstm2_enc_last backward")
    _count(lstm2_enc_last, "bwd", dtype)
    return tuple(out)


def dec_forward_cuda(dec_in, dm, w0i, w0h, b0, w1i, w1h, b1, out_w, out_b,
                     T: int, keep_stash=True, dtype=torch.float32):
    """Launch the decoder forward kernel: (recon [T,D,B], saved), ``saved``
    as in :func:`enc_forward_cuda` with T and D added."""
    dev = dec_in.device
    K, B = dec_in.shape
    H = w0h.shape[1]
    D = out_w.shape[0]
    if D > _D_MAX or K > _K_MAX:
        raise ValueError(f"decoder head width {D} > {_D_MAX} or input width "
                         f"{K} > {_K_MAX}")
    dec_in = _f32c("dec_in", dec_in, dev)
    dm = _check_mask(dm, dev, T, H, B)
    w = _stack_weights(dev, K, H, w0i, w0h, b0, w1i, w1h, b1)
    w += [_f32c("out_w", out_w, dev, (D, H)), _f32c("out_b", out_b, dev, (D, 1))]
    recon = torch.empty(T, D, B, device=dev, dtype=torch.float32)
    fin = torch.empty(4 * H, B, device=dev, dtype=torch.float32)
    stash, gates = _new_stash(keep_stash, T, H, B, dev)
    fwd_scan_info(H, True, _is_bf16(dtype))
    with torch.cuda.device(dev):
        err = _entry("dec_fwd", dtype)(
            dec_in.data_ptr(), _ptr(dm), _ptrs(w), recon.data_ptr(),
            _ptr(stash), _ptr(gates), fin.data_ptr(), T, D, H, K, B,
            _stream(dec_in))
    raise_on_error(_library(), err, "lstm2_dec_head forward")
    _count(lstm2_dec_head, "fwd", dtype)
    return recon, (dec_in, dm, w, stash, gates, fin, T, D)


def dec_backward_cuda(saved, d_recon, dtype=torch.float32):
    """Launch the decoder backward kernels (their instances at ``dtype``):
    (d dec_in, gw0i, gw0h, gb0, gw1i, gw1h, gb1, g out_w, g out_b)."""
    dec_in, dm, w, stash, gates, fin, T, D = saved
    dev = dec_in.device
    K, B = dec_in.shape
    H = fin.shape[0] // 4
    stash, gates = _check_stash(stash, gates, dev, T, H, B)
    d_recon = _f32c("d_recon", d_recon, dev, (T, D, B))
    new = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    S = _splits(T)
    bwd_scan_info(H, True, _is_bf16(dtype))
    scratch = [new(T, 4 * H, B), new(T, 4 * H, B),
               new(S, 4 * H, max(H, K, D)), new(4 * H, B)]
    out = [new(K, B), new(4 * H, K), new(4 * H, H), new(4 * H, 1),
           new(4 * H, H), new(4 * H, H), new(4 * H, 1), new(D, H), new(D, 1)]
    with torch.cuda.device(dev):
        err = _entry("dec_bwd", dtype)(
            dec_in.data_ptr(), _ptr(dm), _ptrs(w), stash.data_ptr(),
            gates.data_ptr(), fin.data_ptr(), d_recon.data_ptr(), _ptrs(scratch), _ptrs(out),
            T, D, H, K, B, S, _stream(dec_in))
    raise_on_error(_library(), err, "lstm2_dec_head backward")
    _count(lstm2_dec_head, "bwd", dtype)
    return tuple(out)


def enc_forward_reference(xs, dm, w0i, w0h, b0, w1i, w1h, b1, keep_stash=True,
                       dtype=torch.float32):
    """Plain version of :func:`enc_forward_cuda` (what a CPU tensor runs at
    bf16): (h_last, saved), ``saved`` as the kernel's, from
    :func:`lstm2_scan_stash_reference` at ``dtype``."""
    h1s, stash, gates, fin = lstm2_scan_stash_reference(
        xs, dm, w0i, w0h, b0, w1i, w1h, b1, dtype=dtype)
    if not keep_stash:
        stash = gates = None
    return h1s[-1], (xs, dm, (w0i, w0h, b0, w1i, w1h, b1), stash, gates, fin)


def dec_forward_reference(dec_in, dm, w0i, w0h, b0, w1i, w1h, b1, out_w, out_b,
                       T: int, keep_stash=True, dtype=torch.float32):
    """Plain version of :func:`dec_forward_cuda`: (recon, saved), the head's
    operands rounded at ``dtype`` as the kernel rounds them."""
    w = (w0i, w0h, b0, w1i, w1h, b1, out_w, out_b)
    h1s, stash, gates, fin = lstm2_scan_stash_reference(
        dec_in, dm, *w[:6], T=T, dtype=dtype)
    r = _rounding(dtype)
    recon = torch.einsum("dh,thb->tdb", r(out_w), r(h1s)) + out_b
    if not keep_stash:
        stash = gates = None
    return recon, (dec_in, dm, w, stash, gates, fin, T, out_w.shape[0])


class _EncLast(torch.autograd.Function):
    """The encoder op: the kernels on a CUDA tensor, the plain forward and
    backward on a CPU one (the bf16 mode's)."""

    @staticmethod
    def forward(ctx, xs, dm, keep, dtype, *weights):
        fwd = enc_forward_cuda if xs.device.type == "cuda" else enc_forward_reference
        h_last, saved = fwd(xs, dm, *weights, keep_stash=keep, dtype=dtype)
        ctx.saved, ctx.dtype = saved, dtype
        return h_last

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_hlast):
        if ctx.saved[3] is None:
            raise RuntimeError("lstm2_enc_last: backward without a stash")
        bwd = (enc_backward_cuda if d_hlast.device.type == "cuda"
               else enc_backward_reference)
        grads = bwd(ctx.saved, d_hlast, need_dx=ctx.needs_input_grad[0],
                    dtype=ctx.dtype)
        ctx.saved = None
        return (grads[0], None, None, None) + grads[1:]


class _DecHead(torch.autograd.Function):
    """The decoder op, as :class:`_EncLast`."""

    @staticmethod
    def forward(ctx, dec_in, dm, T, keep, dtype, *weights):
        fwd = (dec_forward_cuda if dec_in.device.type == "cuda"
               else dec_forward_reference)
        recon, saved = fwd(dec_in, dm, *weights, T=T, keep_stash=keep,
                           dtype=dtype)
        ctx.saved, ctx.dtype = saved, dtype
        return recon

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_recon):
        if ctx.saved[3] is None:
            raise RuntimeError("lstm2_dec_head: backward without a stash")
        bwd = (dec_backward_cuda if d_recon.device.type == "cuda"
               else dec_backward_reference)
        grads = bwd(ctx.saved, d_recon, dtype=ctx.dtype)
        ctx.saved = None
        return (grads[0], None, None, None, None) + grads[1:]


def pad_hidden(H: int, Hp: int, dm, w0i, w0h, b0, w1i, w1h, b1, *head):
    """``(dm, w0i, w0h, b0, w1i, w1h, b1, *head)`` of a stack of width H
    widened to Hp by zero units (``_gate.pad_units``, differentiable): each
    gate's rows of the weights and biases, the columns over H of ``w0h``,
    ``w1i``, ``w1h`` and of the head's ``out_w`` [D, H], and the mask's units
    (``dm`` None stays None). ``w0i``'s input columns (D, or the decoder's
    K) and ``out_b`` are kept."""
    gates = lambda t: pad_units(t, H, Hp, dim=0, groups=4)
    units = lambda t: pad_units(t, H, Hp, dim=1)
    dm = None if dm is None else units(dm)
    ws = (gates(w0i), units(gates(w0h)), gates(b0), units(gates(w1i)),
          units(gates(w1h)), gates(b1))
    head = (units(head[0]), head[1]) if head else ()
    return (dm,) + ws + head


def enc_last_padded(xs, dm, w0i, w0h, b0, w1i, w1h, b1,
                    dtype=torch.float32) -> torch.Tensor:
    """The encoder op's ``autograd.Function`` at the kernel instance's width
    ``Hp = instance_width(H)`` on the inputs padded by :func:`pad_hidden`,
    its h_last sliced back to [H, B]: what :func:`lstm2_enc_last` runs on a
    CUDA tensor; on a CPU tensor it runs the plain forward and backward at
    that width."""
    H = w0h.shape[1]
    Hp = instance_width(H)
    dm, *w = pad_hidden(H, Hp, dm, w0i, w0h, b0, w1i, w1h, b1)
    h = _EncLast.apply(xs, dm, _wants_grad(xs, *w), dtype, *w)
    return h if Hp == H else h[:H]


def dec_head_padded(dec_in, dm, w0i, w0h, b0, w1i, w1h, b1, out_w, out_b,
                    T: int, dtype=torch.float32) -> torch.Tensor:
    """The decoder op's ``autograd.Function`` at the kernel instance's
    width, as :func:`enc_last_padded`: recon [T, D, B] (no unit of it is
    padded)."""
    H = w0h.shape[1]
    Hp = instance_width(H)
    dm, *w = pad_hidden(H, Hp, dm, w0i, w0h, b0, w1i, w1h, b1, out_w, out_b)
    return _DecHead.apply(dec_in, dm, T, _wants_grad(dec_in, *w), dtype, *w)


def _wants_grad(*tensors) -> bool:
    """Whether a backward can follow (decided outside the Function: autograd
    is switched off inside ``forward``); without one no stash is written."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm2_enc_last(xs, dm, w0i, w0h, b0, w1i, w1h, b1,
                   dtype=torch.float32) -> torch.Tensor:
    """Two-layer LSTM over a sequence -> the LAST top-layer state [H, B].

    Differentiable in xs and the six weights; the mask is a constant. A CUDA
    tensor runs the kernels (their bf16 instances at ``dtype=bfloat16``; a
    width H that is no kernel instance's padded to the next,
    :func:`enc_last_padded`), a CPU tensor the plain version.
    """
    w = (w0i, w0h, b0, w1i, w1h, b1)
    if xs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"lstm2_enc_last: unsupported device {xs.device}")
    if xs.device.type == "cuda":
        return enc_last_padded(xs, dm, *w, dtype=dtype)
    if _is_bf16(dtype):
        return _EncLast.apply(xs, dm, _wants_grad(xs, *w), dtype, *w)
    return lstm2_scan_reference(xs, None if dm is None else dm.detach(), *w)[-1]


def lstm2_dec_head(dec_in, dm, w0i, w0h, b0, w1i, w1h, b1, out_w, out_b,
                   T: int = 100, dtype=torch.float32) -> torch.Tensor:
    """Two-layer LSTM decoder with a constant input and a fused output head
    -> recon [T, D, B]. Differentiable in dec_in, the weights and the head;
    ``dtype`` as in :func:`lstm2_enc_last`.
    """
    w = (w0i, w0h, b0, w1i, w1h, b1, out_w, out_b)
    if dec_in.device.type not in ("cuda", "cpu"):
        raise ValueError(f"lstm2_dec_head: unsupported device {dec_in.device}")
    if dec_in.device.type == "cuda":
        return dec_head_padded(dec_in, dm, *w, T=T, dtype=dtype)
    if _is_bf16(dtype):
        return _DecHead.apply(dec_in, dm, T, _wants_grad(dec_in, *w), dtype, *w)
    return lstm2_dec_head_reference(dec_in, None if dm is None else dm.detach(),
                                    *w, T)


# kernel launches so far (one per op call and direction, by instance);
# callers reset them to 0 to count one run's launches
for _op in (lstm2_enc_last, lstm2_dec_head):
    _op.fwd_launches = _op.bwd_launches = 0
    _op.bf16_fwd_launches = _op.bf16_bwd_launches = 0


# ---------------------------------------------------------------------------
# the VAE's training forward
# ---------------------------------------------------------------------------

def stack_op_weights(stack) -> Tuple[torch.Tensor, ...]:
    """(w0i, w0h, b0, w1i, w1h, b1) of a 2-layer :class:`LSTMStack` in the
    ops' layout, under autograd: each bias is ``bias_ih + bias_hh`` as a
    [4H, 1] column, so both parameters receive the same gradient."""
    out = []
    for layer in stack.layers:
        out += [layer.weight_ih, layer.weight_hh,
                (layer.bias_ih + layer.bias_hh)[:, None]]
    return tuple(out)


def vae_train_forward(vae: TemporalVAE, Z: torch.Tensor,
                      eps: Optional[torch.Tensor],
                      dm_enc: Optional[torch.Tensor],
                      dm_dec: Optional[torch.Tensor], *,
                      use_kernel: Optional[bool] = None,
                      dtype=torch.float32):
    """Training-mode VAE forward on the two fused scans.

    Z: [B, T, D] normalized windows; eps: [B, Zdim] reparameterisation noise
    (None decodes the posterior mean); dm_enc / dm_dec: [T, H, B] inverted
    dropout masks (None = no dropout). Returns (recon [B, T, D], mu, logvar),
    differentiable in every parameter of ``vae``.

    ``use_kernel``: None or True runs the ops (the CUDA kernels for CUDA
    tensors, their plain versions for CPU tensors); False runs the plain
    versions wherever the tensors are.

    ``dtype``: the ops' product type (float32 or bfloat16, as the JAX
    function's ``dtype``); the LayerNorm, the latent heads, the
    reparameterisation and ``z2h`` stay float32. The plain path
    (``use_kernel=False``) is float32 whatever ``dtype`` says, as the JAX
    function's ``use_pallas=False``.
    """
    _is_bf16(dtype)
    if vae.num_layers != 2:
        raise ValueError("vae_train_forward requires a 2-layer LSTM preset")
    B, T, _ = Z.shape
    xs = Z.permute(1, 2, 0).to(torch.float32).contiguous()        # [T, D, B]
    enc_w = stack_op_weights(vae.encoder_lstm)
    dec_w = stack_op_weights(vae.decoder_lstm)
    head = (vae.output_layer.weight, vae.output_layer.bias[:, None])
    plain = use_kernel is False

    if plain:
        h_last = lstm2_scan_reference(xs, dm_enc, *enc_w)[-1]
    else:
        h_last = lstm2_enc_last(xs, dm_enc, *enc_w, dtype=dtype)
    h = h_last.t()                                                # [B, H]
    if vae.layer_norm is not None:
        h = vae.layer_norm(h)
    mu, logvar = vae.fc_mu(h), vae.fc_logvar(h)
    z = mu if eps is None else mu + eps * torch.exp(0.5 * logvar)
    dec_in = torch.tanh(vae.fc_latent_to_hidden(z)).t().contiguous()  # [H, B]
    if plain:
        recon = lstm2_dec_head_reference(dec_in, dm_dec, *dec_w, *head, T)
    else:
        recon = lstm2_dec_head(dec_in, dm_dec, *dec_w, *head, T, dtype=dtype)
    return recon.permute(2, 0, 1), mu, logvar


__all__ = [
    "lstm2_enc_last", "lstm2_dec_head", "lstm2_scan_reference",
    "lstm2_dec_head_reference", "lstm2_scan_stash_reference",
    "lstm2_reverse_scan_reference", "vae_train_forward", "stack_op_weights",
    "enc_forward_cuda", "enc_backward_cuda", "dec_forward_cuda",
    "dec_backward_cuda", "fwd_scan_info", "bwd_scan_info",
    "enc_forward_reference", "dec_forward_reference",
    "enc_backward_reference", "dec_backward_reference",
    "pad_hidden", "enc_last_padded", "dec_head_padded",
]
