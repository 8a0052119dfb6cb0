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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.ops._build import count_launch, load_library, raise_on_error

_HIDDEN = (32, 64, 128)
_D_MAX, _K_MAX = 32, 128
_T_PER_SPLIT = 4        # steps per partial sum of the weight-gradient pass


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _cell(h, c, gates, H):
    i, f, g, o = gates.split(H, dim=0)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm2_scan_reference(xs, dm, w0i, w0h, b0, w1i, w1h, b1) -> torch.Tensor:
    """Plain two-layer scan, same layout: the per-step top-layer outputs
    [T, H, B]."""
    T, _, B = xs.shape
    H = w0h.shape[1]
    h0 = c0 = h1 = c1 = xs.new_zeros(H, B)
    outs = []
    for t in range(T):
        h0, c0 = _cell(h0, c0, w0i @ xs[t] + w0h @ h0 + b0, H)
        h0d = h0 if dm is None else h0 * dm[t]
        h1, c1 = _cell(h1, c1, w1i @ h0d + w1h @ h1 + b1, H)
        outs.append(h1)
    return torch.stack(outs)


def lstm2_dec_head_reference(dec_in, dm, w0i, w0h, b0, w1i, w1h, b1,
                             out_w, out_b, T: int) -> torch.Tensor:
    """Plain version of :func:`lstm2_dec_head`: recon [T, D, B]."""
    H, B = w0h.shape[1], dec_in.shape[1]
    xp = w0i @ dec_in + b0                                    # once
    h0 = c0 = h1 = c1 = dec_in.new_zeros(H, B)
    outs = []
    for t in range(T):
        h0, c0 = _cell(h0, c0, xp + w0h @ h0, H)
        h0d = h0 if dm is None else h0 * dm[t]
        h1, c1 = _cell(h1, c1, w1i @ h0d + w1h @ h1 + b1, H)
        outs.append(out_w @ h1 + out_b)
    return torch.stack(outs)


def lstm2_scan_stash_reference(x, dm, w0i, w0h, b0, w1i, w1h, b1,
                               T: Optional[int] = None):
    """Plain two-layer scan that also returns what the forward kernels keep
    for the backward, in their layouts: (h1s [T,H,B], stash [T,4H,B] of the
    pre-step state (h0, c0, h1, c1), gates [T,2,4H,B] of the activations
    (i, f, g, o) of layer 0 then layer 1, fin [4H,B] the final state).

    ``x`` is xs [T,D,B] (encoder) or, with ``T`` given, dec_in [K,B] fed to
    layer 0 at every step (decoder; projected once)."""
    H, B = w0h.shape[1], x.shape[-1]
    xp = None if T is None else w0i @ x + b0
    T = x.shape[0] if T is None else T
    h0 = c0 = h1 = c1 = x.new_zeros(H, B)
    outs, stash, gates = [], [], []

    def cell(h, c, pre):
        i, f, g, o = pre.split(H, dim=0)
        act = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o))
        c = act[1] * c + act[0] * act[2]
        return act[3] * torch.tanh(c), c, torch.cat(act)

    for t in range(T):
        stash.append(torch.cat([h0, c0, h1, c1]))
        pre0 = w0i @ x[t] + w0h @ h0 + b0 if xp is None else xp + w0h @ h0
        h0, c0, a0 = cell(h0, c0, pre0)
        h0d = h0 if dm is None else h0 * dm[t]
        h1, c1, a1 = cell(h1, c1, w1i @ h0d + w1h @ h1 + b1)
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
                                 d_hlast=None, d_hseq=None):
    """Plain reverse scan of the two-layer stack, the recurrence the backward
    kernels run: from the stash, the gate stash and the final state of
    :func:`lstm2_scan_stash_reference`, the gate gradients (dg0, dg1), each
    [T,4H,B]. The seed of the top layer's dh is ``d_hlast`` [H,B] at the last
    step (encoder) or ``d_hseq`` [T,H,B] at every step (decoder: the output
    head's ``out_w^T d_recon``). Every weight gradient and the input gradient
    are contractions of (dg0, dg1) with the stash and the inputs."""
    T, G, B = stash.shape
    H = G // 4
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
        dh0 = dh0 + (w1i.t() @ dg1) * m
        dh1 = w1h.t() @ dg1
        dg0, dc0 = _cell_bwd(gates[t, 0], dh0, dc0, c0a, c0p)
        dh0 = w0h.t() @ dg0
        dg0s[t], dg1s[t] = dg0, dg1
        c0a, c1a = c0p, c1p
    return torch.stack(dg0s), torch.stack(dg1s)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C entries declared (built at first
    use, never at import)."""
    lib = load_library("lstm_train")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.shm_lstm2_enc_fwd_f32.argtypes = [P] * 7 + [I] * 4 + [P]
    lib.shm_lstm2_enc_bwd_f32.argtypes = [P] * 9 + [I] * 5 + [P]
    lib.shm_lstm2_dec_fwd_f32.argtypes = [P] * 7 + [I] * 5 + [P]
    lib.shm_lstm2_dec_bwd_f32.argtypes = [P] * 9 + [I] * 6 + [P]
    lib.shm_lstm2_fwd_scan_info.argtypes = [I, I, P]
    lib.shm_lstm2_bwd_scan_info.argtypes = [I, I, P]
    for fn in (lib.shm_lstm2_enc_fwd_f32, lib.shm_lstm2_enc_bwd_f32,
               lib.shm_lstm2_dec_fwd_f32, lib.shm_lstm2_dec_bwd_f32,
               lib.shm_lstm2_fwd_scan_info, lib.shm_lstm2_bwd_scan_info):
        fn.restype = ctypes.c_int
    return lib


def _scan_info(entry, what: str, H: int, decoder: bool) -> dict:
    out = (ctypes.c_int * 5)()
    raise_on_error(_library(), entry(H, int(decoder), out), f"lstm2 {what} set-up")
    info = dict(zip(("max_active_clusters", "shared_bytes", "registers",
                     "local_bytes", "threads"), out))
    if info["max_active_clusters"] == 0:
        raise RuntimeError(
            f"the LSTM {what} (H={H}) needs clusters of 8 blocks with "
            f"{info['shared_bytes']} bytes of shared memory each, and this "
            "card places none")
    return info


@functools.cache
def fwd_scan_info(H: int, decoder: bool) -> dict:
    """What the card makes of the forward-scan kernel of one stack at hidden
    size H (set up at its first call): the clusters of 8 blocks that fit at
    once, the shared memory, registers and local (spill) bytes of one block
    or thread, and its threads. Raises where no such cluster fits."""
    return _scan_info(_library().shm_lstm2_fwd_scan_info, "forward scan", H,
                      decoder)


@functools.cache
def bwd_scan_info(H: int, decoder: bool) -> dict:
    """The same for the backward's reverse-scan kernel."""
    return _scan_info(_library().shm_lstm2_bwd_scan_info, "reverse scan", H,
                      decoder)


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
    if H not in _HIDDEN:
        raise ValueError(f"unsupported hidden size for the LSTM training "
                         f"kernels: H={H} (need one of {_HIDDEN})")
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


def enc_forward_cuda(xs, dm, w0i, w0h, b0, w1i, w1h, b1, keep_stash=True):
    """Launch the encoder forward kernel: (h_last [H,B], saved). ``saved`` is
    what :func:`enc_backward_cuda` needs: (xs, dm, w, stash, gates, fin),
    stash and gates None without a stash."""
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
    fwd_scan_info(H, False)
    with torch.cuda.device(dev):
        err = _library().shm_lstm2_enc_fwd_f32(
            xs.data_ptr(), _ptr(dm), _ptrs(w), _ptr(stash), _ptr(gates),
            h_last.data_ptr(), fin.data_ptr(), T, D, H, B, _stream(xs))
    raise_on_error(_library(), err, "lstm2_enc_last forward")
    count_launch(lstm2_enc_last, "fwd_launches")
    return h_last, (xs, dm, w, stash, gates, fin)


def enc_backward_cuda(saved, d_hlast, need_dx=True):
    """Launch the encoder backward kernels: (dx | None, gw0i, gw0h, gb0,
    gw1i, gw1h, gb1)."""
    xs, dm, w, stash, gates, fin = saved
    dev = xs.device
    T, D, B = xs.shape
    H = fin.shape[0] // 4
    stash, gates = _check_stash(stash, gates, dev, T, H, B)
    d_hlast = _f32c("d_hlast", d_hlast, dev, (H, B))
    new = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    S = _splits(T)
    bwd_scan_info(H, False)
    scratch = [new(T, 4 * H, B), new(T, 4 * H, B), new(S, 4 * H, max(H, D))]
    out = [new(T, D, B) if need_dx else None, new(4 * H, D), new(4 * H, H),
           new(4 * H, 1), new(4 * H, H), new(4 * H, H), new(4 * H, 1)]
    with torch.cuda.device(dev):
        err = _library().shm_lstm2_enc_bwd_f32(
            xs.data_ptr(), _ptr(dm), _ptrs(w), stash.data_ptr(),
            gates.data_ptr(), fin.data_ptr(), d_hlast.data_ptr(),
            _ptrs(scratch), _ptrs(out),
            T, D, H, B, S, _stream(xs))
    raise_on_error(_library(), err, "lstm2_enc_last backward")
    count_launch(lstm2_enc_last, "bwd_launches")
    return tuple(out)


def dec_forward_cuda(dec_in, dm, w0i, w0h, b0, w1i, w1h, b1, out_w, out_b,
                     T: int, keep_stash=True):
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
    fwd_scan_info(H, True)
    with torch.cuda.device(dev):
        err = _library().shm_lstm2_dec_fwd_f32(
            dec_in.data_ptr(), _ptr(dm), _ptrs(w), recon.data_ptr(),
            _ptr(stash), _ptr(gates), fin.data_ptr(), T, D, H, K, B,
            _stream(dec_in))
    raise_on_error(_library(), err, "lstm2_dec_head forward")
    count_launch(lstm2_dec_head, "fwd_launches")
    return recon, (dec_in, dm, w, stash, gates, fin, T, D)


def dec_backward_cuda(saved, d_recon):
    """Launch the decoder backward kernels: (d dec_in, gw0i, gw0h, gb0, gw1i,
    gw1h, gb1, g out_w, g out_b)."""
    dec_in, dm, w, stash, gates, fin, T, D = saved
    dev = dec_in.device
    K, B = dec_in.shape
    H = fin.shape[0] // 4
    stash, gates = _check_stash(stash, gates, dev, T, H, B)
    d_recon = _f32c("d_recon", d_recon, dev, (T, D, B))
    new = lambda *s: torch.empty(*s, device=dev, dtype=torch.float32)
    S = _splits(T)
    bwd_scan_info(H, True)
    scratch = [new(T, 4 * H, B), new(T, 4 * H, B),
               new(S, 4 * H, max(H, K, D)), new(4 * H, B)]
    out = [new(K, B), new(4 * H, K), new(4 * H, H), new(4 * H, 1),
           new(4 * H, H), new(4 * H, H), new(4 * H, 1), new(D, H), new(D, 1)]
    with torch.cuda.device(dev):
        err = _library().shm_lstm2_dec_bwd_f32(
            dec_in.data_ptr(), _ptr(dm), _ptrs(w), stash.data_ptr(),
            gates.data_ptr(), fin.data_ptr(), d_recon.data_ptr(), _ptrs(scratch), _ptrs(out),
            T, D, H, K, B, S, _stream(dec_in))
    raise_on_error(_library(), err, "lstm2_dec_head backward")
    count_launch(lstm2_dec_head, "bwd_launches")
    return tuple(out)


class _EncLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, dm, keep, *weights):
        h_last, saved = enc_forward_cuda(xs, dm, *weights, keep_stash=keep)
        ctx.saved = saved
        return h_last

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_hlast):
        if ctx.saved[3] is None:
            raise RuntimeError("lstm2_enc_last: backward without a stash")
        grads = enc_backward_cuda(ctx.saved, d_hlast,
                                  need_dx=ctx.needs_input_grad[0])
        ctx.saved = None
        return (grads[0], None, None) + grads[1:]


class _DecHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dec_in, dm, T, keep, *weights):
        recon, saved = dec_forward_cuda(dec_in, dm, *weights, T=T,
                                        keep_stash=keep)
        ctx.saved = saved
        return recon

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_recon):
        if ctx.saved[3] is None:
            raise RuntimeError("lstm2_dec_head: backward without a stash")
        grads = dec_backward_cuda(ctx.saved, d_recon)
        ctx.saved = None
        return (grads[0], None, None, None) + grads[1:]


def _wants_grad(*tensors) -> bool:
    """Whether a backward can follow (decided outside the Function: autograd
    is switched off inside ``forward``); without one no stash is written."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm2_enc_last(xs, dm, w0i, w0h, b0, w1i, w1h, b1) -> torch.Tensor:
    """Two-layer LSTM over a sequence -> the LAST top-layer state [H, B].

    Differentiable in xs and the six weights; the mask is a constant. A CUDA
    tensor runs the kernels, a CPU tensor the plain version.
    """
    if xs.device.type == "cuda":
        w = (w0i, w0h, b0, w1i, w1h, b1)
        return _EncLast.apply(xs, dm, _wants_grad(xs, *w), *w)
    if xs.device.type == "cpu":
        if dm is not None:
            dm = dm.detach()
        return lstm2_scan_reference(xs, dm, w0i, w0h, b0, w1i, w1h, b1)[-1]
    raise ValueError(f"lstm2_enc_last: unsupported device {xs.device}")


def lstm2_dec_head(dec_in, dm, w0i, w0h, b0, w1i, w1h, b1, out_w, out_b,
                   T: int = 100) -> torch.Tensor:
    """Two-layer LSTM decoder with a constant input and a fused output head
    -> recon [T, D, B]. Differentiable in dec_in, the weights and the head.
    """
    if dec_in.device.type == "cuda":
        w = (w0i, w0h, b0, w1i, w1h, b1, out_w, out_b)
        return _DecHead.apply(dec_in, dm, T, _wants_grad(dec_in, *w), *w)
    if dec_in.device.type == "cpu":
        if dm is not None:
            dm = dm.detach()
        return lstm2_dec_head_reference(dec_in, dm, w0i, w0h, b0, w1i, w1h,
                                        b1, out_w, out_b, T)
    raise ValueError(f"lstm2_dec_head: unsupported device {dec_in.device}")


# kernel launches so far (one per op call and direction); callers reset them
# to 0 to count one run's launches
lstm2_enc_last.fwd_launches = 0
lstm2_enc_last.bwd_launches = 0
lstm2_dec_head.fwd_launches = 0
lstm2_dec_head.bwd_launches = 0


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
                      use_kernel: Optional[bool] = None):
    """Training-mode VAE forward on the two fused scans.

    Z: [B, T, D] normalized windows; eps: [B, Zdim] reparameterisation noise
    (None decodes the posterior mean); dm_enc / dm_dec: [T, H, B] inverted
    dropout masks (None = no dropout). Returns (recon [B, T, D], mu, logvar),
    differentiable in every parameter of ``vae``.

    ``use_kernel``: None or True runs the ops (the CUDA kernels for CUDA
    tensors, their plain versions for CPU tensors); False runs the plain
    versions wherever the tensors are.
    """
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
        h_last = lstm2_enc_last(xs, dm_enc, *enc_w)
    h = h_last.t()                                                # [B, H]
    if vae.layer_norm is not None:
        h = vae.layer_norm(h)
    mu, logvar = vae.fc_mu(h), vae.fc_logvar(h)
    z = mu if eps is None else mu + eps * torch.exp(0.5 * logvar)
    dec_in = torch.tanh(vae.fc_latent_to_hidden(z)).t().contiguous()  # [H, B]
    if plain:
        recon = lstm2_dec_head_reference(dec_in, dm_dec, *dec_w, *head, T)
    else:
        recon = lstm2_dec_head(dec_in, dm_dec, *dec_w, *head, T)
    return recon.permute(2, 0, 1), mu, logvar


__all__ = [
    "lstm2_enc_last", "lstm2_dec_head", "lstm2_scan_reference",
    "lstm2_dec_head_reference", "lstm2_scan_stash_reference",
    "lstm2_reverse_scan_reference", "vae_train_forward", "stack_op_weights",
    "enc_forward_cuda", "enc_backward_cuda", "dec_forward_cuda",
    "dec_backward_cuda", "fwd_scan_info", "bwd_scan_info",
]
