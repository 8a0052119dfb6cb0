"""The whole deterministic attention-VAE gate as one hand-written CUDA kernel.

Counterpart of ``shm_tpu/ops/fused_attention.py``: ``fused_attention_gate``
maps normalized windows Z [N, T, D] to the per-window reconstruction MSE [N]
and, with ``with_residual``, the squared residual [N, T, D], with z = mu, for
a ``TemporalVAE(cell="attention")``.

- On a CUDA tensor it launches ``csrc/fused_attention.cu`` (built with nvcc
  for ``sm_90a`` at first use) and adds one to
  ``fused_attention_gate.launches``; a failed launch raises. There is no
  fallback.
- On a CPU tensor it runs :func:`fused_attention_gate_reference`, the plain
  PyTorch version of the same arithmetic, which the tests hold against the
  JAX kernel and ``chip_smoke.py`` holds the CUDA kernel against.

The kernel computes its four weight products (QKV, output projection, the
MLP's two) on the tensor cores in 3xTF32. It reads those weights as TF32
fragments that :func:`attention_params_to_kernel_weights` packs once
(:func:`tf32x3_fragments`); the plain version reads them as given.

The kernel keeps one window's whole pass in a block's shared memory, so the
window length it takes depends on the width: :func:`shared_memory_bytes` adds
the buffers up from (T, H) and the wrapper raises ``ValueError``, before any
launch, for a shape that does not fit. The kernel source states its bound on
the card and what its design does about it. Computation is float32 with
float32 accumulation; softmax runs over exactly the T keys; the MSE divides
by the real ``T * D``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from shm_tpu_torch.models.attention import (
    HEAD_DIM, STACK_LN_EPS, flax_layer_norm, sinusoidal_positions,
)
from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.ops._build import count_launch, load_library, raise_on_error
from shm_tpu_torch.ops._gate import (  # noqa: F401  (the TF32 helpers re-exported)
    check_fragments, check_weights, check_windows, dispatch_gate, f32,
    pointer_array, tf32_round, tf32x3_fragments, unpack_fragments,
)

_H_MAX, _D_MAX, _Z_MAX, _L_MAX = 128, 128, 32, 2
_MODEL_LN_EPS = 1e-5         # the model-level norm on the pooled summary
# the kernel's tiling (csrc/fused_attention.cu): rows padded to _TM, q/k/v
# rows to HEAD_DIM + 4, _QC query rows a score chunk, _SMALL scratch floats,
# _MLP_CHUNK columns of the MLP's hidden layer at once
_TM, _QC, _SMALL = 8, 32, 512
_MLP_CHUNK = 128             # divides 4H for every H the kernel takes
SMEM_LIMIT = 232_448         # bytes of shared memory one block may use (H100)

_PRODUCTS = ("wqkv", "wo", "w1", "w2")      # the kernel's tensor-core products
_BLOCK_KEYS = (("ln1_s", "ln1_b", "wqkv", "bqkv", "wo", "bo", "ln2_s", "ln2_b",
                "w1", "b1", "w2", "b2") + tuple(f"{k}_frag" for k in _PRODUCTS))


def _stack_order(p: str):
    return ([f"{p}_in_w", f"{p}_in_b"]
            + [f"{p}{l}_{k}" for l in range(_L_MAX) for k in _BLOCK_KEYS]
            + [f"{p}_fn_s", f"{p}_fn_b"])


# pointer order of the C entry (csrc/fused_attention.cu:
# shm_fused_attention_gate_f32)
_WEIGHT_ORDER = tuple(
    _stack_order("enc")
    + ["ln_scale", "ln_bias", "mu_w", "mu_b", "z2h_w", "z2h_b"]
    + _stack_order("dec") + ["out_w", "out_b"])


def attention_params_to_kernel_weights(vae: TemporalVAE) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict from a ``cell="attention"``
    :class:`TemporalVAE`, on its device. Matmul weights are [in, out], biases
    and norm scales 1-D, every tensor contiguous float32. ``*_wqkv`` [H, 3H]
    and ``*_bqkv`` [3H] are packed per head (columns ``h*96 .. h*96+95`` hold
    q | k | v of head h), with the query's ``1/sqrt(head_dim)`` folded into
    its weight AND its bias: the model scales the biased projection, so the
    folding is exact. Each of the four products' weights (``*_wqkv``,
    ``*_wo``, ``*_w1``, ``*_w2``) also comes as ``*_frag``, its
    :func:`tf32x3_fragments`, which is what the kernel reads."""
    if vae.cell != "attention":
        raise ValueError(f"expected a cell='attention' VAE, got {vae.cell!r}")
    w = {}
    for stack, p in ((vae.encoder_lstm, "enc"), (vae.decoder_lstm, "dec")):
        H, heads = stack.hidden_dim, stack.num_heads
        hd = H // heads
        if hd != HEAD_DIM:
            raise ValueError(f"the fused attention kernel assumes heads of "
                             f"{HEAD_DIM} columns (got {heads} heads at H={H})")
        w[f"{p}_in_w"] = f32(stack.in_proj.weight.t())
        w[f"{p}_in_b"] = f32(stack.in_proj.bias)
        for l, blk in enumerate(stack.layers):
            scale = 1.0 / hd ** 0.5
            parts = [(blk.query, scale), (blk.key, 1.0), (blk.value, 1.0)]
            # [H, heads, 3, hd]: a head's q | k | v columns side by side
            w[f"{p}{l}_wqkv"] = f32(torch.stack(
                [(m.weight.t() * s).reshape(H, heads, hd) for m, s in parts],
                dim=2).reshape(H, 3 * H))
            w[f"{p}{l}_bqkv"] = f32(torch.stack(
                [(m.bias * s).reshape(heads, hd) for m, s in parts],
                dim=1).reshape(3 * H))
            w[f"{p}{l}_wo"] = f32(blk.out.weight.t())
            w[f"{p}{l}_bo"] = f32(blk.out.bias)
            for k, norm in (("ln1", blk.attn_norm), ("ln2", blk.mlp_norm)):
                w[f"{p}{l}_{k}_s"] = f32(norm.weight)
                w[f"{p}{l}_{k}_b"] = f32(norm.bias)
            w[f"{p}{l}_w1"] = f32(blk.mlp_in.weight.t())
            w[f"{p}{l}_b1"] = f32(blk.mlp_in.bias)
            w[f"{p}{l}_w2"] = f32(blk.mlp_out.weight.t())
            w[f"{p}{l}_b2"] = f32(blk.mlp_out.bias)
            for k in _PRODUCTS:
                w[f"{p}{l}_{k}_frag"] = tf32x3_fragments(w[f"{p}{l}_{k}"])
        w[f"{p}_fn_s"] = f32(stack.final_norm.weight)
        w[f"{p}_fn_b"] = f32(stack.final_norm.bias)
    if vae.layer_norm is not None:
        w["ln_scale"] = f32(vae.layer_norm.weight)
        w["ln_bias"] = f32(vae.layer_norm.bias)
    for name, fc in (("mu", vae.fc_mu), ("z2h", vae.fc_latent_to_hidden),
                     ("out", vae.output_layer)):
        w[f"{name}_w"] = f32(fc.weight.t())
        w[f"{name}_b"] = f32(fc.bias)
    return w


def fused_attention_gate_reference(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: (mse [N], resid [N, T, D] | None)."""
    N, T, D = Z.shape
    H = weights["mu_w"].shape[0]
    heads = H // HEAD_DIM
    Z = Z.to(torch.float32)
    pos = sinusoidal_positions(T, H, Z.device)
    w = weights

    def block(s, p):
        nrm = flax_layer_norm(s, w[f"{p}_ln1_s"], w[f"{p}_ln1_b"], STACK_LN_EPS)
        qkv = (nrm @ w[f"{p}_wqkv"] + w[f"{p}_bqkv"]).view(N, T, heads, 3, HEAD_DIM)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))  # [N,h,T,hd]
        prob = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        o = (prob @ v).transpose(1, 2).reshape(N, T, H)
        s = s + (o @ w[f"{p}_wo"] + w[f"{p}_bo"])
        nrm = flax_layer_norm(s, w[f"{p}_ln2_s"], w[f"{p}_ln2_b"], STACK_LN_EPS)
        h1 = F.gelu(nrm @ w[f"{p}_w1"] + w[f"{p}_b1"], approximate="tanh")
        return s + (h1 @ w[f"{p}_w2"] + w[f"{p}_b2"])

    def stack(tok, p):
        s = tok + pos
        for l in range(num_layers):
            s = block(s, f"{p}{l}")
        return flax_layer_norm(s, w[f"{p}_fn_s"], w[f"{p}_fn_b"], STACK_LN_EPS)

    pooled = stack(Z @ w["enc_in_w"] + w["enc_in_b"], "enc").mean(dim=1)
    if use_layernorm:
        pooled = flax_layer_norm(pooled, w["ln_scale"], w["ln_bias"],
                                 _MODEL_LN_EPS)
    mu = pooled @ w["mu_w"] + w["mu_b"]
    h0 = torch.tanh(mu @ w["z2h_w"] + w["z2h_b"])
    tok0 = h0 @ w["dec_in_w"] + w["dec_in_b"]                   # [N, H], once
    out = stack(tok0[:, None, :], "dec")
    resid = (Z - (out @ w["out_w"] + w["out_b"])) ** 2
    mse = resid.sum(dim=(1, 2)) / (T * D)
    return mse, (resid if with_residual else None)


def shared_memory_bytes(T: int, H: int) -> int:
    """Shared memory one window needs in its block (the layout is the
    kernel's own, ``shm_fused_attention_smem_bytes`` in the source): the
    stream and its normalised copy [rows, H+4] each, scratch vectors, and
    one area that holds a head's q | k | v [rows, 36] each plus a [32, T]
    score chunk, or a column chunk of the MLP's hidden layer. Raises
    ``ValueError`` when they pass the card's limit: at H=128 a window may
    have up to 136 steps, at H=64 up to 208, at H=32 up to 268."""
    rows = -(-T // _TM) * _TM
    attn = 3 * rows * (HEAD_DIM + 4) + _QC * (-(-T // 4) * 4)
    nbytes = 4 * (2 * rows * (H + 4) + _SMALL
                  + max(attn, rows * (_MLP_CHUNK + 4)))
    if nbytes > SMEM_LIMIT:
        raise ValueError(
            f"unsupported shape for the fused attention kernel: one window of "
            f"T={T} at H={H} needs more than the {SMEM_LIMIT} bytes of shared "
            f"memory a block can use")
    return nbytes


def _check(weights, Z, num_layers, use_layernorm):
    check_windows(Z)
    if num_layers not in (1, 2):
        raise ValueError("the fused attention kernel supports 1- or 2-layer "
                         "presets")
    H, Zd = weights["mu_w"].shape
    T, D = Z.shape[1:]
    if H % HEAD_DIM or H > _H_MAX or D > _D_MAX or Zd > _Z_MAX:
        raise ValueError(f"unsupported shape for the fused attention kernel: "
                         f"H={H} (a multiple of {HEAD_DIM} up to {_H_MAX}), "
                         f"D={D} (<= {_D_MAX}), Z={Zd} (<= {_Z_MAX})")
    if weights["enc_in_w"].shape != (D, H):
        raise ValueError(f"enc_in_w {tuple(weights['enc_in_w'].shape)} does "
                         f"not match D={D}, H={H}")
    if weights["enc0_wqkv"].shape != (H, 3 * H) \
            or weights["enc0_w1"].shape != (H, 4 * H):
        raise ValueError("the fused attention kernel assumes heads of "
                         f"{HEAD_DIM} columns and an MLP of width 4H")
    shared_memory_bytes(T, H)
    need = [k for k in _WEIGHT_ORDER
            if not (k[3:4].isdigit() and int(k[3]) >= num_layers)
            and (use_layernorm or not k.startswith("ln_"))]
    check_weights(weights, need, Z.device)
    check_fragments(weights, need)
    return need, H, Zd


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C entry declared (built at first
    use, never at import)."""
    lib = load_library("fused_attention")
    fn = lib.shm_fused_attention_gate_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    lib.shm_fused_attention_smem_bytes.restype = ctypes.c_longlong
    lib.shm_fused_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.shm_fused_attention_info.restype = ctypes.c_int
    lib.shm_fused_attention_info.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.shm_tf32_round.restype = ctypes.c_int
    lib.shm_tf32_round.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    return lib


def kernel_info(T: int, H: int) -> dict:
    """How the card takes the kernel for a window of T steps at width H:
    registers and local-memory (spill) bytes a thread, threads and dynamic
    shared bytes a block, blocks an SM at once."""
    shared_memory_bytes(T, H)
    lib = _library()
    out = (ctypes.c_int * 5)()
    raise_on_error(lib, lib.shm_fused_attention_info(T, H, out),
                   "fused_attention_gate info")
    return dict(zip(("registers", "spill_bytes", "threads", "shared_bytes",
                     "blocks_per_sm"), out))


def tf32_round_on_card(x: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """``x`` (contiguous float32, on the card) rounded to TF32 on the card:
    by ``cvt.rna.tf32.f32`` (``exact``), which :func:`tf32_round` must equal
    bit for bit, or by the integer rounding the kernel splits its
    activations with (``exact=False``), which must equal it too."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 CUDA tensor")
    out = torch.empty_like(x)
    if x.numel():
        lib = _library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.shm_tf32_round(x.data_ptr(), out.data_ptr(), x.numel(),
                                     int(exact), stream)
        raise_on_error(lib, err, "tf32_round")
    return out


@functools.lru_cache(maxsize=16)
def _positions(T: int, H: int, device: torch.device) -> torch.Tensor:
    return sinusoidal_positions(T, H, device).contiguous()


def _launch(weights, Z, num_layers, use_layernorm, with_residual):
    need, H, Zd = _check(weights, Z, num_layers, use_layernorm)
    N, T, D = Z.shape
    mse = torch.empty(N, device=Z.device, dtype=torch.float32)
    resid = torch.empty_like(Z) if with_residual else None
    if N == 0:
        return mse, resid
    lib = _library()
    ptrs = pointer_array(weights, _WEIGHT_ORDER, need)
    pos = _positions(T, H, Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = lib.shm_fused_attention_gate_f32(
            Z.data_ptr(), pos.data_ptr(),
            resid.data_ptr() if with_residual else None, mse.data_ptr(), ptrs,
            len(_WEIGHT_ORDER), N, T, D, H, Zd, num_layers,
            int(use_layernorm), int(with_residual), stream)
    raise_on_error(lib, err, "fused_attention_gate")
    count_launch(fused_attention_gate)
    return mse, resid


def fused_attention_gate(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused deterministic attention-VAE pass: (mse [N], resid [N, T, D] | None).

    ``weights`` comes from :func:`attention_params_to_kernel_weights`. A CUDA
    tensor runs the kernel; a CPU tensor runs the plain version.
    """
    return dispatch_gate("fused_attention_gate", Z, _launch,
                         fused_attention_gate_reference, weights,
                         num_layers=num_layers, use_layernorm=use_layernorm,
                         with_residual=with_residual)


# kernel launches so far; callers reset it to 0 to count one run's launches
fused_attention_gate.launches = 0


__all__ = ["fused_attention_gate", "fused_attention_gate_reference",
           "attention_params_to_kernel_weights", "shared_memory_bytes",
           "kernel_info", "tf32_round", "tf32_round_on_card",
           "tf32x3_fragments", "unpack_fragments"]
