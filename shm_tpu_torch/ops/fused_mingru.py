"""The whole deterministic minGRU-VAE gate as one hand-written CUDA kernel.

Counterpart of ``shm_tpu/ops/fused_mingru.py``: ``fused_mingru_gate`` maps
normalized windows Z [N, T, D] to the per-window reconstruction MSE [N] and,
with ``with_residual``, the squared residual [N, T, D], with z = mu, for a
``TemporalVAE(cell="min_gru")``.

- On a CUDA tensor it launches ``csrc/fused_mingru.cu`` (built with nvcc for
  ``sm_90a`` at first use) and adds one to ``fused_mingru_gate.launches``; a
  failed launch raises. There is no fallback.
- On a CPU tensor it runs :func:`fused_mingru_gate_reference`, the plain
  PyTorch version of the same arithmetic, which the tests hold against the
  JAX kernel and ``chip_smoke.py`` holds the CUDA kernel against.

The kernel computes every gate product of both stacks on the tensor cores
in 3xTF32, a tile's rows spanning several steps of its windows (the gates
never see h_{t-1}). It reads the ``w_ih`` as TF32 fragments that
:func:`mingru_params_to_kernel_weights` packs once (``tf32x3_fragments``,
K padded to a multiple of 8); the plain version reads them as given. The
kernel source states its bound on the card and what its design does about
it. Computation is float32 with float32 accumulation (the tensor cores
truncate their sums, so each pair of k-steps is summed apart and added to
the float32 sum to nearest); the MSE divides by the real ``T * D``.
:func:`gate_variant` reaches the same body with its other sums and tiles,
and :func:`kernel_info` says how the card takes it; neither is on a main
path. ``sigmoid_impl`` is the JAX kernel's (the port defaults to "exact",
JAX to "tanh"); "tanh" launches the tanh-form instance of its precision.

The kernel is built for H in {32, 64, 128}; a model of any other width
H <= 128 runs the next one on weights :func:`mingru_params_to_kernel_weights`
pads with zeros (a padded unit's z is 1/2 and its h~ 0, so its h stays 0
from h_0 = 0), LayerNorm over the model's own H, which the dict records. D
and Z go up to 128, L to 4; past these bounds a CUDA call raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.ops._build import count_launch, load_library, raise_on_error
from shm_tpu_torch.ops._gate import (
    HIDDEN_KEY, INSTANCE_WIDTHS, activations, add_fragments, bf16_round,
    check_fragments, check_weights, check_windows, dispatch_gate, f32,
    fragment_names, gate_dtypes, instance_width, layer_norm_real, pad_units,
    plain_products, pointer_array, real_hidden,
)

_H_MAX, _D_MAX, _Z_MAX, _L_MAX = 128, 128, 128, 4
# pointer order of the C entries (csrc/fused_mingru.cu: shm_fused_mingru_gate_f32)
_WEIGHT_ORDER = tuple(
    [f"enc{l}_wih" for l in range(_L_MAX)] + [f"enc{l}_b" for l in range(_L_MAX)]
    + ["ln_scale", "ln_bias", "mu_w", "mu_b", "z2h_w", "z2h_b"]
    + [f"dec{l}_wih" for l in range(_L_MAX)] + [f"dec{l}_b" for l in range(_L_MAX)]
    + ["out_w", "out_b"]
    + [f"{p}{l}_wih_frag" for p in ("enc", "dec") for l in range(_L_MAX)])
# the variant entry's sums (csrc/fused_mingru.cu: TcSum) and its width
TC_SUMS = {"chain": 0, "split": 1, "one_term": 2}
_VARIANT_H = 128


def mingru_params_to_kernel_weights(
        vae: TemporalVAE, dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict from a ``cell="min_gru"`` :class:`TemporalVAE`,
    on its device: ``*_wih`` [in, 2H] (the z half first), matmul weights
    [in, out], biases 1-D; every tensor contiguous float32. Each ``*_wih``
    also comes as the fragments of the precision ``dtype``: ``*_wih_frag``,
    its ``tf32x3_fragments`` (the input rows padded with zeros to a multiple
    of 8: D=12 to 16, D=3 to 8), which the float32 kernel reads, or for
    ``torch.bfloat16`` ``*_wih_frag_bf16``, the same of the weight rounded
    to bf16, which the bf16 kernel reads.

    A width H that is no kernel instance's (H <= 128, not 32, 64 or 128) is
    padded here, once, to the next one, as
    ``fused_vae.vae_params_to_kernel_weights`` pads (the z and h~ halves
    each get zero units); ``dict["hidden"]`` then holds H."""
    if vae.cell != "min_gru":
        raise ValueError(f"expected a cell='min_gru' VAE, got {vae.cell!r}")
    H = vae.hidden_dim
    Hp = instance_width(H)
    rows = lambda t: pad_units(t, H, Hp, dim=0)
    w = {}
    for stack, prefix in ((vae.encoder_lstm, "enc"), (vae.decoder_lstm, "dec")):
        for l, layer in enumerate(stack.layers):
            wih = layer.weight_ih.t()
            if prefix != "enc" or l > 0:
                wih = rows(wih)
            w[f"{prefix}{l}_wih"] = f32(pad_units(wih, H, Hp, groups=2))
            w[f"{prefix}{l}_b"] = f32(pad_units(layer.bias_ih, H, Hp, groups=2))
            add_fragments(w, f"{prefix}{l}_wih", dtype)
    if vae.layer_norm is not None:
        w["ln_scale"] = f32(rows(vae.layer_norm.weight))
        w["ln_bias"] = f32(rows(vae.layer_norm.bias))
    w["mu_w"] = f32(rows(vae.fc_mu.weight.t()))
    w["mu_b"] = f32(vae.fc_mu.bias)
    w["z2h_w"] = f32(pad_units(vae.fc_latent_to_hidden.weight.t(), H, Hp))
    w["z2h_b"] = f32(rows(vae.fc_latent_to_hidden.bias))
    w["out_w"] = f32(rows(vae.output_layer.weight.t()))
    w["out_b"] = f32(vae.output_layer.bias)
    if Hp != H:
        w[HIDDEN_KEY] = H
    return w


def _sweep(z: torch.Tensor, hc: torch.Tensor, T: int) -> torch.Tensor:
    """h_t = h_{t-1} + z_t * (h~_t - h_{t-1}) from h = 0 -> [N, T, H];
    ``z`` / ``hc`` are [N, T, H], or [N, H] when constant over T."""
    const = z.dim() == 2
    h = torch.zeros_like(z if const else z[:, 0])
    hs = []
    for t in range(T):
        zt, ht = (z, hc) if const else (z[:, t], hc[:, t])
        h = h + zt * (ht - h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def fused_mingru_gate_reference(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
    dtype: torch.dtype = torch.float32, io_dtype: Optional[torch.dtype] = None,
    sigmoid_impl: str = "exact",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: (mse [N], resid [N, T, D] | None).

    ``sigmoid_impl`` is the form of every z's sigmoid, as the JAX kernel's
    (``shm_tpu/ops/fused_mingru.py:90``, ``_gate.activations``): "exact"
    the logistic, "tanh" ``0.5 * (tanh(0.5 x) + 1)``; the decoder input
    stays ``tanh``, as in JAX.

    ``dtype=torch.bfloat16`` rounds where the JAX kernel with ``dtype=bf16``
    rounds (``shm_tpu/ops/fused_mingru.py:92-188``): both operands of every
    product, summed in float32; the gate scratch (z after its sigmoid, and
    h~) of every layer but the decoder's first, whose constant gates stay
    float32; every stored h_t (the input of the next product, rounded there
    anyway); and the output head's y before the residual. The sweep's
    running h, the encoder's last h (LayerNorm's input), LayerNorm and the
    mse stay float32. ``io_dtype`` as in ``fused_vae_gate_reference``; a
    padded dict as there."""
    N, T, D = Z.shape
    H = weights["mu_w"].shape[0]
    bf16, io = gate_dtypes(Z, dtype, io_dtype)
    sig, _ = activations(sigmoid_impl)
    x = Z.to(io).to(torch.float32)          # the window tile as read
    rnd = bf16_round if bf16 else (lambda t: t)
    mm = plain_products(weights, [k for k in weights if k.endswith("_wih")]
                        + ["mu_w", "z2h_w", "out_w"], bf16)

    def layer(prefix, l, inp):
        g = mm(inp, f"{prefix}{l}_wih") + weights[f"{prefix}{l}_b"]
        z, hc = sig(g[..., :H]), g[..., H:]
        if prefix == "enc" or l > 0:         # stored in the gate scratch
            z, hc = rnd(z), rnd(hc)
        return _sweep(z, hc, T)

    seq = x
    for l in range(num_layers):
        seq = layer("enc", l, seq)
    h_last = seq[:, -1]
    if use_layernorm:
        h_last = layer_norm_real(h_last, weights)
    mu = mm(h_last, "mu_w") + weights["mu_b"]
    seq = torch.tanh(mm(mu, "z2h_w") + weights["z2h_b"])  # constant input
    for l in range(num_layers):
        seq = layer("dec", l, seq)
    resid = (x - rnd(mm(seq, "out_w") + weights["out_b"])) ** 2
    mse = resid.sum(dim=(1, 2)) / (T * D)
    return mse, (resid.to(io) if with_residual else None)


def _check(weights, Z, num_layers, use_layernorm, bf16=False,
           io=torch.float32):
    check_windows(Z, io)
    if not 1 <= num_layers <= _L_MAX:
        raise ValueError(f"the fused minGRU kernel takes 1 to {_L_MAX} layers, "
                         f"got {num_layers}")
    H, Zd = weights["mu_w"].shape
    D = Z.shape[2]
    if (H not in INSTANCE_WIDTHS or real_hidden(weights, H) > H or D > _D_MAX
            or Zd > _Z_MAX):
        raise ValueError(
            f"unsupported shape for the fused minGRU kernel: "
            f"H={real_hidden(weights, H)} (<= {_H_MAX}; weights {H} wide, need "
            f"one of {INSTANCE_WIDTHS} as mingru_params_to_kernel_weights pads "
            f"them), D={D} (<= {_D_MAX}), Z={Zd} (<= {_Z_MAX})")
    if weights["enc0_wih"].shape != (D, 2 * H):
        raise ValueError(f"enc0_wih {tuple(weights['enc0_wih'].shape)} does "
                         f"not match D={D}, H={H}")
    need = [k for k in fragment_names(_WEIGHT_ORDER, bf16)
            if not (k[:3] in ("enc", "dec") and int(k[3]) >= num_layers)
            and (use_layernorm or not k.startswith("ln_"))]
    check_weights(weights, need, Z.device)
    check_fragments(weights, need)
    return need, H, Zd


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C entries declared (built at first
    use, never at import)."""
    lib = load_library("fused_mingru")
    fn = lib.shm_fused_mingru_gate_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn = lib.shm_fused_mingru_gate_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn = lib.shm_fused_mingru_variant
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    lib.shm_fused_mingru_info.restype = ctypes.c_int
    lib.shm_fused_mingru_info.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def kernel_info(T: int, H: int, L: int, *, D: int = 12, Z: int = 16,
                dtype: torch.dtype = torch.float32,
                io_dtype: Optional[torch.dtype] = None,
                sigmoid_impl: str = "exact") -> dict:
    """How the card takes the kernel instance a call of
    ``fused_mingru_gate`` with these ``dtype``, ``io_dtype`` and
    ``sigmoid_impl`` launches, for windows of T steps of D features at width
    H (the instance of ``instance_width(H)``) with L layers and Z latents:
    registers and local-memory (spill) bytes a thread, threads and dynamic
    shared bytes a block, windows a block, blocks an SM at once, and steps a
    tile. The defaults are the shipping float32 instance at the 4DOF
    preset's D and Z (every D <= 16 and Z <= 32 take the same bytes)."""
    Hp = instance_width(H)
    if (Hp not in INSTANCE_WIDTHS or not 1 <= L <= _L_MAX or T < 1
            or not 1 <= D <= _D_MAX or not 1 <= Z <= _Z_MAX):
        raise ValueError(f"unsupported shape for the fused minGRU kernel: "
                         f"T={T}, H={H}, L={L}, D={D}, Z={Z}")
    bf16, io = gate_dtypes(torch.empty(0), dtype, io_dtype)
    activations(sigmoid_impl)                       # raises for an unknown form
    lib = _library()
    out = (ctypes.c_int * 7)()
    raise_on_error(lib, lib.shm_fused_mingru_info(
        T, Hp, L, D, Z, int(bf16), int(io == torch.bfloat16),
        int(sigmoid_impl == "tanh"), out), "fused_mingru_gate info")
    return dict(zip(("registers", "spill_bytes", "threads", "shared_bytes",
                     "windows_per_block", "blocks_per_sm", "steps_per_tile"),
                    out))


def gate_variant(weights: Dict[str, torch.Tensor], Z: torch.Tensor, *,
                 num_layers: int, use_layernorm: bool, tc_sum: str = "split",
                 tc: Optional[int] = None, mt: Optional[int] = None,
                 ) -> torch.Tensor:
    """Gate-only mse [N] of an instance of the kernel's body at H=128 on a
    CUDA tensor: ``tc_sum`` one of :data:`TC_SUMS` ("split" is the shipping
    sum; "chain" chains every mma into one sum; "one_term" keeps a_b b_b
    alone, a planted fault), ``tc`` steps and ``mt`` m-tiles of 16 windows a
    tile (None: the shipping instance's; "split" takes tc in {1, 2, 4} and
    mt in {1, 2}, the other sums the shipping tile). Adds one to
    ``gate_variant.launches``, never to ``fused_mingru_gate.launches``."""
    need, H, Zd = _check(weights, Z, num_layers, use_layernorm)
    if Z.device.type != "cuda" or H != _VARIANT_H or tc_sum not in TC_SUMS:
        raise ValueError(f"gate_variant takes H={_VARIANT_H} on a CUDA tensor "
                         f"and a sum in {sorted(TC_SUMS)}; got H={H} on "
                         f"{Z.device}, {tc_sum!r}")
    if tc is None or mt is None:
        info = kernel_info(Z.shape[1], H, num_layers)
        tc = info["steps_per_tile"] if tc is None else tc
        mt = info["windows_per_block"] // 16 if mt is None else mt
    N, T, D = Z.shape
    mse = torch.empty(N, device=Z.device, dtype=torch.float32)
    if N == 0:
        return mse
    lib = _library()
    ptrs = pointer_array(weights, _WEIGHT_ORDER, need)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = lib.shm_fused_mingru_variant(
            Z.data_ptr(), mse.data_ptr(), ptrs, len(_WEIGHT_ORDER), N, T, D,
            H, Zd, num_layers, int(use_layernorm), TC_SUMS[tc_sum], tc, mt,
            stream)
    raise_on_error(lib, err, f"fused_mingru gate_variant({tc_sum!r}, tc={tc}, "
                             f"mt={mt})")
    count_launch(gate_variant)
    return mse


gate_variant.launches = 0


def _launch(weights, Z, num_layers, use_layernorm, with_residual, dtype,
            io_dtype, sigmoid_impl):
    bf16, io = gate_dtypes(Z, dtype, io_dtype)
    activations(sigmoid_impl)                       # raises for an unknown form
    sig_tanh = int(sigmoid_impl == "tanh")
    Z = Z.to(io)                        # a bf16 io: the card rounds once
    need, H, Zd = _check(weights, Z, num_layers, use_layernorm, bf16, io)
    N, T, D = Z.shape
    mse = torch.empty(N, device=Z.device, dtype=torch.float32)
    resid = torch.empty_like(Z) if with_residual else None
    if N == 0:
        return mse, resid
    lib = _library()
    order = fragment_names(_WEIGHT_ORDER, bf16)
    ptrs = pointer_array(weights, order, need)
    args = (Z.data_ptr(), resid.data_ptr() if with_residual else None,
            mse.data_ptr(), ptrs, len(order), N, T, D, H,
            real_hidden(weights, H), Zd, num_layers, int(use_layernorm),
            int(with_residual), sig_tanh)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        if bf16:
            err = lib.shm_fused_mingru_gate_bf16(
                *args, int(io == torch.bfloat16), stream)
        else:
            err = lib.shm_fused_mingru_gate_f32(*args, stream)
    raise_on_error(lib, err, "fused_mingru_gate")
    count_launch(fused_mingru_gate, "bf16_launches" if bf16 else "launches")
    if sig_tanh:
        count_launch(fused_mingru_gate, "sigmoid_tanh_launches")
    return mse, resid


def fused_mingru_gate(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
    dtype: torch.dtype = torch.float32, io_dtype: Optional[torch.dtype] = None,
    sigmoid_impl: str = "exact",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused deterministic minGRU-VAE pass: (mse [N], resid [N, T, D] | None).

    ``weights`` comes from :func:`mingru_params_to_kernel_weights`. A CUDA
    tensor runs the kernel; a CPU tensor runs the plain version.
    ``dtype`` / ``io_dtype`` as the JAX kernel's (the plain version says
    where bf16 rounds): ``dtype=torch.bfloat16`` launches the kernel's bf16
    instance, counted in ``fused_mingru_gate.bf16_launches``.
    ``sigmoid_impl`` "exact" (the port's default) or "tanh" (the JAX
    kernel's default): "tanh" launches the tanh-form instance of the same
    precision, counted also in ``sigmoid_tanh_launches``.
    """
    return dispatch_gate("fused_mingru_gate", Z, _launch,
                         fused_mingru_gate_reference, weights,
                         num_layers=num_layers, use_layernorm=use_layernorm,
                         with_residual=with_residual, dtype=dtype,
                         io_dtype=io_dtype, sigmoid_impl=sigmoid_impl)


# kernel launches so far, of the float32 and of the bf16 instance, and of
# those the launches with the tanh-form sigmoid; callers reset them to 0 to
# count one run's launches
fused_mingru_gate.launches = 0
fused_mingru_gate.bf16_launches = 0
fused_mingru_gate.sigmoid_tanh_launches = 0


__all__ = ["fused_mingru_gate", "fused_mingru_gate_reference", "gate_variant",
           "kernel_info", "mingru_params_to_kernel_weights"]
