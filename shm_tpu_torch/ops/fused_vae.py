"""The whole deterministic LSTM-VAE gate as one hand-written CUDA kernel.

Counterpart of ``shm_tpu/ops/fused_vae.py``: ``fused_vae_gate`` maps
normalized windows Z [N, T, D] to the per-window reconstruction MSE [N] and,
with ``with_residual``, the squared residual [N, T, D], with z = mu.

- On a CUDA tensor it launches ``csrc/fused_vae.cu`` (built with nvcc for
  ``sm_90a`` at first use) and adds one to ``fused_vae_gate.launches``; a
  failed launch raises. There is no fallback.
- On a CPU tensor it runs :func:`fused_vae_gate_reference`, the plain
  PyTorch version of the same arithmetic, which the tests hold against the
  JAX kernel and ``chip_smoke.py`` holds the CUDA kernel against.

The kernel computes every LSTM gate product of both stacks on the tensor
cores in 3xTF32. It reads those weights as TF32 fragments that
:func:`vae_params_to_kernel_weights` packs once (``tf32x3_fragments``, K
padded to a multiple of 8); the plain version reads them as given. The
kernel source states its bound on the card and what its design does about
it. Computation is float32 with float32 accumulation (the tensor cores
truncate their sums, so each pair of k-steps is summed apart and added to
the float32 sum to nearest); the MSE divides by the real ``T * D`` (no
feature padding). The same source also holds the float32
FMA body that the probe variants of ``shm_tpu_torch/tools/probe_vpu_bound.py``
time (C entry ``shm_fused_vae_probe``), which reaches the shipping body too.

The kernel is built for H in {32, 64, 128}; a model of any other width
H <= 128 runs the next one on weights :func:`vae_params_to_kernel_weights`
pads with zeros (a padded LSTM unit has zero weights in and out and a zero
bias, so i = f = o = 1/2, g = 0 and its c and h stay 0), and LayerNorm
normalises over the model's own H, which the dict records. D and Z go up to
128, as far as the JAX kernel is used; past these bounds a CUDA call
raises.

The JAX kernel's options ``sigmoid_impl`` / ``tanh_impl`` (activation
forms) and ``residual_layout`` ("transposed": [T, Dp, N]) are taken under
the same names; the port's forms default to "exact" / "exact" (the JAX
kernel defaults to the tanh-form sigmoid). Another form launches the forms
instance of its precision, which never runs another form.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.ops._build import count_launch, load_library, raise_on_error
from shm_tpu_torch.ops._gate import (
    HIDDEN_KEY, INSTANCE_WIDTHS, activations, add_fragments, check_fragments,
    check_weights, check_windows, dispatch_gate, f32, fragment_names,
    gate_dtypes, instance_width, layer_norm_real, pad_units, plain_products,
    pointer_array, real_hidden,
)

# the kernel's tensor-core products: every LSTM weight of both stacks
_PRODUCTS = tuple(f"{p}{l}_{k}" for p in ("enc", "dec") for l in range(2)
                  for k in ("wih", "whh"))
# pointer order of the C entry (csrc/fused_vae.cu: shm_fused_vae_gate_f32)
_WEIGHT_ORDER = (
    "enc0_wih", "enc0_whh", "enc0_b", "enc1_wih", "enc1_whh", "enc1_b",
    "ln_scale", "ln_bias", "mu_w", "mu_b", "z2h_w", "z2h_b",
    "dec0_wih", "dec0_whh", "dec0_b", "dec1_wih", "dec1_whh", "dec1_b",
    "out_w", "out_b",
) + tuple(f"{k}_frag" for k in _PRODUCTS)
_H_MAX, _D_MAX, _Z_MAX = 128, 128, 128
# every weight the kernel multiplies by (rounded to bf16 in the bf16 mode)
_PRODUCT_WEIGHTS = tuple(k for p in ("enc", "dec") for l in range(2)
                         for k in (f"{p}{l}_wih", f"{p}{l}_whh")) + (
    "mu_w", "z2h_w", "out_w")
RESIDUAL_LAYOUTS = ("nhwc", "transposed")


def vae_params_to_kernel_weights(
        vae: TemporalVAE, dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict from a :class:`TemporalVAE`, on its device.

    Matmul weights are [in, out] (LSTM ``*_wih`` [in, 4H], ``*_whh`` [H, 4H],
    gates i|f|g|o), biases 1-D (the cell's ``bias_ih + bias_hh``); every
    tensor is contiguous float32. Each LSTM weight also comes as the
    fragments of the precision ``dtype`` the gate will run at: ``*_frag``,
    its ``tf32x3_fragments`` (the input rows padded with zeros to a multiple
    of 8: D=12 to 16, D=3 to 8), which the float32 kernel reads, or for
    ``torch.bfloat16`` ``*_frag_bf16``, the same of the weight rounded to
    bf16, which the bf16 kernel reads (``_gate.add_fragments``).

    A width H that is no kernel instance's (H <= 128, not 32, 64 or 128) is
    padded here, once, to the next one Hp (``_gate.instance_width``): each
    gate's columns and every row over H get zero units (``_gate.pad_units``),
    as do LayerNorm's scale and bias and the heads' rows and columns over H;
    ``dict["hidden"]`` then holds H, over which LayerNorm normalises. The
    padded units' h is exactly 0, so the plain version on this dict computes
    the model's function.
    """
    H = vae.hidden_dim
    Hp = instance_width(H)
    rows = lambda t: pad_units(t, H, Hp, dim=0)
    gates = lambda t: pad_units(t, H, Hp, dim=-1, groups=4)
    w = {}
    for stack, prefix in ((vae.encoder_lstm, "enc"), (vae.decoder_lstm, "dec")):
        for l, layer in enumerate(stack.layers):
            p = f"{prefix}{l}"
            wih = layer.weight_ih.t()
            w[f"{p}_wih"] = f32(gates(wih if p == "enc0" else rows(wih)))
            w[f"{p}_whh"] = f32(gates(rows(layer.weight_hh.t())))
            w[f"{p}_b"] = f32(gates(layer.bias_ih + layer.bias_hh))
            for k in ("wih", "whh"):
                add_fragments(w, f"{p}_{k}", dtype)
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


def fused_vae_gate_reference(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
    dtype: torch.dtype = torch.float32, io_dtype: Optional[torch.dtype] = None,
    sigmoid_impl: str = "exact", tanh_impl: str = "exact",
    residual_layout: str = "nhwc",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: (mse [N], resid | None), the
    residual [N, T, D] or, with ``residual_layout="transposed"``,
    :func:`transposed_residual` of it.

    ``sigmoid_impl`` / ``tanh_impl`` are the forms of
    ``shm_tpu/ops/fused_vae.py:146-151`` (``_gate.activations``): the tanh
    form applies to the cell's g and c and to the decoder input
    ``tanh(z2h)``, the sigmoid form to the cell's i, f and o.

    ``dtype=torch.bfloat16`` rounds where the JAX kernel with ``dtype=bf16``
    rounds (``shm_tpu/ops/fused_vae.py:153-163``, ``:225-230``): both
    operands of every product (the gate products on x and h, the mu head,
    ``z2h``, the decoder's constant projection, the output head), the
    products summed in float32; h, c, LayerNorm and the mse stay float32.
    ``io_dtype`` bf16 reads the windows as bf16 (in the residual's ``x - y``
    too) and returns the residual as bf16. On a padded dict
    (:func:`vae_params_to_kernel_weights`) it runs at the padded width, and
    LayerNorm over the model's own."""
    N, T, D = Z.shape
    H = weights["enc0_whh"].shape[0]
    bf16, io = gate_dtypes(Z, dtype, io_dtype)
    sig, tanh = activations(sigmoid_impl, tanh_impl)
    _check_layout(residual_layout)
    x = Z.to(io).to(torch.float32)          # the window tile as read
    mm = plain_products(weights, [k for k in _PRODUCT_WEIGHTS
                                  if k in weights], bf16)

    def step(h, c, gates):
        i, f, g, o = gates.split(H, dim=1)
        c = sig(f) * c + sig(i) * tanh(g)
        return sig(o) * tanh(c), c

    zeros = x.new_zeros(N, H)
    hs, cs = [zeros] * num_layers, [zeros] * num_layers
    for t in range(T):
        inp = x[:, t]
        for l in range(num_layers):
            g = (mm(inp, f"enc{l}_wih") + mm(hs[l], f"enc{l}_whh")
                 + weights[f"enc{l}_b"])
            hs[l], cs[l] = step(hs[l], cs[l], g)
            inp = hs[l]
    h_last = hs[-1]
    if use_layernorm:
        h_last = layer_norm_real(h_last, weights)
    mu = mm(h_last, "mu_w") + weights["mu_b"]
    dec_in = tanh(mm(mu, "z2h_w") + weights["z2h_b"])
    xp_const = mm(dec_in, "dec0_wih") + weights["dec0_b"]   # once

    hs, cs = [zeros] * num_layers, [zeros] * num_layers
    acc = x.new_zeros(N)
    resid = [] if with_residual else None
    for t in range(T):
        g = xp_const + mm(hs[0], "dec0_whh")
        hs[0], cs[0] = step(hs[0], cs[0], g)
        for l in range(1, num_layers):
            g = (mm(hs[l - 1], f"dec{l}_wih")
                 + mm(hs[l], f"dec{l}_whh") + weights[f"dec{l}_b"])
            hs[l], cs[l] = step(hs[l], cs[l], g)
        y_t = mm(hs[-1], "out_w") + weights["out_b"]
        r_t = (x[:, t] - y_t) ** 2
        if with_residual:
            resid.append(r_t)
        acc = acc + r_t.sum(dim=1)
    mse = acc / (T * D)
    if not with_residual:
        return mse, None
    resid = torch.stack(resid, dim=1).to(io)
    if residual_layout == "transposed":
        resid = transposed_residual(resid)
    return mse, resid


def padded_features(D: int) -> int:
    """Dp, the feature rows of a transposed residual: D rounded up to 16,
    as the JAX kernel pads its feature tile (``fused_vae.py:350``)."""
    return -(-D // 16) * 16


def transposed_residual(resid: torch.Tensor) -> torch.Tensor:
    """A residual [N, T, D] in the layout ``residual_layout="transposed"``
    returns: [T, Dp, N] contiguous, the rows past D exact zeros. N is not
    padded (the JAX kernel pads it to its batch tile, a TPU tile)."""
    N, T, D = resid.shape
    return F.pad(resid.permute(1, 2, 0), (0, 0, 0, padded_features(D) - D)
                 ).contiguous()


def _check_layout(residual_layout: str) -> None:
    if residual_layout not in RESIDUAL_LAYOUTS:
        raise ValueError(f"unknown residual_layout {residual_layout!r} "
                         "(expected 'nhwc' or 'transposed')")


def _check(weights, Z, num_layers, use_layernorm, bf16=False,
           io=torch.float32):
    check_windows(Z, io)
    if num_layers not in (1, 2):
        raise ValueError("the fused kernel supports 1- or 2-layer presets")
    H = weights["enc0_whh"].shape[0]
    D = Z.shape[2]
    Zd = weights["mu_w"].shape[1]
    if (H not in INSTANCE_WIDTHS or real_hidden(weights, H) > H or D > _D_MAX
            or Zd > _Z_MAX):
        raise ValueError(
            f"unsupported shape for the fused kernel: H={real_hidden(weights, H)} "
            f"(<= {_H_MAX}; weights {H} wide, need one of {INSTANCE_WIDTHS} "
            f"as vae_params_to_kernel_weights pads them), D={D} (<= {_D_MAX}), "
            f"Z={Zd} (<= {_Z_MAX})")
    if weights["enc0_wih"].shape != (D, 4 * H):
        raise ValueError(f"enc0_wih {tuple(weights['enc0_wih'].shape)} does "
                         f"not match D={D}, H={H}")
    need = [k for k in fragment_names(_WEIGHT_ORDER, bf16)
            if (num_layers == 2 or "1_" not in k)
            and (use_layernorm or not k.startswith("ln_"))]
    check_weights(weights, need, Z.device)
    check_fragments(weights, need)
    return need, H, Zd


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C entries declared (built at first
    use, never at import)."""
    lib = load_library("fused_vae")
    fn = lib.shm_fused_vae_gate_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn = lib.shm_fused_vae_gate_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                   + [ctypes.c_void_p])
    # the probe variants of the same kernel (tools/probe_vpu_bound.py)
    fn = lib.shm_fused_vae_probe
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    lib.shm_fused_vae_info.restype = ctypes.c_int
    lib.shm_fused_vae_info.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def _act(sigmoid_impl: str, tanh_impl: str) -> int:
    """The C entries' ``act``: bit 0 the tanh-form sigmoid, bit 1 the
    rational tanh (0, the forms "exact" / "exact", runs the default
    instances; any other value the forms' instances)."""
    activations(sigmoid_impl, tanh_impl)            # raises for an unknown form
    return int(sigmoid_impl == "tanh") | 2 * int(tanh_impl == "rational")


def kernel_info(T: int, H: int, L: int, *, D: int = 12, Z: int = 16,
                dtype: torch.dtype = torch.float32,
                io_dtype: Optional[torch.dtype] = None,
                sigmoid_impl: str = "exact", tanh_impl: str = "exact") -> dict:
    """How the card takes the kernel instance a call of ``fused_vae_gate``
    with these ``dtype``, ``io_dtype`` and forms launches, for windows of T
    steps of D features at width H (the instance of ``instance_width(H)``)
    with L layers and Z latents: registers and local-memory (spill) bytes a
    thread, threads and dynamic shared bytes a block, windows a block,
    blocks an SM at once. The defaults are the float32 instance of the
    default forms at the 4DOF preset's D and Z (every D <= 16 and Z <= 32
    take the same bytes)."""
    Hp = instance_width(H)
    if (Hp not in INSTANCE_WIDTHS or L not in (1, 2) or T < 1
            or not 1 <= D <= _D_MAX or not 1 <= Z <= _Z_MAX):
        raise ValueError(f"unsupported shape for the fused kernel: T={T}, "
                         f"H={H}, L={L}, D={D}, Z={Z}")
    bf16, io = gate_dtypes(torch.empty(0), dtype, io_dtype)
    forms = int(_act(sigmoid_impl, tanh_impl) != 0)
    lib = _library()
    out = (ctypes.c_int * 6)()
    raise_on_error(lib, lib.shm_fused_vae_info(
        T, Hp, L, D, Z, int(bf16), int(io == torch.bfloat16), forms, out),
        "fused_vae_gate info")
    return dict(zip(("registers", "spill_bytes", "threads", "shared_bytes",
                     "windows_per_block", "blocks_per_sm"), out))


def _launch(weights, Z, num_layers, use_layernorm, with_residual, dtype,
            io_dtype, sigmoid_impl, tanh_impl, residual_layout):
    bf16, io = gate_dtypes(Z, dtype, io_dtype)
    act = _act(sigmoid_impl, tanh_impl)
    _check_layout(residual_layout)
    transposed = residual_layout == "transposed"
    Z = Z.to(io)                        # a bf16 io: the card rounds once
    need, H, Zd = _check(weights, Z, num_layers, use_layernorm, bf16, io)
    N, T, D = Z.shape
    mse = torch.empty(N, device=Z.device, dtype=torch.float32)
    resid = None
    if with_residual:
        resid = (Z.new_empty(T, padded_features(D), N) if transposed
                 else torch.empty_like(Z))
    if N == 0:
        return mse, resid
    lib = _library()
    order = fragment_names(_WEIGHT_ORDER, bf16)
    ptrs = pointer_array(weights, order, need)
    args = (Z.data_ptr(), resid.data_ptr() if with_residual else None,
            mse.data_ptr(), ptrs, len(order), N, T, D, H,
            real_hidden(weights, H), Zd, num_layers, int(use_layernorm),
            int(with_residual), act, int(transposed))
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        if bf16:
            err = lib.shm_fused_vae_gate_bf16(
                *args, int(io == torch.bfloat16), stream)
        else:
            err = lib.shm_fused_vae_gate_f32(*args, stream)
    raise_on_error(lib, err, "fused_vae_gate")
    count_launch(fused_vae_gate, "bf16_launches" if bf16 else "launches")
    if act & 1:
        count_launch(fused_vae_gate, "sigmoid_tanh_launches")
    if act & 2:
        count_launch(fused_vae_gate, "tanh_rational_launches")
    if with_residual and transposed:
        count_launch(fused_vae_gate, "transposed_launches")
    return mse, resid


def fused_vae_gate(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
    dtype: torch.dtype = torch.float32, io_dtype: Optional[torch.dtype] = None,
    sigmoid_impl: str = "exact", tanh_impl: str = "exact",
    residual_layout: str = "nhwc",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused deterministic VAE pass: (mse [N], resid [N, T, D] | None).

    ``weights`` comes from :func:`vae_params_to_kernel_weights`. A CUDA
    tensor runs the kernel; a CPU tensor runs the plain version.
    ``dtype`` / ``io_dtype`` as the JAX kernel's (the plain version says
    where bf16 rounds): ``dtype=torch.bfloat16`` launches the kernel's bf16
    instance, counted in ``fused_vae_gate.bf16_launches``; ``io_dtype``
    bf16 (bf16 products only) passes the windows to it as bf16 and returns
    a bf16 residual.

    ``sigmoid_impl`` ("exact" or "tanh") and ``tanh_impl`` ("exact" or
    "rational") are the JAX kernel's forms; the port defaults to "exact" /
    "exact" where JAX defaults to the tanh-form sigmoid. Any other form
    launches the kernel's forms instance of the same precision, counted
    also in ``sigmoid_tanh_launches`` / ``tanh_rational_launches``.
    ``residual_layout="transposed"`` returns the residual as [T, Dp, N]
    (:func:`transposed_residual`; Dp = D rounded up to 16, those rows zero)
    with the same mse bit for bit, counted also in ``transposed_launches``.
    """
    return dispatch_gate("fused_vae_gate", Z, _launch,
                         fused_vae_gate_reference, weights,
                         num_layers=num_layers, use_layernorm=use_layernorm,
                         with_residual=with_residual, dtype=dtype,
                         io_dtype=io_dtype, sigmoid_impl=sigmoid_impl,
                         tanh_impl=tanh_impl, residual_layout=residual_layout)


# kernel launches so far, of the float32 and of the bf16 instance, and of
# those the launches with the tanh-form sigmoid, with the rational tanh and
# with a transposed residual; callers reset them to 0 to count one run's
# launches
fused_vae_gate.launches = 0
fused_vae_gate.bf16_launches = 0
fused_vae_gate.sigmoid_tanh_launches = 0
fused_vae_gate.tanh_rational_launches = 0
fused_vae_gate.transposed_launches = 0


__all__ = ["fused_vae_gate", "fused_vae_gate_reference", "kernel_info",
           "padded_features", "transposed_residual",
           "vae_params_to_kernel_weights"]
