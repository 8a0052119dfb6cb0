"""What the fused gate wrappers share: input checks, the pointer array of a
C entry, the one rule of dispatch (a CUDA tensor launches the kernel, a
CPU tensor runs the plain version, nothing gives way), the two precisions
a gate runs at, and the packing of the weights that a kernel multiplies on
the tensor cores (3xTF32 B fragments, the same of bf16-rounded weights,
bf16 A and B fragments of m16n8k16)."""

from __future__ import annotations

import ctypes
from typing import Dict, Iterable, Sequence, Tuple

import torch
import torch.nn.functional as F


def f32(t: torch.Tensor) -> torch.Tensor:
    """A detached contiguous float32 copy or view of ``t``."""
    return t.detach().to(torch.float32).contiguous()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), kept in float32: the plain
    versions' stand-in for a kernel's bf16 operand or stored value."""
    return t.to(torch.bfloat16).to(torch.float32)


# the suffix of a weight's fragments in a kernel weight dict: 3xTF32 of the
# weight as given (the float32 instances), and of the weight rounded to bf16
# (the bf16 instances of rows 1 and 6 and row 7's long body; their TF32
# small parts are zero), and the m16n8k16 bf16 B fragments of the weight
# rounded to bf16 (row 7's bf16 resident body)
FRAG, FRAG_BF16, FRAG_K16 = "_frag", "_frag_bf16", "_frag_k16"


# the widths the LSTM and minGRU kernels are built for; a model of another
# width H <= 128 runs the next one on weights padded with zeros
# (:func:`instance_width`, :func:`pad_units`), and a weight dict so padded
# records the model's own width under HIDDEN_KEY
INSTANCE_WIDTHS = (32, 64, 128)
HIDDEN_KEY = "hidden"


def instance_width(H: int) -> int:
    """The kernel instance's width a model of width ``H`` runs at: the
    smallest of :data:`INSTANCE_WIDTHS` not below ``H``, or ``H`` itself past
    the largest (which a kernel's checks then refuse)."""
    return next((w for w in INSTANCE_WIDTHS if w >= H), H)


def pad_units(t: torch.Tensor, H: int, Hp: int, dim: int = -1,
              groups: int = 1) -> torch.Tensor:
    """``t`` with ``dim`` (``groups`` blocks of ``H`` units, e.g. an LSTM's
    gates i|f|g|o) widened to ``groups`` blocks of ``Hp``, each block's new
    units zero: the exact padding of a recurrent layer whose padded units
    have zero weights in and out and a zero bias. Differentiable (the
    gradient is sliced back); ``t`` itself when ``Hp == H``."""
    if Hp == H:
        return t
    dim = dim % t.dim()
    shape = tuple(t.shape)
    g = t.reshape(shape[:dim] + (groups, H) + shape[dim + 1:])
    g = F.pad(g, [0, 0] * (t.dim() - dim - 1) + [0, Hp - H])
    return g.reshape(shape[:dim] + (groups * Hp,) + shape[dim + 1:])


def real_hidden(weights: Dict[str, torch.Tensor], H: int) -> int:
    """The model's width of a kernel weight dict whose tensors are ``H``
    wide: the width recorded by the padding, else ``H``."""
    return int(weights.get(HIDDEN_KEY, H))


def layer_norm_real(h: torch.Tensor, weights: Dict[str, torch.Tensor],
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of ``h`` [N, H] (``ln_scale`` / ``ln_bias`` of
    ``weights``) over the model's own units, the padded ones left at
    zero, as the kernels normalise."""
    H = h.shape[-1]
    hr = real_hidden(weights, H)
    out = F.layer_norm(h[..., :hr], (hr,), weights["ln_scale"][:hr],
                       weights["ln_bias"][:hr], eps=eps)
    return out if hr == H else F.pad(out, (0, H - hr))


def gate_dtypes(Z: torch.Tensor, dtype, io_dtype) -> Tuple[bool, torch.dtype]:
    """``(bf16, io)`` of a gate call, the JAX kernels' ``dtype`` and
    ``io_dtype``: ``dtype`` float32 (the port's default) or bfloat16 (every
    product's two operands rounded to bf16 and summed in float32, and the
    kernel's stores rounded where the TPU kernel stores bf16); ``io_dtype``
    the type the kernel reads the windows in and writes the residual in,
    ``None`` for ``Z``'s own. A bf16 io takes bf16 products; anything else
    raises ``ValueError``."""
    io = Z.dtype if io_dtype is None else io_dtype
    ok = (torch.float32, torch.bfloat16)
    if dtype not in ok or io not in ok or (io == torch.bfloat16
                                           and dtype != torch.bfloat16):
        raise ValueError(f"a gate runs float32 or bfloat16 products with "
                         f"float32 io, or bfloat16 with bfloat16 io; got "
                         f"dtype={dtype}, io_dtype={io}")
    return dtype == torch.bfloat16, io


SIGMOID_IMPLS = ("tanh", "exact")
TANH_IMPLS = ("exact", "rational")
# the R(7,6) rational fit of tanh on [-7, 7] of shm_tpu/ops/fused_vae.py:97-98
# (odd numerator, even denominator; max |err| 9.7e-7 with the input clamp)
TANH_P = (0.999996935, 0.123091227, 2.28254070e-3, 3.95225241e-6)
TANH_Q = (0.456412385, 2.10997819e-2, 1.42908691e-4)


def tanh_rational(x: torch.Tensor) -> torch.Tensor:
    """tanh as the clamped R(7,6) rational, the JAX kernels' ``tanh_impl=
    "rational"``: x clamped to +-7, both polynomials by Horner in that
    order, one division."""
    x = x.clamp(-7.0, 7.0)
    x2 = x * x
    p = x * (TANH_P[0] + x2 * (TANH_P[1] + x2 * (TANH_P[2] + x2 * TANH_P[3])))
    q = 1.0 + x2 * (TANH_Q[0] + x2 * (TANH_Q[1] + x2 * TANH_Q[2]))
    return p / q


def activations(sigmoid_impl: str = "exact", tanh_impl: str = "exact"):
    """``(sigmoid, tanh)`` of a gate's forms, the JAX kernels' names:
    ``sigmoid_impl`` "exact" is the logistic ``1 / (1 + exp(-x))``, "tanh"
    is ``0.5 * (tanh(0.5 x) + 1)`` through the chosen tanh; ``tanh_impl``
    "exact" is ``torch.tanh``, "rational" :func:`tanh_rational`. Anything
    else raises ``ValueError``."""
    if sigmoid_impl not in SIGMOID_IMPLS:
        raise ValueError(f"unknown sigmoid_impl {sigmoid_impl!r} "
                         "(expected 'tanh' or 'exact')")
    if tanh_impl not in TANH_IMPLS:
        raise ValueError(f"unknown tanh_impl {tanh_impl!r} "
                         "(expected 'exact' or 'rational')")
    tanh = tanh_rational if tanh_impl == "rational" else torch.tanh
    if sigmoid_impl == "tanh":
        return (lambda x: 0.5 * (tanh(0.5 * x) + 1.0)), tanh
    return torch.sigmoid, tanh


def bf16_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of the plain versions' bf16 mode, ``w`` already rounded:
    ``a`` rounded to bf16, the exact products summed in float32."""
    return bf16_round(a) @ w


def plain_products(weights: Dict[str, torch.Tensor], names: Iterable[str],
                   bf16: bool):
    """``mm(a, name)``: ``a @ weights[name]`` as a gate's plain version
    multiplies, in float32, or in bf16 (:func:`bf16_product`, the weights
    rounded once here)."""
    wr = {k: bf16_round(weights[k]) if bf16 else weights[k] for k in names}
    if bf16:
        return lambda a, k: bf16_product(a, wr[k])
    return lambda a, k: a @ wr[k]


def add_fragments(weights: Dict[str, torch.Tensor], name: str,
                  dtype: torch.dtype) -> None:
    """The fragments of ``weights[name]`` for the one precision a kernel
    will run at: ``<name>_frag`` (:func:`tf32x3_fragments`) for float32,
    ``<name>_frag_bf16`` (:func:`bf16_fragments`) for bfloat16; anything
    else raises ``ValueError``. A dict packed for one precision lacks the
    other's fragments, so a gate launched at the other raises."""
    if dtype == torch.float32:
        weights[name + FRAG] = tf32x3_fragments(weights[name])
    elif dtype == torch.bfloat16:
        weights[name + FRAG_BF16] = bf16_fragments(weights[name])
    else:
        raise ValueError(f"kernel weights are packed for float32 or bfloat16 "
                         f"products, got {dtype}")


def bf16_fragments(w: torch.Tensor) -> torch.Tensor:
    """:func:`tf32x3_fragments` of ``w`` rounded to bf16: a bf16 value is
    exact in TF32, so the small parts are zero and a one-term TF32 product
    of bf16-rounded operands is the exact bf16 product."""
    return tf32x3_fragments(bf16_round(w))


def tf32_round(w: torch.Tensor) -> torch.Tensor:
    """``w`` (float32) rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, kept in float32 with the low 13 bits zero: what
    ``cvt.rna.tf32.f32`` gives on the card."""
    bits = w.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_fragments(w: torch.Tensor) -> torch.Tensor:
    """A weight ``w`` [K, N] (N a multiple of 8) as a kernel's 3xTF32 B
    fragments of ``mma.sync.m16n8k8`` [N/8, ceil(K/8), 32, 4]: for n-tile nt,
    k-step kt and lane (g = lane // 4, t = lane % 4) the float4 {b0 big,
    b1 big, b0 small, b1 small} with b0 = w[8kt + t, 8nt + g],
    b1 = w[8kt + t + 4, 8nt + g], big = :func:`tf32_round` (w) and
    small = :func:`tf32_round` (w - big). Rows past K are zero."""
    w = F.pad(w, (0, 0, 0, -w.shape[0] % 8))
    K, N = w.shape
    big = tf32_round(w)
    small = tf32_round(w - big)
    # [kt, half, t, nt, g] -> [nt, kt, g, t, half]; w[8kt + 4half + t, 8nt + g]
    frag = lambda x: x.reshape(K // 8, 2, 4, N // 8, 8).permute(3, 0, 4, 2, 1)
    return torch.stack([frag(big), frag(small)], dim=-2).reshape(
        N // 8, K // 8, 32, 4).contiguous()


def unpack_fragments(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) [K, N] from fragments made by :func:`tf32x3_fragments`."""
    NT, KT = f.shape[:2]
    x = f.reshape(NT, KT, 8, 4, 2, 2).permute(4, 1, 5, 3, 0, 2)
    x = x.reshape(2, 8 * KT, 8 * NT)
    return x[0], x[1]


def bf16_b_fragments(w: torch.Tensor) -> torch.Tensor:
    """A weight ``w`` [K, N] (N a multiple of 8) as a kernel's bf16 B
    fragments of ``mma.sync.m16n8k16`` [N/8, ceil(K/16), 32, 2] int32, 2
    bytes a weight: for n-tile nt, k-step ks and lane (g = lane // 4,
    t = lane % 4) the two registers {b0, b1}, each two bf16 with the lower k
    in the low half: b0 = w[16ks + 2t, +1][8nt + g], b1 = w[16ks + 8 + 2t,
    +1][8nt + g]. w is rounded to bf16 to nearest even; rows past K are
    zero."""
    w = F.pad(w.detach().to(torch.float32), (0, 0, 0, -w.shape[0] % 16))
    K, N = w.shape
    bits = w.to(torch.bfloat16).view(torch.int16)
    # [ks, r, t, pair, nt, g] -> [nt, ks, g, t, r, pair]: w[16ks + 8r + 2t +
    # pair][8nt + g], register r of lane 4g + t
    x = bits.reshape(K // 16, 2, 4, 2, N // 8, 8).permute(4, 0, 5, 2, 1, 3)
    return x.contiguous().view(torch.int32).reshape(N // 8, K // 16, 32, 2)


def unpack_bf16_b_fragments(f: torch.Tensor) -> torch.Tensor:
    """The weight [16 * ceil(K/16), N] in float32 (padding included) from
    fragments made by :func:`bf16_b_fragments`."""
    NT, KS = f.shape[:2]
    bits = f.contiguous().view(torch.int16).reshape(NT, KS, 8, 4, 2, 2)
    w = bits.permute(1, 4, 3, 5, 0, 2).reshape(16 * KS, 8 * NT)
    return w.contiguous().view(torch.bfloat16).to(torch.float32)


def bf16_a_fragments(w: torch.Tensor) -> torch.Tensor:
    """A weight ``w`` [K, M] (the flax layout [in, out]) as a kernel's bf16 A
    fragments of ``mma.sync.m16n8k16`` for A = w^T [M, K], row-major:
    [ceil(M/16), ceil(K/16), 32, 4] int32. For m-tile mt, k-step ks and lane
    (g = lane // 4, t = lane % 4) the four registers {a0, a1, a2, a3}, each
    two bf16 with the lower k in the low half: a0 = A[16mt + g][16ks + 2t,
    +1], a1 the same of row g + 8, a2 and a3 those of columns + 8. A is
    rounded to bf16 to nearest even; the rows and columns past M and K are
    zero."""
    K, M = w.shape
    a = F.pad(w.detach().t().to(torch.float32), (0, -K % 16, 0, -M % 16))
    MT, KS = a.shape[0] // 16, a.shape[1] // 16
    bits = a.to(torch.bfloat16).view(torch.int16)
    # [mt, rh, g, ks, ch, t, pair] -> [mt, ks, g, t, ch, rh, pair]: A[16mt +
    # 8rh + g][16ks + 8ch + 2t + pair], register 2ch + rh of lane 4g + t
    x = bits.reshape(MT, 2, 8, KS, 2, 4, 2).permute(0, 3, 2, 5, 4, 1, 6)
    return x.contiguous().view(torch.int32).reshape(MT, KS, 32, 4)


def unpack_bf16_a_fragments(f: torch.Tensor) -> torch.Tensor:
    """The weight [16 * ceil(K/16), 16 * ceil(M/16)] in float32 (padding
    included) from fragments made by :func:`bf16_a_fragments`."""
    MT, KS = f.shape[:2]
    bits = f.contiguous().view(torch.int16).reshape(MT, KS, 8, 4, 2, 2, 2)
    a = bits.permute(0, 5, 2, 1, 4, 3, 6).reshape(16 * MT, 16 * KS)
    return a.contiguous().view(torch.bfloat16).to(torch.float32).t()


def check_fragments(weights: Dict[str, torch.Tensor],
                    need: Iterable[str]) -> None:
    """Each ``<name>_frag`` or ``<name>_frag_bf16`` in ``need`` has the shape
    of :func:`tf32x3_fragments` of ``weights[<name>]``, each
    ``<name>_frag_k16`` that of :func:`bf16_b_fragments`."""
    for k in need:
        for suffix in (FRAG, FRAG_BF16, FRAG_K16):
            if not k.endswith(suffix):
                continue
            K, N = weights[k[:-len(suffix)]].shape
            want = ((N // 8, -(-K // 16), 32, 2) if suffix == FRAG_K16
                    else (N // 8, -(-K // 8), 32, 4))
            if weights[k].shape != want:
                raise ValueError(f"weight {k} {tuple(weights[k].shape)} is not "
                                 f"the fragments of a [{K}, {N}] weight")


def fragment_names(order: Sequence[str], bf16: bool,
                   bf16_suffix: str = FRAG_BF16) -> Tuple[str, ...]:
    """A C entry's pointer order with each fragment named for the
    precision: the bf16 entries read ``*_frag_bf16`` (or ``bf16_suffix``)
    where the float32 ones read ``*_frag``."""
    return tuple(k[:-len(FRAG)] + bf16_suffix if bf16 and k.endswith(FRAG)
                 else k for k in order)


def check_windows(Z: torch.Tensor, dtype=torch.float32) -> None:
    if Z.dtype != dtype or Z.dim() != 3 or not Z.is_contiguous():
        raise ValueError(f"Z must be a contiguous {dtype} [N, T, D] tensor, "
                         f"got {Z.dtype} {tuple(Z.shape)}")


def check_weights(weights: Dict[str, torch.Tensor], need: Iterable[str],
                  device: torch.device) -> None:
    need = list(need)
    missing = [k for k in need if k not in weights]
    if missing:
        raise ValueError(f"weights missing: {', '.join(missing)}")
    for k in need:
        w = weights[k]
        dtype = torch.int32 if k.endswith(FRAG_K16) else torch.float32
        if w.device != device or w.dtype != dtype or not w.is_contiguous():
            raise ValueError(f"weight {k} must be contiguous "
                             f"{str(dtype)[6:]} on {device}")


def pointer_array(weights: Dict[str, torch.Tensor], order: Sequence[str],
                  need: Iterable[str]):
    """``void*[len(order)]`` of the weights' device pointers, null where a
    name is not in ``need``."""
    need = set(need)
    return (ctypes.c_void_p * len(order))(
        *[weights[k].data_ptr() if k in need else None for k in order])


def dispatch_gate(name: str, Z: torch.Tensor, launch, reference, weights,
                  **kw):
    if Z.device.type == "cuda":
        return launch(weights, Z, **kw)
    if Z.device.type == "cpu":
        return reference(weights, Z, **kw)
    raise ValueError(f"{name}: unsupported device {Z.device}")
