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
MLP's two) on the tensor cores: in 3xTF32 in float32, reading the weights
as TF32 fragments that :func:`attention_params_to_kernel_weights` packs
once (:func:`tf32x3_fragments`); in bf16 its resident body runs every
product, the scores and P.V included, as ``mma.sync.m16n8k16`` bf16
products, reading the m16n8k16 B fragments of the bf16-rounded weights
(:func:`bf16_b_fragments`, 2 bytes a weight), and its long body one TF32
product a k-step of bf16-rounded operands. The plain version reads the
weights as given.

The softmax takes one of the JAX kernel's two forms (``stream``): the
packed form divides each row by its sum before P.V; the streaming form walks
the keys in blocks of 128 with a running max and denominator and divides
P.V by the denominator at the end. ``stream=None`` picks as the JAX kernel's
``auto_stream`` does (:func:`auto_stream`: streaming past 128 steps). The
two agree to float rounding in float32; in bf16 they round the
probabilities at other points.

The kernel has two bodies (:func:`plan`). The resident body keeps one
window's whole pass in a block's shared memory and takes a window whose
buffers fit there (:func:`shared_memory_bytes`: in float32 at H=128 up to
136 steps, at H=64 up to 208, at H=32 up to 268; in bf16, whose operands
are stored as bf16, further; Z up to 128, the JAX kernel's 128 lanes, did
not move them: mu's slot of the per-window vectors grew into the MSE's
reduction slots, which now sit over the dead pooled summary, and the
``_SMALL`` floats stay 512). The long body takes any longer window:
the stream and every head's q | k | v live in a device-memory slot of the
block, and shared memory holds a row tile and one key block. The kernel
source states its bound on the card and what its design does about it.
Computation is float32 with float32 accumulation; softmax runs over exactly
the T keys; the MSE divides by the real ``T * D``.

The MLP's width is the JAX kernel's ``mlp_ratio * H`` (``mlp_ratio``, 4 by
default; a multiple of 128, :func:`mlp_width`), a runtime argument of the
kernel. The weights come from a :class:`TemporalVAE` whose attention stacks
have that width: ``convert.vae_from_flax`` reads M from a flax tree's
``mlp_in`` kernel and builds ``AttentionStack(mlp_ratio=M / H)``, so a JAX
tree of any MLP width reaches :func:`attention_params_to_kernel_weights`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from shm_tpu_torch.models.attention import (
    HEAD_DIM, STACK_LN_EPS, flax_layer_norm, sinusoidal_positions,
)
from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.ops._build import count_launch, load_library, raise_on_error
from shm_tpu_torch.ops._gate import (  # noqa: F401  (the fragment helpers re-exported)
    FRAG_BF16, FRAG_K16, add_fragments, bf16_b_fragments, bf16_round, check_fragments,
    check_weights, check_windows, dispatch_gate, f32, fragment_names,
    gate_dtypes, plain_products, pointer_array, tf32_round, tf32x3_fragments,
    unpack_bf16_b_fragments, unpack_fragments,
)

_H_MAX, _D_MAX, _Z_MAX, _L_MAX = 128, 128, 128, 2
_MODEL_LN_EPS = 1e-5         # the model-level norm on the pooled summary
# the kernel's tiling (csrc/fused_attention.cu): rows padded to _TM, q/k/v
# rows to HEAD_DIM + 4, _QC query rows a score chunk, _SMALL scratch floats,
# _MLP_CHUNK columns of the MLP's hidden layer at once; the long body's row
# tiles and query chunks of _QL rows
_TM, _QC, _SMALL, _QL = 8, 32, 512, 128
_MLP_CHUNK = 128             # the MLP's width M = mlp_ratio * H is a
                             # multiple of it (the JAX kernel's rule)
SMEM_LIMIT = 232_448         # bytes of shared memory one block may use (H100)
KEY_BLOCK = 128              # keys a block of the streaming softmax (the JAX
                             # kernel's lane width; its block edges set where
                             # the running max rescales)

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


def attention_params_to_kernel_weights(
        vae: TemporalVAE, dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict from a ``cell="attention"``
    :class:`TemporalVAE`, on its device. Matmul weights are [in, out], biases
    and norm scales 1-D, every tensor contiguous float32. ``*_wqkv`` [H, 3H]
    and ``*_bqkv`` [3H] are packed per head (columns ``h*96 .. h*96+95`` hold
    q | k | v of head h), with the query's ``1/sqrt(head_dim)`` folded into
    its weight AND its bias: the model scales the biased projection, so the
    folding is exact. Each of the four products' weights (``*_wqkv``,
    ``*_wo``, ``*_w1``, ``*_w2``) also comes as the fragments of the
    precision ``dtype``: ``*_frag``, its :func:`tf32x3_fragments`, which the
    float32 kernel reads, or for ``torch.bfloat16`` the fragments of the
    weight rounded to bf16 (the query's scale folded in first, as the TPU
    kernel folds it before its bf16 cast) in both layouts the bf16 kernel
    reads: ``*_frag_k16``, its m16n8k16 B fragments (:func:`bf16_b_fragments`,
    int32, 2 bytes a weight), for the resident body, and ``*_frag_bf16``
    (:func:`tf32x3_fragments` of the rounded weight) for the long body."""
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
                name = f"{p}{l}_{k}"
                add_fragments(w, name, dtype)
                if dtype == torch.bfloat16:
                    w[name + FRAG_K16] = bf16_b_fragments(w[name])
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


def auto_stream(T: int) -> bool:
    """The softmax form ``stream=None`` selects for a window of T steps, as
    the JAX kernel's ``auto_stream(round_up(T, 128))`` does: the streaming
    form when the keys span more than one block of :data:`KEY_BLOCK`, the
    packed form otherwise."""
    return T > KEY_BLOCK


def softmax_form(stream: Optional[bool], T: int) -> bool:
    """``stream`` resolved for a window of T steps (``True``: the streaming
    form); anything but ``None``, ``True`` or ``False`` raises."""
    if stream is None:
        return auto_stream(T)
    if not isinstance(stream, bool):
        raise ValueError(f"stream must be None, True or False, got {stream!r}")
    return stream


def attend(q, k, v, stream: bool, rnd):
    """Each head's attention output [..., T, hd] over the T keys: the packed
    softmax (the row divided by its sum, then P.V) or the streaming one (the
    keys in blocks of :data:`KEY_BLOCK`, a running max m from -1e30 and
    denominator l: ``m_new = max(m, rowmax(s))``, ``alpha = exp(m - m_new)``,
    ``p = exp(s - m_new)``, ``l = l alpha + sum p``, ``o = o alpha + p V``,
    and ``o / l`` at the end). ``rnd`` rounds the probabilities where they
    enter P.V; l sums them unrounded."""
    if not stream:
        return rnd(torch.softmax(q @ k.transpose(-1, -2), dim=-1)) @ v
    m = q.new_full(q.shape[:-1] + (1,), -1e30)
    l = q.new_zeros(q.shape[:-1] + (1,))
    o = torch.zeros_like(q)
    for j0 in range(0, k.shape[-2], KEY_BLOCK):
        s = q @ k[..., j0:j0 + KEY_BLOCK, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + rnd(p) @ v[..., j0:j0 + KEY_BLOCK, :]
        m = m_new
    return o / l


def mlp_width(weights: Dict[str, torch.Tensor], num_layers: int,
              mlp_ratio: int) -> int:
    """The MLP's width M = ``mlp_ratio * H`` of a kernel weight dict, checked
    as the JAX kernel checks it (``ValueError`` with its words when M is not
    a multiple of 128) and against every layer's ``*_w1`` [H, M], ``*_b1``
    [M] and ``*_w2`` [M, H] of both stacks."""
    H = weights["mu_w"].shape[0]
    if (mlp_ratio * H) % _MLP_CHUNK:
        raise ValueError(f"mlp width {mlp_ratio}*{H} must be a multiple of 128")
    M = mlp_ratio * H
    for p in ("enc", "dec"):
        for l in range(num_layers):
            k = f"{p}{l}"
            got = (tuple(weights[f"{k}_w1"].shape), tuple(weights[f"{k}_b1"].shape),
                   tuple(weights[f"{k}_w2"].shape))
            if got != ((H, M), (M,), (M, H)):
                raise ValueError(
                    f"{k}'s MLP weights w1 {got[0]}, b1 {got[1]}, w2 {got[2]} "
                    f"are not an MLP of width mlp_ratio*H = {mlp_ratio}*{H} = "
                    f"{M} (w1 [{H}, {M}], b1 [{M}], w2 [{M}, {H}])")
    return M


def fused_attention_gate_reference(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
    dtype: torch.dtype = torch.float32, io_dtype: Optional[torch.dtype] = None,
    stream: Optional[bool] = None, mlp_ratio: int = 4,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: (mse [N], resid [N, T, D] | None).

    ``stream`` picks the softmax's form as the JAX kernel's does (``None``:
    :func:`auto_stream`; see :func:`attend`). ``dtype=torch.bfloat16``
    rounds where the JAX kernel with ``dtype=bf16`` rounds
    (``shm_tpu/ops/fused_attention.py:206-212``, ``:252-353``): both
    operands of every product, summed in float32 (the weight products, the
    scores, the probabilities and V of P.V); the residual stream s, the
    packed q | k | v and the attention output o as they are stored.
    LayerNorm, softmax and the pooled summary stay float32. The packed form
    rounds the probabilities after the softmax's division, the streaming
    form before it (its p, whose float32 sum is the denominator), as the two
    forms of the JAX kernel do. ``io_dtype`` as in
    ``fused_vae_gate_reference``. ``mlp_ratio``: the JAX kernel's, the MLP's
    width M = ``mlp_ratio * H`` (:func:`mlp_width` checks it)."""
    N, T, D = Z.shape
    H = weights["mu_w"].shape[0]
    mlp_width(weights, num_layers, mlp_ratio)
    heads = H // HEAD_DIM
    bf16, io = gate_dtypes(Z, dtype, io_dtype)
    streaming = softmax_form(stream, T)
    x = Z.to(io).to(torch.float32)          # the window tile as read
    rnd = bf16_round if bf16 else (lambda t: t)
    pos = sinusoidal_positions(T, H, Z.device)
    w = weights
    mm = plain_products(w, [k for k in w if k.endswith(
        ("_wqkv", "_wo", "_w1", "_w2", "_in_w")) or k in (
        "mu_w", "z2h_w", "out_w")], bf16)

    def block(s, p):
        nrm = flax_layer_norm(s, w[f"{p}_ln1_s"], w[f"{p}_ln1_b"], STACK_LN_EPS)
        qkv = rnd(mm(nrm, f"{p}_wqkv") + w[f"{p}_bqkv"]).view(
            N, T, heads, 3, HEAD_DIM)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))  # [N,h,T,hd]
        o = rnd(attend(q, k, v, streaming, rnd).transpose(1, 2).reshape(N, T, H))
        s = rnd(s + (mm(o, f"{p}_wo") + w[f"{p}_bo"]))
        nrm = flax_layer_norm(s, w[f"{p}_ln2_s"], w[f"{p}_ln2_b"], STACK_LN_EPS)
        h1 = F.gelu(mm(nrm, f"{p}_w1") + w[f"{p}_b1"], approximate="tanh")
        return rnd(s + (mm(h1, f"{p}_w2") + w[f"{p}_b2"]))

    def stack(tok, p):
        s = rnd(tok + pos)
        for l in range(num_layers):
            s = block(s, f"{p}{l}")
        return flax_layer_norm(s, w[f"{p}_fn_s"], w[f"{p}_fn_b"], STACK_LN_EPS)

    pooled = stack(mm(x, "enc_in_w") + w["enc_in_b"], "enc").mean(dim=1)
    if use_layernorm:
        pooled = flax_layer_norm(pooled, w["ln_scale"], w["ln_bias"],
                                 _MODEL_LN_EPS)
    mu = mm(pooled, "mu_w") + w["mu_b"]
    h0 = torch.tanh(mm(mu, "z2h_w") + w["z2h_b"])
    tok0 = mm(h0, "dec_in_w") + w["dec_in_b"]                   # [N, H], once
    out = stack(tok0[:, None, :], "dec")
    resid = (x - (mm(out, "out_w") + w["out_b"])) ** 2
    mse = resid.sum(dim=(1, 2)) / (T * D)
    return mse, (resid.to(io) if with_residual else None)


def _bld(w: int) -> int:
    """Row stride (bf16 elements) of the bf16 resident body's buffers w
    columns wide (``bld`` in the source)."""
    return w + 8


def _bf16_bytes(T: int, H: int, group: int) -> int:
    rows, keys = -(-T // _TM) * _TM, -(-T // 16) * 16
    attn = 3 * keys * _bld(group * HEAD_DIM)
    return (4 * (rows * (H + 4) + _SMALL)
            + 2 * (rows * _bld(H) + max(attn, rows * _bld(_MLP_CHUNK))))


def bf16_head_group(T: int, H: int) -> int:
    """Heads the bf16 resident body takes at once at (T, H): the most (all,
    2 or 1) whose buffers fit a block's shared memory, 0 where none does
    (``bf16_group`` in the source)."""
    for g in (4, 2, 1):
        if g <= H // HEAD_DIM and _bf16_bytes(T, H, g) <= SMEM_LIMIT:
            return g
    return 0


def shared_memory_bytes(T: int, H: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory the resident body of precision ``dtype`` needs for one
    window of T steps at width H (the layout is the kernel's own,
    ``shm_fused_attention_smem_bytes`` / ``..._bf16`` in the source).
    float32: the stream and its normalised copy [rows, H+4] each, scratch
    vectors, and one area that holds a head's q | k | v [rows, 36] each plus
    a [32, T] score chunk, or a column chunk of the MLP's hidden layer.
    bf16: the stream [rows, H+4] float32, its normalised copy [rows, H+8]
    bf16, scratch vectors, and one bf16 area that holds the q | k | v of a
    group of :func:`bf16_head_group` heads [3, T rounded up to 16, 32 heads
    + 8], or a column chunk of the MLP's hidden layer [rows, 136] (one head
    a group where no group fits). :func:`plan` holds it against the card's
    limit."""
    if dtype == torch.bfloat16:
        return _bf16_bytes(T, H, bf16_head_group(T, H) or 1)
    rows = -(-T // _TM) * _TM
    attn = 3 * rows * (HEAD_DIM + 4) + _QC * (-(-T // 4) * 4)
    return 4 * (2 * rows * (H + 4) + _SMALL
                + max(attn, rows * (_MLP_CHUNK + 4)))


def long_shared_memory_bytes(H: int) -> int:
    """Shared memory a block of the long body needs at width H, whatever T
    (``shm_fused_attention_long_smem_bytes`` in the source): a tile of 128
    rows of the stream [128, H+4], then either a head's query chunk [128,
    36], one key block of k and of v [128, 36] each, its scores [128, 132]
    and three [128] row vectors, or the chunk's normalised rows and a column
    chunk of the MLP's hidden layer [128, H+4] and [128, 132]; the scratch
    vectors."""
    hdp = HEAD_DIM + 4
    attn = (_QL * hdp + 2 * KEY_BLOCK * hdp + _QL * (KEY_BLOCK + 4)
            + 3 * _QL)
    mlp = _QL * (H + 4) + _QL * (_MLP_CHUNK + 4)
    return 4 * (_QL * (H + 4) + max(attn, mlp) + _SMALL)


def slot_floats(T: int, H: int) -> int:
    """Floats of device memory one block of the long body keeps for the
    window it runs (``shm_fused_attention_slot_floats`` in the source): the
    stream [Tp, H] and every head's q | k | v [heads, 3, Tp, 32], Tp = T
    padded to 8 rows."""
    return 4 * (-(-T // _TM) * _TM) * H


class Plan(NamedTuple):
    body: str             # "resident" or "long"
    shared_bytes: int     # dynamic shared memory a block
    slot_floats: int      # device memory a block keeps (floats; 0: resident)


def plan(T: int, H: int, dtype: torch.dtype = torch.float32) -> Plan:
    """Which body of the kernel's ``dtype`` instance runs a window of T steps
    at width H: the resident body while the window's buffers fit a block's
    shared memory (:func:`shared_memory_bytes` of that precision), the long
    body past that, whatever T."""
    nbytes = shared_memory_bytes(T, H, dtype)
    if nbytes <= SMEM_LIMIT:
        return Plan("resident", nbytes, 0)
    return Plan("long", long_shared_memory_bytes(H), slot_floats(T, H))


def _check(weights, Z, num_layers, use_layernorm, bf16=False,
           io=torch.float32, mlp_ratio=4, bf16_suffix=FRAG_K16):
    """The weight names a launch reads (the bf16 body's fragments named by
    ``bf16_suffix``: the resident body's by default), H and Z; anything the
    kernel does not take raises ``ValueError``."""
    check_windows(Z, io)
    if num_layers not in (1, 2):
        raise ValueError("the fused attention kernel supports 1- or 2-layer "
                         "presets")
    H, Zd = weights["mu_w"].shape
    T, D = Z.shape[1:]
    if T < 1:
        raise ValueError("the fused attention kernel needs windows of T >= 1 "
                         "steps")
    if H % HEAD_DIM or H > _H_MAX or D > _D_MAX or Zd > _Z_MAX:
        raise ValueError(f"unsupported shape for the fused attention kernel: "
                         f"H={H} (a multiple of {HEAD_DIM} up to {_H_MAX}), "
                         f"D={D} (<= {_D_MAX}), Z={Zd} (<= {_Z_MAX})")
    if weights["enc_in_w"].shape != (D, H):
        raise ValueError(f"enc_in_w {tuple(weights['enc_in_w'].shape)} does "
                         f"not match D={D}, H={H}")
    if weights["enc0_wqkv"].shape != (H, 3 * H):
        raise ValueError("the fused attention kernel assumes heads of "
                         f"{HEAD_DIM} columns")
    need = [k for k in fragment_names(_WEIGHT_ORDER, bf16, bf16_suffix)
            if not (k[3:4].isdigit() and int(k[3]) >= num_layers)
            and (use_layernorm or not k.startswith("ln_"))]
    check_weights(weights, need, Z.device)
    mlp_width(weights, num_layers, mlp_ratio)
    check_fragments(weights, need)
    return need, H, Zd


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C entry declared (built at first
    use, never at import)."""
    lib = load_library("fused_attention")
    # x pos resid mse w, n_w N T D H M Z L use_ln with_resid streaming body,
    # scratch, slots, [io_bf16,] cuda stream
    head = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p,
                                                          ctypes.c_int]
    for name, extra in (("f32", []), ("bf16", [ctypes.c_int])):
        fn = getattr(lib, f"shm_fused_attention_gate_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = head + extra + [ctypes.c_void_p]
    for name, n in (("smem_bytes", 2), ("smem_bytes_bf16", 2),
                    ("long_smem_bytes", 1), ("slot_floats", 2)):
        fn = getattr(lib, f"shm_fused_attention_{name}")
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int] * n
    lib.shm_fused_attention_info.restype = ctypes.c_int
    lib.shm_fused_attention_info.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.shm_tf32_round.restype = ctypes.c_int
    lib.shm_tf32_round.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    return lib


_BODIES = ("resident", "long")


def kernel_info(T: int, H: int, body: Optional[str] = None,
                dtype: torch.dtype = torch.float32) -> dict:
    """How the card takes the kernel's ``dtype`` instance (packed form,
    float32 io) for a window of T steps at width H, in the body
    :func:`plan` picks (or ``body``): registers and local-memory (spill)
    bytes a thread, threads and dynamic shared bytes a block, blocks an SM
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    bf16 = dtype == torch.bfloat16
    body = body or plan(T, H, dtype).body
    lib = _library()
    out = (ctypes.c_int * 5)()
    raise_on_error(lib, lib.shm_fused_attention_info(T, H, _BODIES.index(body),
                                                     int(bf16), out),
                   "fused_attention_gate info")
    return dict(zip(("registers", "spill_bytes", "threads", "shared_bytes",
                     "blocks_per_sm"), out))


@functools.lru_cache(maxsize=8)
def _long_slots(H: int, device: torch.device, dtype: torch.dtype) -> int:
    """Blocks of the long body the card runs at once (each keeps one
    window's slot of device memory): its blocks an SM times the SMs."""
    with torch.cuda.device(device):
        per_sm = kernel_info(0, H, "long", dtype)["blocks_per_sm"]
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


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


def _launch(weights, Z, num_layers, use_layernorm, with_residual, dtype,
            io_dtype, stream=None, mlp_ratio=4, body=None):
    """Launch the kernel on CUDA tensors, in the body :func:`plan` picks or
    in ``body`` (``"resident"`` or ``"long"``: the long body at a window the
    resident one takes, so that the two can be held against each other; the
    resident body past its shared memory raises ``ValueError``)."""
    bf16, io = gate_dtypes(Z, dtype, io_dtype)
    streaming = softmax_form(stream, Z.shape[1])
    if Z.device.type != "cuda":
        raise ValueError(f"the fused attention kernel launches on CUDA "
                         f"tensors, got one on {Z.device}")
    Z = Z.to(io)                        # a bf16 io: the card rounds once
    check_windows(Z, io)                # plan's T, H before _check's names
    check_weights(weights, ["mu_w"], Z.device)
    T, H = Z.shape[1], weights["mu_w"].shape[0]
    pl = plan(T, H, dtype)
    body = body or pl.body
    if body not in _BODIES:
        raise ValueError(f"body must be one of {_BODIES}, got {body!r}")
    # the bf16 resident body reads the m16n8k16 fragments, the long body TF32
    suffix = FRAG_K16 if body == "resident" else FRAG_BF16
    need, H, Zd = _check(weights, Z, num_layers, use_layernorm, bf16, io,
                         mlp_ratio, suffix)
    if body == "resident" and pl.body != "resident":
        raise ValueError(f"the resident body does not take T={T} at H={H}: "
                         f"its buffers pass the {SMEM_LIMIT} bytes of shared "
                         f"memory a block can use")
    M = mlp_ratio * H
    N, T, D = Z.shape
    mse = torch.empty(N, device=Z.device, dtype=torch.float32)
    resid = torch.empty_like(Z) if with_residual else None
    if N == 0:
        return mse, resid
    lib = _library()
    order = fragment_names(_WEIGHT_ORDER, bf16, suffix)
    ptrs = pointer_array(weights, order, need)
    pos = _positions(T, H, Z.device)
    slots, scratch = 0, None
    if body == "long":
        slots = min(N, _long_slots(H, Z.device, dtype))
        scratch = torch.empty(slots * slot_floats(T, H), device=Z.device,
                              dtype=torch.float32)
    args = (Z.data_ptr(), pos.data_ptr(),
            resid.data_ptr() if with_residual else None, mse.data_ptr(), ptrs,
            len(order), N, T, D, H, M, Zd, num_layers, int(use_layernorm),
            int(with_residual), int(streaming), _BODIES.index(body),
            scratch.data_ptr() if scratch is not None else None, slots)
    with torch.cuda.device(Z.device):
        cuda_stream = torch.cuda.current_stream(Z.device).cuda_stream
        if bf16:
            err = lib.shm_fused_attention_gate_bf16(
                *args, int(io == torch.bfloat16), cuda_stream)
        else:
            err = lib.shm_fused_attention_gate_f32(*args, cuda_stream)
    raise_on_error(lib, err, "fused_attention_gate")
    count_launch(fused_attention_gate, "bf16_launches" if bf16 else "launches")
    if streaming:
        count_launch(fused_attention_gate, "stream_launches")
    if body == "long":
        count_launch(fused_attention_gate, "long_launches")
    if M != 4 * H:
        count_launch(fused_attention_gate, "mlp_launches")
    return mse, resid


def fused_attention_gate(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
    dtype: torch.dtype = torch.float32, io_dtype: Optional[torch.dtype] = None,
    stream: Optional[bool] = None, mlp_ratio: int = 4,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused deterministic attention-VAE pass: (mse [N], resid [N, T, D] | None).

    ``weights`` comes from :func:`attention_params_to_kernel_weights`. A CUDA
    tensor runs the kernel, in the body :func:`plan` picks for its shape; a
    CPU tensor runs the plain version. ``stream`` is the JAX kernel's
    softmax form (``None``: :func:`auto_stream`); ``dtype`` / ``io_dtype``
    as the JAX kernel's (the plain version says where bf16 rounds):
    ``dtype=torch.bfloat16`` launches the kernel's bf16 instance, counted in
    ``fused_attention_gate.bf16_launches``. ``mlp_ratio`` is the JAX
    kernel's: the MLP's width M = ``mlp_ratio * H``, a multiple of 128, which
    the weights' ``*_w1`` / ``*_b1`` / ``*_w2`` must have (:func:`mlp_width`);
    a launch at M other than 4H is also counted in
    ``fused_attention_gate.mlp_launches``.
    """
    return dispatch_gate("fused_attention_gate", Z, _launch,
                         fused_attention_gate_reference, weights,
                         num_layers=num_layers, use_layernorm=use_layernorm,
                         with_residual=with_residual, dtype=dtype,
                         io_dtype=io_dtype, stream=stream, mlp_ratio=mlp_ratio)


# kernel launches so far: of the float32 and of the bf16 instance (every
# body and form), and of those, the streaming form's, the long body's and
# those at an MLP width other than 4H; callers reset them to 0 to count one
# run's launches
fused_attention_gate.launches = 0
fused_attention_gate.bf16_launches = 0
fused_attention_gate.stream_launches = 0
fused_attention_gate.long_launches = 0
fused_attention_gate.mlp_launches = 0


__all__ = ["fused_attention_gate", "fused_attention_gate_reference",
           "attention_params_to_kernel_weights",
           "auto_stream", "softmax_form", "attend", "plan", "Plan", "KEY_BLOCK",
           "mlp_width", "bf16_head_group",
           "shared_memory_bytes", "long_shared_memory_bytes", "slot_floats",
           "kernel_info", "tf32_round", "tf32_round_on_card",
           "tf32x3_fragments", "unpack_fragments", "bf16_b_fragments",
           "unpack_bf16_b_fragments"]
