"""Readings of the bf16 gates that ``chip_smoke.py`` phase 17 rests on.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/bf16_readings.py jax
    PYTHONPATH=. python tests/bf16_readings.py model [committed] [CELL ...]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/bf16_readings.py rounding

``jax``: the JAX package's three gate kernels (``shm_tpu/ops/fused_*.py``,
interpret mode, ``emulate=True``) on the 3,636 committed 4DOF test windows
through each family's committed root (``data/4dof``, ``data/4dof_mingru``,
``data/4dof_attention``), at ``dtype=bf16`` with the io the JAX
``HybridScorer`` serves (bf16 for attention, float32 for the other two)
and at float32. One ``JAX`` line per family: the largest and the mean
relative mse difference of bf16 from float32, and the gate decisions
(``mse > threshold`` of the root) that differ. The per-window mse of both
are written to ``tests/bf16_readings.npz`` (``<cell>_bf16``,
``<cell>_f32``), which phase 17 reads: its bar on the port's bf16 scorer
against its float32 one is twice these readings, and it prints the JAX
reading of any window whose gate flips.

``model``: a CPU model of each bf16 instance's sums in the kernel's own
order, against the plain bf16 version: in rows 1 and 6 every weight
product's bf16 operands in k-steps of 8 chained through the mma's
truncating float32 sum (``tc_product(..., "one_term")`` of
``tests/test_torch_vae_gate_tf32.py``), the accumulator starting where the
kernel starts it: from the bias, and through the input's product and then
h's; in row 7 every product (the weight products, the scores and P.V) in
k-steps of 16, each pair chained from zero and added to the float32 sum
(:func:`_tc16`), the bias added after. CELL names the families to model
(all by default). On random weights and windows at
phase 2's shapes (each with float32 and bf16 io; the windows are the
first of phase 17's, made from the same seeds), and on the 3,636
committed test windows through each committed root (``model committed``:
those alone), as phase 17 holds them. One ``MODEL`` line a case: the
largest and mean relative mse difference and the largest difference of
the reconstructions |x - y| (the square roots of the residuals), and the
gap a float32 instance would show: the plain float32 version against the
plain bf16 one on the window as read. ``chip_smoke.py``'s
``BF16_GATE_TOL`` and ``BF16_COMMITTED_TOL`` rest on these lines.

``rounding``: what the attention gate's bars against the JAX kernel in
``tests/test_torch_gate_bf16.py`` can resolve (one ``ROUNDING`` line a
case, see :func:`rounding_readings`).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
ROOTS = {"lstm": "data/4dof", "min_gru": "data/4dof_mingru",
         "attention": "data/4dof_attention"}
OUT = ROOT / "tests" / "bf16_readings.npz"
# phase 2's shapes: name, N, T, D, Z, H, L, LayerNorm
SHAPES = (("4dof", 150, 100, 12, 16, 128, 2, True),
          ("openLAB", 100, 200, 3, 8, 64, 1, True),
          ("1dof", 150, 80, 12, 5, 32, 2, False))
MINGRU_EXTRA = (("3-layer", 100, 60, 12, 16, 64, 3, True),)


def _normalized(root: Path, W: np.ndarray):
    from shm_tpu_torch.cli.stage4dof import Paths, _load_stats
    from shm_tpu_torch.data.windows import normalize_windows

    mean, std = _load_stats(Paths(str(root)))
    return normalize_windows(torch.from_numpy(W), torch.as_tensor(mean),
                             torch.as_tensor(std)).contiguous()


def jax_readings() -> None:
    import jax.numpy as jnp

    from shm_tpu.cli.stage4dof import Paths as JaxPaths
    from shm_tpu.cli.stage4dof import _load_vae as jax_load_vae
    from shm_tpu.config import Stage4DofConfig as JaxConfig
    from shm_tpu.ops import (fused_attention_gate, fused_mingru_gate,
                             fused_vae_gate)
    from shm_tpu_torch.tools.workload import load_trained_workload
    from shm_tpu_torch.utils.io import load_json

    gates = {"lstm": fused_vae_gate, "min_gru": fused_mingru_gate,
             "attention": fused_attention_gate}
    W = load_trained_workload(ROOT / ROOTS["lstm"]).W      # 3,636 windows
    out = {}
    for cell, rel in ROOTS.items():
        root = ROOT / rel
        Z = jnp.asarray(_normalized(root, W).numpy())
        vae, params = jax_load_vae(JaxPaths(str(root)), JaxConfig())
        assert vae.cell == cell
        kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm,
                  interpret=True, with_residual=False)
        if cell == "attention":
            kw["batch_tile"] = 16
        t0 = time.perf_counter()
        bf16, _ = gates[cell](params, Z, dtype=jnp.bfloat16, emulate=True,
                              io_dtype=jnp.bfloat16 if cell == "attention"
                              else None, **kw)
        f32, _ = gates[cell](params, Z, dtype=jnp.float32, **kw)
        bf16 = np.asarray(bf16, np.float64)
        f32 = np.asarray(f32, np.float64)
        thr = float(load_json(root / "processed" / "vae_threshold.json")
                    ["threshold"])
        r = np.abs(bf16 - f32) / f32
        flips = np.flatnonzero((bf16 > thr) != (f32 > thr))
        print(f"JAX {cell}: {len(W)} windows, bf16 against float32 mse: "
              f"max rel {r.max():.4e} mean rel {r.mean():.4e}; gate flips "
              f"{len(flips)} {flips.tolist()}; "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
        out[f"{cell}_bf16"], out[f"{cell}_f32"] = bf16, f32
    np.savez(OUT, **out)
    print(f"wrote {OUT.relative_to(ROOT)}")


def _chain(acc: torch.Tensor, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``acc + bf16(a) @ w`` (``w`` rounded already) as the bf16 instances of
    rows 1 and 6 sum it: one mma a k-step of 8 into the float32 accumulator,
    truncated after each (``tc_product(..., "one_term")`` of
    ``tests/test_torch_vae_gate_tf32.py``). ``acc`` is what the accumulator
    holds before: the bias, or the bias and an earlier product."""
    from shm_tpu_torch.ops._gate import bf16_round
    from test_torch_vae_gate_tf32 import tc_product

    a = bf16_round(a)
    cols = w.shape[1]
    a2 = a.reshape(-1, a.shape[-1])
    acc2 = acc.expand(*a.shape[:-1], cols).reshape(-1, cols)
    # in row chunks: the model holds every k-step's float64 block at once
    out = torch.cat([tc_product(c0, c, w, "one_term") for c0, c in
                     zip(acc2.split(8192), a2.split(8192))])
    return out.reshape(*a.shape[:-1], cols)


def _heads(a, w, b):
    """A head on the FMA pipes: bf16 operands, float32 sum, the bias."""
    from shm_tpu_torch.ops._gate import bf16_round

    return bf16_round(a) @ w + b


def _lstm_model(w, Z, num_layers, use_layernorm, io):
    """Row 1's bf16 instance (``fused_vae.cu``, sum ``TC_BF16``): each gate
    accumulator starts from the bias, takes the input's product, then h's,
    every k-step truncated; the decoder's layer 0 from its constant
    projection. The heads, the cell and LayerNorm as the plain version."""
    from shm_tpu_torch.ops._gate import bf16_round

    N, T, D = Z.shape
    H = w["enc0_whh"].shape[0]
    x = Z.to(io).to(torch.float32)
    wr = {k: bf16_round(v) for k, v in w.items()
          if k.endswith(("_wih", "_whh")) or k in ("mu_w", "z2h_w", "out_w")}
    mm = lambda acc, a, k: _chain(acc, a, wr[k])
    bias = lambda k: w[k].expand(N, -1)

    def step(c, g):
        i, f, gg, o = g.split(H, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c), c

    zeros = x.new_zeros(N, H)
    hs, cs = [zeros] * num_layers, [zeros] * num_layers
    for t in range(T):
        inp = x[:, t]
        for l in range(num_layers):
            g = mm(mm(bias(f"enc{l}_b"), inp, f"enc{l}_wih"), hs[l],
                   f"enc{l}_whh")
            hs[l], cs[l] = step(cs[l], g)
            inp = hs[l]
    h = hs[-1]
    if use_layernorm:
        h = F.layer_norm(h, (H,), w["ln_scale"], w["ln_bias"], eps=1e-5)
    mu = _heads(h, wr["mu_w"], w["mu_b"])
    dec_in = torch.tanh(_heads(mu, wr["z2h_w"], w["z2h_b"]))
    xp = mm(bias("dec0_b"), dec_in, "dec0_wih")
    hs, cs = [zeros] * num_layers, [zeros] * num_layers
    resid = []
    for t in range(T):
        hs[0], cs[0] = step(cs[0], mm(xp, hs[0], "dec0_whh"))
        for l in range(1, num_layers):
            g = mm(mm(bias(f"dec{l}_b"), hs[l - 1], f"dec{l}_wih"), hs[l],
                   f"dec{l}_whh")
            hs[l], cs[l] = step(cs[l], g)
        resid.append((x[:, t] - _heads(hs[-1], wr["out_w"], w["out_b"])) ** 2)
    resid = torch.stack(resid, dim=1)
    return resid.sum(dim=(1, 2)) / (T * D), resid.to(io)


def _mingru_model(w, Z, num_layers, use_layernorm, io):
    """Row 6's bf16 instance (``fused_mingru.cu``, sum ``TC_BF16``): each
    layer's gate accumulator starts from the bias, then the product, every
    k-step truncated; the stores rounded as the plain version rounds them."""
    from shm_tpu_torch.ops._gate import bf16_round
    from shm_tpu_torch.ops.fused_mingru import _sweep

    N, T, D = Z.shape
    H = w["mu_w"].shape[0]
    x = Z.to(io).to(torch.float32)
    wr = {k: bf16_round(v) for k, v in w.items()
          if k.endswith("_wih") or k in ("mu_w", "z2h_w", "out_w")}

    def layer(prefix, l, inp):
        g = _chain(w[f"{prefix}{l}_b"], inp, wr[f"{prefix}{l}_wih"])
        z, hc = torch.sigmoid(g[..., :H]), g[..., H:]
        if prefix == "enc" or l > 0:
            z, hc = bf16_round(z), bf16_round(hc)
        return _sweep(z, hc, T)

    seq = x
    for l in range(num_layers):
        seq = layer("enc", l, seq)
    h = seq[:, -1]
    if use_layernorm:
        h = F.layer_norm(h, (H,), w["ln_scale"], w["ln_bias"], eps=1e-5)
    mu = _heads(h, wr["mu_w"], w["mu_b"])
    seq = torch.tanh(_heads(mu, wr["z2h_w"], w["z2h_b"]))
    for l in range(num_layers):
        seq = layer("dec", l, seq)
    resid = (x - bf16_round(_heads(seq, wr["out_w"], w["out_b"]))) ** 2
    return resid.sum(dim=(1, 2)) / (T * D), resid.to(io)


def _tc16(a: torch.Tensor, b: torch.Tensor, acc=None) -> torch.Tensor:
    """``a @ b`` ([..., R, K] @ [..., K, C], bf16 values held in float32) as
    row 7's bf16 resident body sums a product on ``mma.sync.m16n8k16``:
    k-steps of 16 (K padded with zeros), each step's 16 products exact and
    its sum truncated toward zero to float32 into the accumulator. Each
    pair of k-steps is chained from zero and that partial added to the
    float32 sum to nearest (``tc_bf16_product(..., "split")`` of
    ``tests/test_torch_probe_bf16_sums.py``, batched), the sum starting
    from ``acc`` where given (P.V of the streaming form: its rescaled o)."""
    from test_torch_vae_gate_tf32 import _truncate

    K = a.shape[-1]
    KS = -(-K // 16)
    a64 = F.pad(a, (0, 16 * KS - K)).double()
    b64 = F.pad(b, (0, 0, 0, 16 * KS - K)).double()
    block = lambda ks: a64[..., 16 * ks:16 * ks + 16] @ b64[..., 16 * ks:16 * ks + 16, :]
    for kp in range(0, KS, 2):
        part = _truncate(block(kp))
        if kp + 1 < KS:
            part = _truncate(part + block(kp + 1))
        acc = part.float() if acc is None else acc + part.float()
    return acc


def _attention_model(w, Z, num_layers, use_layernorm, io):
    """Row 7's bf16 resident body (``fused_attention.cu``,
    ``fused_attention_bf16_kernel``): the four weight products, the scores
    and P.V through :func:`_tc16` (the products from zero, the bias after;
    the streaming form's P.V added to its rescaled o),
    the MLP's second product a chunk of 128 of M at a time, each chunk's
    sum added to the stream in turn; the heads, softmax, LayerNorm and the
    stores as the plain version. Run in chunks of 128 windows (the float64
    blocks of the scores)."""
    from shm_tpu_torch.ops import fused_attention as fa
    from shm_tpu_torch.ops import fused_attention_gate_reference
    from shm_tpu_torch.ops._gate import bf16_round

    chunk = fa._MLP_CHUNK

    def products(weights, names, bf16):
        """plain_products with the four weight products on the tensor cores;
        the heads stay the plain version's (the kernel's FMA sums)."""
        plain = plain_products(weights, names, bf16)
        wr = {k: bf16_round(weights[k]) for k in names}

        def mm(a, k):
            if not k.endswith(("_wqkv", "_wo", "_w1", "_w2")):
                return plain(a, k)
            a = bf16_round(a)
            if k.endswith("_w2"):            # W2 [M, H], a chunk at a time
                out = None
                for c0 in range(0, wr[k].shape[0], chunk):
                    part = _tc16(a[..., c0:c0 + chunk], wr[k][c0:c0 + chunk])
                    out = part if out is None else out + part
                return out
            return _tc16(a, wr[k])
        return mm

    def attend(q, k, v, stream, rnd):
        if not stream:
            p = rnd(torch.softmax(_tc16(q, k.transpose(-1, -2)), dim=-1))
            return _tc16(p, v)
        m = q.new_full(q.shape[:-1] + (1,), -1e30)
        l = q.new_zeros(q.shape[:-1] + (1,))
        o = torch.zeros_like(q)
        for j0 in range(0, k.shape[-2], fa.KEY_BLOCK):
            s = _tc16(q, k[..., j0:j0 + fa.KEY_BLOCK, :].transpose(-1, -2))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = _tc16(rnd(p), v[..., j0:j0 + fa.KEY_BLOCK, :], acc=o * alpha)
            m = m_new
        return o / l

    plain_products, plain_attend = fa.plain_products, fa.attend
    fa.plain_products, fa.attend = products, attend
    try:
        outs = [fused_attention_gate_reference(
            w, Zc, num_layers=num_layers, use_layernorm=use_layernorm,
            dtype=torch.bfloat16, io_dtype=io) for Zc in Z.split(128)]
    finally:
        fa.plain_products, fa.attend = plain_products, plain_attend
    return torch.cat([m for m, _ in outs]), torch.cat([r for _, r in outs])


MODELS = {"lstm": _lstm_model, "min_gru": _mingru_model,
          "attention": _attention_model}


def _model_case(cell: str, name: str, w, Z, L: int, ln: bool, io) -> None:
    """One ``MODEL`` line: the model of the bf16 instance against the plain
    bf16 version, and the gap a float32 instance would show (the plain
    float32 version on the window as read)."""
    from shm_tpu_torch.ops import FUSED_GATES

    ref = FUSED_GATES[cell][2]
    kw = dict(num_layers=L, use_layernorm=ln)
    m0, r0 = ref(w, Z, dtype=torch.bfloat16, io_dtype=io, **kw)
    m1, r1 = MODELS[cell](w, Z, L, ln, io or torch.float32)
    m32, _ = ref(w, Z.to(io or torch.float32).to(torch.float32), **kw)
    rel = (m1.double() - m0.double()).abs() / m0.double()
    gap = (m32.double() - m0.double()).abs() / m0.double()
    dy = (r1.double().sqrt() - r0.double().sqrt()).abs()
    print(f"MODEL {cell} {name} io={'bf16' if io else 'f32'}: mse max rel "
          f"{rel.max():.4e} mean rel {rel.mean():.4e}; |x - y| max diff "
          f"{dy.max():.4e}; float32 gap max rel {gap.max():.4e} mean rel "
          f"{gap.mean():.4e}", flush=True)


def model_readings(committed_only: bool = False, cells=tuple(ROOTS)) -> None:
    from shm_tpu_torch.cli.stage4dof import Paths, _load_vae
    from shm_tpu_torch.config import Stage4DofConfig, VAEConfig
    from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.tools.workload import load_trained_workload

    for cell in cells if not committed_only else ():
        shapes = SHAPES + (MINGRU_EXTRA if cell == "min_gru" else ())
        for i, (name, N, T, D, Zd, H, L, ln) in enumerate(shapes):
            cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H,
                            num_layers=L, use_layernorm=ln, cell=cell)
            rng = np.random.default_rng(100 + i)
            w = FUSED_GATES[cell][0](
                vae_from_flax(random_flax_vae_params(rng, cfg), cfg))
            Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32))
            for io in (None, torch.bfloat16):
                _model_case(cell, name, w, Z, L, ln, io)
    W = load_trained_workload(ROOT / ROOTS["lstm"]).W
    for cell, rel in ROOTS.items():
        if cell not in cells:
            continue
        root = ROOT / rel
        vae = _load_vae(Paths(str(root)), Stage4DofConfig())
        io = torch.bfloat16 if cell == "attention" else None
        _model_case(cell, f"committed {len(W)}", FUSED_GATES[cell][0](vae),
                    _normalized(root, W), vae.num_layers, vae.use_layernorm,
                    io)


# row 7's plain bf16 version's stores (``fused_attention_gate_reference``)
STORES = ("stream in", "qkv", "probabilities", "o", "stream after attention",
          "stream after mlp")


def _attention_plain(w, Z, num_layers, use_layernorm, skip="", f64=False):
    """``fused_attention_gate_reference``'s mse at bf16 with bf16 io, with
    the store ``skip`` (one of ``STORES``) left unrounded, or (``f64``)
    every product summed in float64 before the float32 result."""
    from shm_tpu_torch.models.attention import (
        HEAD_DIM, STACK_LN_EPS, flax_layer_norm, sinusoidal_positions)
    from shm_tpu_torch.ops._gate import bf16_round

    N, T, D = Z.shape
    H = w["mu_w"].shape[0]
    heads = H // HEAD_DIM
    x = bf16_round(Z)
    rnd = lambda name, t: t if name == skip else bf16_round(t)
    ln = lambda t, p, eps=STACK_LN_EPS: flax_layer_norm(t, w[f"{p}_s"],
                                                         w[f"{p}_b"], eps)

    def mm(a, k):
        a, b = bf16_round(a), bf16_round(w[k])
        return (a.double() @ b.double()).float() if f64 else a @ b

    def block(s, p):
        qkv = rnd("qkv", mm(ln(s, f"{p}_ln1"), f"{p}_wqkv") + w[f"{p}_bqkv"])
        q, k, v = (qkv.view(N, T, heads, 3, HEAD_DIM)[:, :, :, i].transpose(1, 2)
                   for i in range(3))
        prob = rnd("probabilities", torch.softmax(q @ k.transpose(-1, -2), -1))
        o = rnd("o", (prob @ v).transpose(1, 2).reshape(N, T, H))
        s = rnd("stream after attention", s + (mm(o, f"{p}_wo") + w[f"{p}_bo"]))
        h1 = F.gelu(mm(ln(s, f"{p}_ln2"), f"{p}_w1") + w[f"{p}_b1"],
                    approximate="tanh")
        return rnd("stream after mlp", s + (mm(h1, f"{p}_w2") + w[f"{p}_b2"]))

    def stack(tok, p):
        s = rnd("stream in", tok + sinusoidal_positions(T, H, Z.device))
        for l in range(num_layers):
            s = block(s, f"{p}{l}")
        return ln(s, f"{p}_fn")

    pooled = stack(mm(x, "enc_in_w") + w["enc_in_b"], "enc").mean(dim=1)
    if use_layernorm:
        pooled = flax_layer_norm(pooled, w["ln_scale"], w["ln_bias"], 1e-5)
    h0 = torch.tanh(mm(mm(pooled, "mu_w") + w["mu_b"], "z2h_w") + w["z2h_b"])
    out = stack((mm(h0, "dec_in_w") + w["dec_in_b"])[:, None, :], "dec")
    return ((x - (mm(out, "out_w") + w["out_b"])) ** 2).mean(dim=(1, 2))


def rounding_readings() -> None:
    """``rounding``: the attention gate on the 48 windows of
    ``tests/test_torch_gate_bf16.py``: the relative mse distance of the JAX
    kernel's streaming softmax form, and of the port's plain bf16 version
    as it is, with each store unrounded in turn and with float64 sums, from
    the JAX kernel's packed form (bf16, bf16 io, interpret mode)."""
    from test_torch_gate_bf16 import _outputs

    from shm_tpu_torch.cli.stage4dof import Paths, _load_vae
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.ops import attention_params_to_kernel_weights

    out = _outputs("attention")
    vae = _load_vae(Paths(str(ROOT / ROOTS["attention"])), Stage4DofConfig())
    w = attention_params_to_kernel_weights(vae)
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)
    mse_j = out["jax"][0]
    cases = [("JAX streaming form", out["jax_stream"][0]),
             ("port plain bf16", out["port"][0].numpy())]
    cases += [(f"port, {st} unrounded",
               _attention_plain(w, out["Z"], skip=st, **kw).numpy())
              for st in STORES]
    cases.append(("port, float64 sums",
                  _attention_plain(w, out["Z"], f64=True, **kw).numpy()))
    for name, mse in cases:
        rel = np.abs(np.asarray(mse, np.float64) - mse_j) / mse_j
        print(f"ROUNDING attention {name}: against the JAX kernel max rel "
              f"{rel.max():.4e} mean rel {rel.mean():.4e}", flush=True)


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "tests"))
    torch.set_num_threads(4)
    if argv == ["jax"]:
        jax_readings()
    elif argv[:1] == ["model"] and set(argv[1:]) <= {"committed", *ROOTS}:
        cells = tuple(c for c in ROOTS if c in argv[1:]) or tuple(ROOTS)
        model_readings(committed_only="committed" in argv[1:], cells=cells)
    elif argv == ["rounding"]:
        rounding_readings()
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
