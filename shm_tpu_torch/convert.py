"""JAX (flax) parameter trees, as numpy, -> the port's modules.

Layouts handled here, once, at load:

- LSTM: flax ``w_ih`` [in, 4H] and ``w_hh`` [H, 4H] -> torch [4H, in] / [4H, H]
  (transposed; gate order i|f|g|o is the same), ``b_ih`` / ``b_hh`` ->
  ``bias_ih`` / ``bias_hh``, kept apart because they train apart.
- minGRU: flax ``w_ih`` [in, 2H] -> ``weight_ih`` [2H, in], ``b_ih`` -> ``bias_ih``.
- Attention: ``query/key/value.kernel`` [H, heads, hd] -> weight [heads*hd, H]
  (bias [heads, hd] -> [heads*hd]); ``out.kernel`` [heads, hd, H] -> weight
  [H, heads*hd]; the stack's LayerNorms ``scale`` / ``bias`` -> ``weight`` /
  ``bias``; ``in_proj``, ``mlp_in``, ``mlp_out`` are Dense.
- Dense: flax ``kernel`` [in, out] -> ``nn.Linear.weight`` [out, in].
- LayerNorm: ``scale`` / ``bias`` -> ``weight`` / ``bias`` (eps 1e-5 in both).
- Conv: HWIO -> OIHW.
- BatchNorm: ``params.{scale,bias}`` + ``batch_stats.{mean,var}``.
- ``fc1``: the JAX model flattens NHWC (T/4, D/4, 32) while NCHW flattens
  (32, T/4, D/4), so fc1's 2400 input rows are permuted to (c, t, d) order.

Both directions for the VAE (``vae_from_flax`` / ``vae_to_flax``) and the
CNN (``cnn4dof_from_flax`` / ``cnn4dof_to_flax``), bit for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.models.attention import HEAD_DIM
from shm_tpu_torch.models.cnn import CNN4DOF
from shm_tpu_torch.models.vae import TemporalVAE, vae_from_config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


_BLOCK_NORMS = ("attn_norm", "mlp_norm")
_BLOCK_DENSE = ("mlp_in", "mlp_out")
_QKV = ("query", "key", "value")


def tree_cell(params: Mapping) -> str:
    """The temporal-stack family a flax VAE ``params`` tree belongs to."""
    enc = params["encoder_lstm"]
    if "in_proj" in enc:
        return "attention"
    return "lstm" if "w_hh" in enc["layer0"] else "min_gru"


def _norm(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _attention_stack_sd(sd: Dict, stack: str, tree: Mapping,
                        num_layers: int) -> None:
    _dense(sd, f"{stack}.in_proj", tree["in_proj"])
    for l in range(num_layers):
        lay, pre = tree[f"layer{l}"], f"{stack}.layers.{l}"
        for n in _BLOCK_NORMS:
            _norm(sd, f"{pre}.{n}", lay[n])
        for n in _QKV:
            k = np.asarray(lay["attn"][n]["kernel"])          # [H, heads, hd]
            sd[f"{pre}.{n}.weight"] = _t(k.reshape(k.shape[0], -1).T)
            sd[f"{pre}.{n}.bias"] = _t(np.asarray(lay["attn"][n]["bias"]).reshape(-1))
        ko = np.asarray(lay["attn"]["out"]["kernel"])         # [heads, hd, H]
        sd[f"{pre}.out.weight"] = _t(ko.reshape(-1, ko.shape[-1]).T)
        sd[f"{pre}.out.bias"] = _t(lay["attn"]["out"]["bias"])
        for n in _BLOCK_DENSE:
            _dense(sd, f"{pre}.{n}", lay[n])
    _norm(sd, f"{stack}.final_norm", tree["final_norm"])


def vae_state_dict(params: Mapping, num_layers: int, use_layernorm: bool,
                   cell: str = "lstm") -> Dict[str, torch.Tensor]:
    """State dict of :class:`TemporalVAE` from the flax ``params`` tree of the
    ``cell`` family. A tree of another family raises ``ValueError``."""
    if tree_cell(params) != cell:
        raise ValueError(f"the parameter tree holds a {tree_cell(params)!r} "
                         f"VAE, not the {cell!r} one asked for")
    sd: Dict[str, torch.Tensor] = {}
    for stack in ("encoder_lstm", "decoder_lstm"):
        if cell == "attention":
            _attention_stack_sd(sd, stack, params[stack], num_layers)
            continue
        for l in range(num_layers):
            p = params[stack][f"layer{l}"]
            pre = f"{stack}.layers.{l}"
            sd[f"{pre}.weight_ih"] = _t(np.asarray(p["w_ih"]).T)
            sd[f"{pre}.bias_ih"] = _t(p["b_ih"])
            if cell == "lstm":
                sd[f"{pre}.weight_hh"] = _t(np.asarray(p["w_hh"]).T)
                sd[f"{pre}.bias_hh"] = _t(p["b_hh"])
    if use_layernorm:
        _norm(sd, "layer_norm", params["layer_norm"])
    for name in ("fc_mu", "fc_logvar", "fc_latent_to_hidden", "output_layer"):
        _dense(sd, name, params[name])
    return sd


def vae_from_flax(params: Mapping, cfg: VAEConfig) -> TemporalVAE:
    vae = vae_from_config(cfg)
    vae.load_state_dict(vae_state_dict(params, cfg.num_layers,
                                       cfg.use_layernorm, cfg.cell))
    return vae.eval()


def vae_to_flax(vae: Union[TemporalVAE, Mapping]) -> Dict:
    """The flax ``params`` tree (numpy float32) of a :class:`TemporalVAE` or of
    its state dict: the inverse of :func:`vae_state_dict`, transposes and
    reshapes undone (attention heads are ``hidden_dim // 32`` wide, the
    stack's fixed head size), so a VAE of any family is saved in the layout
    both packages read."""
    sd = vae.state_dict() if isinstance(vae, torch.nn.Module) else vae
    a = lambda k: np.ascontiguousarray(
        sd[k].detach().cpu().numpy().astype(np.float32))
    dense = lambda name: {"kernel": np.ascontiguousarray(a(f"{name}.weight").T),
                          "bias": a(f"{name}.bias")}
    norm = lambda name: {"scale": a(f"{name}.weight"), "bias": a(f"{name}.bias")}

    def attention_stack(stack: str) -> Dict:
        H = sd[f"{stack}.in_proj.weight"].shape[0]
        heads = max(1, H // HEAD_DIM)
        tree = {"in_proj": dense(f"{stack}.in_proj"),
                "final_norm": norm(f"{stack}.final_norm")}
        l = 0
        while f"{stack}.layers.{l}.query.weight" in sd:
            pre = f"{stack}.layers.{l}"
            attn = {n: {"kernel": np.ascontiguousarray(
                            a(f"{pre}.{n}.weight").T.reshape(H, heads, -1)),
                        "bias": a(f"{pre}.{n}.bias").reshape(heads, -1)}
                    for n in _QKV}
            attn["out"] = {"kernel": np.ascontiguousarray(
                               a(f"{pre}.out.weight").T.reshape(heads, -1, H)),
                           "bias": a(f"{pre}.out.bias")}
            tree[f"layer{l}"] = {"attn": attn,
                                 **{n: norm(f"{pre}.{n}") for n in _BLOCK_NORMS},
                                 **{n: dense(f"{pre}.{n}") for n in _BLOCK_DENSE}}
            l += 1
        return tree

    def recurrent_stack(stack: str) -> Dict:
        tree, l = {}, 0
        while f"{stack}.layers.{l}.weight_ih" in sd:
            pre = f"{stack}.layers.{l}"
            tree[f"layer{l}"] = {
                "w_ih": np.ascontiguousarray(a(f"{pre}.weight_ih").T),
                "b_ih": a(f"{pre}.bias_ih")}
            if f"{pre}.weight_hh" in sd:                  # the LSTM cell
                tree[f"layer{l}"].update(
                    w_hh=np.ascontiguousarray(a(f"{pre}.weight_hh").T),
                    b_hh=a(f"{pre}.bias_hh"))
            l += 1
        return tree

    params: Dict = {}
    for stack in ("encoder_lstm", "decoder_lstm"):
        params[stack] = (attention_stack(stack)
                         if f"{stack}.in_proj.weight" in sd
                         else recurrent_stack(stack))
    if "layer_norm.weight" in sd:
        params["layer_norm"] = norm("layer_norm")
    for name in ("fc_mu", "fc_logvar", "fc_latent_to_hidden", "output_layer"):
        params[name] = dense(name)
    return params


def cnn4dof_state_dict(variables: Mapping, seq_len: int = 100,
                       num_features: int = 12) -> Dict[str, torch.Tensor]:
    """State dict of :class:`CNN4DOF` from flax ``{"params", "batch_stats"}``."""
    p, bst = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for conv in ("conv1", "conv2"):
        sd[f"{conv}.weight"] = _t(np.transpose(p[conv]["kernel"], (3, 2, 0, 1)))
        sd[f"{conv}.bias"] = _t(p[conv]["bias"])
    for bn in ("bn1", "bn2"):
        sd[f"{bn}.weight"] = _t(p[bn]["scale"])
        sd[f"{bn}.bias"] = _t(p[bn]["bias"])
        sd[f"{bn}.running_mean"] = _t(bst[bn]["mean"])
        sd[f"{bn}.running_var"] = _t(bst[bn]["var"])
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    k1 = np.asarray(p["fc1"]["kernel"])                       # [(t, d, c), 128]
    t, d = seq_len // 4, num_features // 4
    c = k1.shape[0] // (t * d)
    k1 = k1.reshape(t, d, c, -1).transpose(2, 0, 1, 3).reshape(c * t * d, -1)
    sd["fc1.weight"] = _t(k1.T)
    sd["fc1.bias"] = _t(p["fc1"]["bias"])
    _dense(sd, "fc2", p["fc2"])
    return sd


def cnn4dof_from_flax(variables: Mapping, num_classes: int = 2,
                      seq_len: int = 100, num_features: int = 12) -> CNN4DOF:
    cnn = CNN4DOF(num_classes, seq_len, num_features)
    cnn.load_state_dict(cnn4dof_state_dict(variables, seq_len, num_features))
    return cnn.eval()


def cnn4dof_to_flax(cnn: Union[CNN4DOF, Mapping], seq_len: int = 100,
                    num_features: int = 12) -> Dict:
    """flax ``{"params", "batch_stats"}`` (numpy float32) of a :class:`CNN4DOF`
    or of its state dict: the inverse of :func:`cnn4dof_state_dict` (OIHW
    back to HWIO, fc1's rows back to the NHWC flatten order (t, d, c)), so
    a trained CNN is saved in the layout both packages read."""
    sd = cnn.state_dict() if isinstance(cnn, torch.nn.Module) else cnn
    a = lambda k: np.ascontiguousarray(
        sd[k].detach().cpu().numpy().astype(np.float32))
    params: Dict = {}
    for conv in ("conv1", "conv2"):
        params[conv] = {"kernel": np.ascontiguousarray(
                            a(f"{conv}.weight").transpose(2, 3, 1, 0)),
                        "bias": a(f"{conv}.bias")}
    for bn in ("bn1", "bn2"):
        params[bn] = {"scale": a(f"{bn}.weight"), "bias": a(f"{bn}.bias")}
    k1 = a("fc1.weight").T                                    # [(c, t, d), 128]
    t, d = seq_len // 4, num_features // 4
    c = k1.shape[0] // (t * d)
    k1 = k1.reshape(c, t, d, -1).transpose(1, 2, 0, 3).reshape(t * d * c, -1)
    params["fc1"] = {"kernel": np.ascontiguousarray(k1), "bias": a("fc1.bias")}
    params["fc2"] = {"kernel": np.ascontiguousarray(a("fc2.weight").T),
                     "bias": a("fc2.bias")}
    batch_stats = {bn: {"mean": a(f"{bn}.running_mean"),
                        "var": a(f"{bn}.running_var")} for bn in ("bn1", "bn2")}
    return {"params": params, "batch_stats": batch_stats}


def random_flax_vae_params(rng: np.random.Generator, cfg: VAEConfig) -> Dict:
    """A flax-layout TemporalVAE parameter tree of random numpy values, of
    the ``cfg.cell`` family.

    Lets a test or a smoke run feed the same random weights to the JAX model
    and to the port. LayerNorm scales and biases (and the attention stack's
    biases, which flax would start at 0) are drawn away from (1, 0) so that
    every term is exercised.
    """
    D, Z, H, L = cfg.input_dim, cfg.latent_dim, cfg.hidden_dim, cfg.num_layers

    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    def dense(i, o):
        return {"kernel": u((i, o), i), "bias": u((o,), i)}

    def norm():
        return {"scale": rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32),
                "bias": rng.uniform(-0.2, 0.2, size=(H,)).astype(np.float32)}

    def recurrent_stack(in_dim):
        gates = 4 if cfg.cell == "lstm" else 2
        layers = {}
        for l in range(L):
            layers[f"layer{l}"] = {
                "w_ih": u((in_dim if l == 0 else H, gates * H), H)}
            if cfg.cell == "lstm":
                layers[f"layer{l}"]["w_hh"] = u((H, 4 * H), H)
            layers[f"layer{l}"]["b_ih"] = u((gates * H,), H)
            if cfg.cell == "lstm":
                layers[f"layer{l}"]["b_hh"] = u((4 * H,), H)
        return layers

    def attention_stack(in_dim):
        heads = max(1, H // HEAD_DIM)
        hd = H // heads
        tree = {"in_proj": dense(in_dim, H)}
        for l in range(L):
            attn = {n: {"kernel": u((H, heads, hd), H), "bias": u((heads, hd), H)}
                    for n in _QKV}
            attn["out"] = {"kernel": u((heads, hd, H), H), "bias": u((H,), H)}
            tree[f"layer{l}"] = {"attn_norm": norm(), "attn": attn,
                                 "mlp_norm": norm(), "mlp_in": dense(H, 4 * H),
                                 "mlp_out": dense(4 * H, H)}
        tree["final_norm"] = norm()
        return tree

    if cfg.cell not in ("lstm", "min_gru", "attention"):
        raise ValueError(f"unknown cell {cfg.cell!r}")
    stack = attention_stack if cfg.cell == "attention" else recurrent_stack
    params = {
        "encoder_lstm": stack(D),
        "fc_mu": dense(H, Z),
        "fc_logvar": dense(H, Z),
        "fc_latent_to_hidden": dense(Z, H),
        "decoder_lstm": stack(H),
        "output_layer": dense(H, D),
    }
    if cfg.use_layernorm:
        params["layer_norm"] = norm()
    return params


__all__ = ["vae_state_dict", "vae_from_flax", "vae_to_flax", "tree_cell",
           "cnn4dof_state_dict", "cnn4dof_from_flax", "cnn4dof_to_flax",
           "random_flax_vae_params"]
