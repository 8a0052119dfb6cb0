"""JAX (flax) parameter trees, as numpy, -> the port's modules.

Layouts handled here, once, at load:

- LSTM: flax ``w_ih`` [in, 4H] and ``w_hh`` [H, 4H] -> torch [4H, in] / [4H, H]
  (transposed; gate order i|f|g|o is the same), ``b_ih`` / ``b_hh`` ->
  ``bias_ih`` / ``bias_hh``, kept apart because they train apart.
- Dense: flax ``kernel`` [in, out] -> ``nn.Linear.weight`` [out, in].
- LayerNorm: ``scale`` / ``bias`` -> ``weight`` / ``bias`` (eps 1e-5 in both).
- Conv: HWIO -> OIHW.
- BatchNorm: ``params.{scale,bias}`` + ``batch_stats.{mean,var}``.
- ``fc1``: the JAX model flattens NHWC (T/4, D/4, 32) while NCHW flattens
  (32, T/4, D/4), so fc1's 2400 input rows are permuted to (c, t, d) order.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.models.cnn import CNN4DOF
from shm_tpu_torch.models.vae import TemporalVAE, vae_from_config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def vae_state_dict(params: Mapping, num_layers: int,
                   use_layernorm: bool) -> Dict[str, torch.Tensor]:
    """State dict of :class:`TemporalVAE` from the flax ``params`` tree."""
    sd: Dict[str, torch.Tensor] = {}
    for stack in ("encoder_lstm", "decoder_lstm"):
        for l in range(num_layers):
            p = params[stack][f"layer{l}"]
            pre = f"{stack}.layers.{l}"
            sd[f"{pre}.weight_ih"] = _t(np.asarray(p["w_ih"]).T)
            sd[f"{pre}.weight_hh"] = _t(np.asarray(p["w_hh"]).T)
            sd[f"{pre}.bias_ih"] = _t(p["b_ih"])
            sd[f"{pre}.bias_hh"] = _t(p["b_hh"])
    if use_layernorm:
        sd["layer_norm.weight"] = _t(params["layer_norm"]["scale"])
        sd["layer_norm.bias"] = _t(params["layer_norm"]["bias"])
    for name in ("fc_mu", "fc_logvar", "fc_latent_to_hidden", "output_layer"):
        _dense(sd, name, params[name])
    return sd


def vae_from_flax(params: Mapping, cfg: VAEConfig) -> TemporalVAE:
    vae = vae_from_config(cfg)
    vae.load_state_dict(vae_state_dict(params, cfg.num_layers,
                                       cfg.use_layernorm))
    return vae.eval()


def vae_to_flax(vae: Union[TemporalVAE, Mapping]) -> Dict:
    """The flax ``params`` tree (numpy float32) of a :class:`TemporalVAE` or of
    its state dict: the inverse of :func:`vae_state_dict`, transposes undone,
    so a VAE trained by the port is saved in the layout both packages read."""
    sd = vae.state_dict() if isinstance(vae, torch.nn.Module) else vae
    a = lambda k: np.ascontiguousarray(
        sd[k].detach().cpu().numpy().astype(np.float32))
    dense = lambda name: {"kernel": np.ascontiguousarray(a(f"{name}.weight").T),
                          "bias": a(f"{name}.bias")}
    params: Dict = {}
    for stack in ("encoder_lstm", "decoder_lstm"):
        params[stack] = {}
        l = 0
        while f"{stack}.layers.{l}.weight_ih" in sd:
            pre = f"{stack}.layers.{l}"
            params[stack][f"layer{l}"] = {
                "w_ih": np.ascontiguousarray(a(f"{pre}.weight_ih").T),
                "w_hh": np.ascontiguousarray(a(f"{pre}.weight_hh").T),
                "b_ih": a(f"{pre}.bias_ih"), "b_hh": a(f"{pre}.bias_hh")}
            l += 1
    if "layer_norm.weight" in sd:
        params["layer_norm"] = {"scale": a("layer_norm.weight"),
                                "bias": a("layer_norm.bias")}
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


def random_flax_vae_params(rng: np.random.Generator, cfg: VAEConfig) -> Dict:
    """A flax-layout TemporalVAE parameter tree of random numpy values.

    Lets a test or a smoke run feed the same random weights to the JAX model
    and to the port. LayerNorm scale and bias are drawn away from (1, 0) so
    that the normalization is exercised.
    """
    D, Z, H, L = cfg.input_dim, cfg.latent_dim, cfg.hidden_dim, cfg.num_layers

    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    def stack(in_dim):
        return {f"layer{l}": {
            "w_ih": u((in_dim if l == 0 else H, 4 * H), H),
            "w_hh": u((H, 4 * H), H),
            "b_ih": u((4 * H,), H),
            "b_hh": u((4 * H,), H),
        } for l in range(L)}

    def dense(i, o):
        return {"kernel": u((i, o), i), "bias": u((o,), i)}

    params = {
        "encoder_lstm": stack(D),
        "fc_mu": dense(H, Z),
        "fc_logvar": dense(H, Z),
        "fc_latent_to_hidden": dense(Z, H),
        "decoder_lstm": stack(H),
        "output_layer": dense(H, D),
    }
    if cfg.use_layernorm:
        params["layer_norm"] = {
            "scale": rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32),
            "bias": rng.uniform(-0.2, 0.2, size=(H,)).astype(np.float32),
        }
    return params


__all__ = ["vae_state_dict", "vae_from_flax", "vae_to_flax", "cnn4dof_state_dict",
           "cnn4dof_from_flax", "random_flax_vae_params"]
