"""Temporal-VAE training (counterpart of ``shm_tpu/train/vae.py``).

The reference recipe: Adam lr=1e-3 with coupled weight decay 1e-5, gradient
clip 2.0 by global norm, sigmoid KL anneal with warm-up 0.3, batch 256,
best-validation selection. The optimizer chain reproduces the JAX package's
optax chain (``clip_by_global_norm -> add_decayed_weights -> scale_by_adam ->
scale(-lr)``), not ``torch.nn.utils.clip_grad_norm_`` (which scales by
``max_norm / (norm + 1e-6)``).

Execution structure: the per-batch epoch loop only. The JAX trainer's
``fused_epochs`` / ``epoch_chunk`` / program cache are dispatch devices of its
compiler with a bit-identical trajectory, not semantics, and have no
counterpart here. On CUDA the forward and backward of both LSTM stacks run in
the hand-written kernels of ``shm_tpu_torch.ops.lstm_train`` (``use_kernel``,
on by default there; they take 2-layer LSTM presets); everything around them is plain
PyTorch under autograd. The ``min_gru`` and ``attention`` cells train on the
plain autograd path, on the card as on the CPU: the JAX package has no
training kernel for them either (its ``use_pallas_kernel`` is LSTM-only).
``mesh=`` trains data-parallel over the devices of a
:class:`shm_tpu_torch.parallel.Mesh` on that plain path (below).

Noise. All randomness of a run comes from ONE ``torch.Generator`` on the
training device, seeded with ``cfg.seed``, drawn in this fixed order:

1. with ``init_params=None``, one integer that seeds the parameter init;
2. per epoch: the permutation of the training windows; then per batch the
   reparameterisation noise eps [bs, Z], and the dropout masks:
   - ``lstm`` and ``min_gru``: the encoder's masks, then the decoder's,
     [T, H, bs] each, one per layer gap, drawn explicitly;
   - ``attention``: the stacks draw their own masks from the same generator
     while the forward runs (``TemporalVAE.forward(generator=...)``): the
     encoder's blocks, then the decoder's, each block its attention-weight
     mask [1, 1, T, T] and its two residual masks [bs, T, H] (see
     ``models/attention.py::TransformerBlock``);
   then, per validation batch, eps (with ``val_sample``; validation runs in
   eval mode and draws no mask).

A checkpoint stores the generator's state, so a resumed run stays on the
trajectory of an uninterrupted one for every cell.

Data parallelism (``mesh=``) is the same math as one device, as in the JAX
package: one generator drawn in the order above, each minibatch split into
contiguous shards (:func:`shm_tpu_torch.parallel.mesh.shard_slices`), each
shard's forward and backward on its device with its own replica of the
model. eps [bs, Z] and the masks [T, H, bs] are drawn for the whole
minibatch and sliced by shard; the attention cell's masks are drawn ahead of
the forward in its order (``AttentionStack.draw_dropout_masks``), each
block's [1, 1, T, T] weight mask shared by every shard and its residual
masks sliced. A shard's loss divides its sums by the whole batch's window
count (``vae_loss(count=)``), so the shards' losses sum to the batch's; the
gradients are summed on the first device in shard order
(:func:`~shm_tpu_torch.parallel.mesh.sum_grads`), then one optimizer step,
and the replicas are refreshed. The trajectory is one device's up to the
order of float sums; a checkpoint holds the first replica's state, so a
mesh run resumes with or without the mesh.

The numbers differ from the JAX package's ``jax.random`` streams by nature;
:func:`batch_loss` takes the noise as arguments so that a test can feed both
frameworks the same.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shm_tpu_torch.config import TrainConfig
from shm_tpu_torch.device import resolve_device
from shm_tpu_torch.models.vae import TemporalVAE, vae_loss
from shm_tpu_torch.parallel.mesh import mesh_device

_HIST_KEYS = ("epoch", "kl_w", "train_total", "train_recon", "train_kl",
              "val_total", "val_recon", "val_kl")


def kl_anneal_sigmoid(epoch: int, n_epochs: int, anneal_ratio: float = 0.3) -> float:
    """Sigmoid KL weight ramp; ``epoch`` is 1-based:
    warm = max(1, int(n_epochs * ratio)), x = (epoch - 1 - warm) / warm."""
    e0 = epoch - 1
    warm = max(1, int(n_epochs * anneal_ratio))
    x = (e0 - warm) / float(max(warm, 1))
    return float(1.0 / (1.0 + math.exp(-x * 5.0)))


class ClippedAdam:
    """Global-norm clip (optax's formula) followed by torch Adam or AdamW.

    coupled (``Adam(weight_decay=w)``): clip -> add w*p to the gradient ->
    Adam moments. decoupled (``AdamW``): clip -> Adam moments -> decay on the
    update. The clip scales every gradient by ``max_norm / norm`` when
    ``norm >= max_norm`` and leaves it alone otherwise, with no host
    synchronisation.
    """

    def __init__(self, params, cfg: TrainConfig):
        self.params = list(params)
        self.grad_clip = float(cfg.grad_clip or 0.0)
        wd = float(cfg.weight_decay or 0.0)
        cls = torch.optim.AdamW if (cfg.decoupled_wd and wd > 0) else torch.optim.Adam
        self.opt = cls(self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                       weight_decay=wd)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        self.opt.step()

    def state_dict(self) -> Dict:
        return self.opt.state_dict()

    def load_state_dict(self, sd: Dict) -> None:
        self.opt.load_state_dict(sd)


def make_optimizer(params, cfg: TrainConfig) -> ClippedAdam:
    """The trainer's optimizer over ``params`` (see :class:`ClippedAdam`)."""
    return ClippedAdam(params, cfg)


def _batch_plan(N: int, bs: int) -> Tuple[int, int]:
    nb = -(-N // bs)
    return nb, nb * bs - N


def _bt(masks: Optional[Sequence[torch.Tensor]]):
    """[T, H, B] masks -> the model's [B, T, H] layout."""
    return None if masks is None else [m.permute(2, 0, 1) for m in masks]


def batch_loss(model: TemporalVAE, xb: torch.Tensor,
               bmask: Optional[torch.Tensor], eps: Optional[torch.Tensor],
               dm_enc: Optional[Sequence[torch.Tensor]],
               dm_dec: Optional[Sequence[torch.Tensor]], kl_w,
               use_kernel: bool,
               generator: Optional[torch.Generator] = None):
    """(total, recon, kl) of one batch with the noise given.

    ``eps`` [bs, Z] (None decodes the posterior mean); ``dm_enc`` / ``dm_dec``:
    one inverted dropout mask [T, H, bs] per layer gap, or None (then a
    model in training mode draws its masks from ``generator``, as the
    attention stack always does). ``use_kernel`` routes the two LSTM stacks
    through ``ops.lstm_train.vae_train_forward`` (2-layer presets);
    otherwise the model's own forward runs under autograd.
    """
    if use_kernel:
        from shm_tpu_torch.ops.lstm_train import vae_train_forward

        recon, mu, logvar = vae_train_forward(
            model, xb, eps, dm_enc[0] if dm_enc else None,
            dm_dec[0] if dm_dec else None)
    else:
        masks = None if dm_enc is None else (_bt(dm_enc), _bt(dm_dec))
        recon, mu, logvar = model(xb, sample=eps is not None, eps=eps,
                                  dropout_masks=masks, generator=generator)
    return vae_loss(recon, xb, mu, logvar, kl_w, mask=bmask)


def draw_batch_noise(model: TemporalVAE, bs: int, T: int,
                     generator: torch.Generator, device):
    """(eps, dm_enc, dm_dec) of one training batch, in that order of draws;
    the masks are None for the attention cell, whose stacks draw their own
    during the forward."""
    eps = torch.randn(bs, model.latent_dim, generator=generator, device=device)
    gaps = model.num_layers - 1
    if model.dropout <= 0.0 or gaps == 0 or model.cell == "attention":
        return eps, None, None
    keep = 1.0 - model.dropout

    def masks():
        return [(torch.rand(T, model.hidden_dim, bs, generator=generator,
                            device=device) < keep).to(torch.float32) / keep
                for _ in range(gaps)]

    dm_enc = masks()
    return eps, dm_enc, masks()


def _mesh_masks(model: TemporalVAE, dm_enc, dm_dec, bs: int, T: int,
                generator: torch.Generator, device):
    """The (encoder, decoder) dropout masks of one data-parallel training
    batch in the model's layout, or None: the recurrent cells' drawn masks
    [T, H, bs] as [bs, T, H]; for the attention cell the masks its forward
    would draw next from ``generator``, drawn here in that order."""
    if model.cell == "attention":
        if model.dropout <= 0.0:
            return None
        return tuple(stack.draw_dropout_masks(bs, T, generator, device)
                     for stack in (model.encoder_lstm, model.decoder_lstm))
    return None if dm_enc is None else (_bt(dm_enc), _bt(dm_dec))


def _shard_masks(masks, sl: slice, device):
    """One shard's rows of a stack's masks: [B, T, H] tensors, or the
    attention blocks' (weights, residual, residual) triples, whose weight
    mask every shard shares."""
    return [tuple(t.to(device) for t in (m[0], m[1][sl], m[2][sl]))
            if isinstance(m, tuple) else m[sl].to(device) for m in masks]


def mesh_batch_loss(replicas, mesh, xb: torch.Tensor, bmask: torch.Tensor,
                    eps: Optional[torch.Tensor], masks, kl_w,
                    backward: bool):
    """(total, recon, kl) of one batch split over ``mesh``: each shard runs
    on its replica with its rows of the noise (``masks``: an (encoder,
    decoder) pair as :func:`_mesh_masks` gives, or None), its loss divided
    by the whole batch's window count; with ``backward`` each shard's loss
    is back-propagated and the gradients summed into the first replica
    (:func:`shm_tpu_torch.parallel.mesh.sum_grads`). The three sums are on
    the first device."""
    from shm_tpu_torch.parallel.mesh import shard_slices, sum_grads

    n = bmask.sum()
    parts = []
    for rep, d, sl in zip(replicas, mesh.devices,
                          shard_slices(xb.shape[0], len(mesh.devices))):
        xs = xb[sl].to(d)
        es = None if eps is None else eps[sl].to(d)
        dm = None if masks is None else tuple(_shard_masks(m, sl, d)
                                              for m in masks)
        recon, mu, logvar = rep(xs, sample=es is not None, eps=es,
                                dropout_masks=dm)
        total, r, kl = vae_loss(recon, xs, mu, logvar, kl_w,
                                mask=bmask[sl].to(d), count=n.to(d))
        if backward:
            total.backward()
        parts.append(torch.stack([total, r, kl]).detach().to(mesh.devices[0]))
    if backward:
        sum_grads(replicas, mesh)
    return tuple(torch.stack(parts).sum(0))


@dataclass
class VAETrainResult:
    params: Any                      # best-val state dict
    last_params: Any
    history: Dict[str, list] = field(default_factory=dict)
    best_val: float = float("inf")
    best_epoch: int = -1
    seconds: float = 0.0


def _clone_state(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _resolve_use_kernel(model, use_kernel: Optional[bool], device,
                        mesh=None) -> bool:
    if mesh is not None:
        if use_kernel:
            raise ValueError(
                "mesh= data-parallel training runs the plain autograd path "
                "(as the JAX trainer refuses its Pallas kernels under a "
                "mesh); pass use_kernel=None or False with mesh=, or train "
                "on one device")
        return False
    if model.cell != "lstm":
        if use_kernel:
            raise ValueError(
                "use_kernel: the training kernels implement the LSTM "
                f"recurrence only; cell={model.cell!r} trains on the plain "
                "autograd path (use_kernel=None or False)")
        return False
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    if use_kernel and model.num_layers != 2:
        raise ValueError("use_kernel requires a 2-layer LSTM preset (pass "
                         "use_kernel=False for the plain autograd path)")
    return bool(use_kernel)


def train_vae(
    model: TemporalVAE,
    Ztr,
    Zva,
    cfg: TrainConfig,
    *,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    val_sample: bool = True,
    log_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = True,
    use_kernel: Optional[bool] = None,
    device=None,
    mesh=None,
) -> VAETrainResult:
    """Train ``model`` on normalized windows; returns best-val params + history.

    ``Ztr`` / ``Zva``: (N, T, D) normalized window stacks (numpy or tensor).
    ``init_params``: a state dict to start from; None draws fresh parameters
    (consuming one draw of the generator first). The model is moved to
    ``device`` (None = the CUDA card), trained in place, and left in eval
    mode holding the LAST parameters; ``result.params`` is the state dict of
    the best validation epoch.

    ``use_kernel``: None = on for an LSTM model on CUDA, off for the CPU and
    for the ``min_gru`` and ``attention`` cells (plain autograd; True raises
    ``ValueError`` for them). With it on, a CUDA run launches the LSTM
    training kernels for every training batch (forward with stash, backward)
    and for every validation batch (forward only, unit mask, no stash) and
    never drops to the plain path; a depth other than 2 raises
    ``ValueError``. Only an explicit ``use_kernel=False`` trains a CUDA LSTM
    model on the plain autograd path.

    With ``checkpoint_dir`` and ``checkpoint_every=k`` the full training state
    persists every k epochs, and a later call with ``resume=True`` continues
    the interrupted run on the same trajectory (bit for bit on the CPU, and on
    the card, whose kernels use no atomics).

    ``mesh``: a :class:`shm_tpu_torch.parallel.Mesh` of one process trains
    data-parallel over its devices (the module docstring), on the first of
    which the model, the data and the generator live (``device`` must be of
    its type, or None). ``use_kernel=True`` with a mesh raises
    ``ValueError``; None resolves to the plain path.
    """
    device = mesh_device(mesh, device)
    use_kernel = _resolve_use_kernel(model, use_kernel, device, mesh)
    Ztr = torch.as_tensor(Ztr, dtype=torch.float32).to(device)
    Zva = torch.as_tensor(Zva, dtype=torch.float32).to(device)
    N, T, _ = Ztr.shape
    Nva = Zva.shape[0]
    bs = cfg.batch_size
    nb, pad = _batch_plan(N, bs)
    nvb, vpad = _batch_plan(Nva, bs)

    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    model.to(device)
    # recorded in checkpoints: a resume with another init_params-presence
    # would start its noise stream one draw off and silently diverge
    init_consumed = init_params is None
    if init_params is None:
        seed = int(torch.randint(2 ** 62, (1,), generator=gen, device=device))
        model.init_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(init_params)
    opt = make_optimizer(model.parameters(), cfg)

    hist: Dict[str, list] = {k: [] for k in _HIST_KEYS}
    best_val, best_epoch = float("inf"), -1
    best_params = _clone_state(model)
    start_epoch = 1

    ckpt_path = None
    if checkpoint_dir:
        from shm_tpu_torch.train.checkpoint import (
            load_train_ckpt, save_train_ckpt,
        )

        ckpt_path = f"{checkpoint_dir}/vae_train_state.pt"
        restored = load_train_ckpt(ckpt_path, device) if resume else None
        if restored is not None:
            arrays, meta = restored
            if meta.get("init_consumed", init_consumed) != init_consumed:
                raise ValueError(
                    "checkpoint was written with a different "
                    "init_params-presence than this resume call; the noise "
                    "stream would silently diverge (checkpoint "
                    f"init_consumed={meta['init_consumed']})")
            model.load_state_dict(arrays["params"])
            opt.load_state_dict(arrays["opt_state"])
            best_params = arrays["best_params"]
            gen.set_state(arrays["rng"].cpu())
            hist = meta["history"]
            best_val, best_epoch = meta["best_val"], meta["best_epoch"]
            start_epoch = meta["epoch"] + 1
            print(f"[resume] restored epoch {meta['epoch']} from {ckpt_path}")
        elif resume:
            print(f"[resume] no checkpoint at {ckpt_path}; starting fresh")

    train_mask = torch.cat([torch.ones(N, device=device),
                            torch.zeros(pad, device=device)]).reshape(nb, bs)
    val_idx = torch.cat([torch.arange(Nva, device=device),
                         torch.zeros(vpad, dtype=torch.long, device=device)]
                        ).reshape(nvb, bs)
    val_mask = torch.cat([torch.ones(Nva, device=device),
                          torch.zeros(vpad, device=device)]).reshape(nvb, bs)
    replicas = None
    if mesh is not None:
        from shm_tpu_torch.parallel.mesh import replicas_of, sync_replicas

        replicas = replicas_of(model, mesh)

    def reduce(stats: List[Tuple[torch.Tensor, ...]]):
        tl, rl, kl, ns = (torch.stack(c) for c in zip(*stats))
        denom = torch.clamp(ns.sum(), min=1.0)
        return tl.sum() / denom, rl.sum() / denom, kl.sum() / denom

    def train_epoch(kl_w: float):
        for m in replicas or [model]:
            m.train()
        perm = torch.randperm(N, generator=gen, device=device)
        idx = (torch.cat([perm, perm[:pad]]) if pad else perm).reshape(nb, bs)
        stats = []
        for b in range(nb):
            xb, bmask = Ztr[idx[b]], train_mask[b]
            eps, dm_e, dm_d = draw_batch_noise(model, bs, T, gen, device)
            opt.zero_grad()
            if replicas is None:
                total, r, kl = batch_loss(model, xb, bmask, eps, dm_e, dm_d,
                                          kl_w, use_kernel, generator=gen)
                total.backward()
            else:
                masks = _mesh_masks(model, dm_e, dm_d, bs, T, gen, device)
                total, r, kl = mesh_batch_loss(replicas, mesh, xb, bmask, eps,
                                               masks, kl_w, backward=True)
            opt.step()
            if replicas is not None:
                sync_replicas(replicas)
            n = bmask.sum()
            stats.append((total.detach() * n, r.detach() * n,
                          kl.detach() * n, n))
        return reduce(stats)

    @torch.no_grad()
    def val_epoch(kl_w: float):
        for m in replicas or [model]:
            m.eval()
        stats = []
        for b in range(nvb):
            xb, bmask = Zva[val_idx[b]], val_mask[b]
            eps = (torch.randn(bs, model.latent_dim, generator=gen,
                               device=device) if val_sample else None)
            if replicas is None:
                total, r, kl = batch_loss(model, xb, bmask, eps, None, None,
                                          kl_w, use_kernel)
            else:
                total, r, kl = mesh_batch_loss(replicas, mesh, xb, bmask, eps,
                                               None, kl_w, backward=False)
            n = bmask.sum()
            stats.append((total * n, r * n, kl * n, n))
        return reduce(stats)

    t0 = time.perf_counter()
    for epoch in range(start_epoch, cfg.epochs + 1):
        kl_w = kl_anneal_sigmoid(epoch, cfg.epochs, cfg.kl_warmup_ratio)
        # float32, as the loss computes with it and the history records it
        kl_w = float(np.float32(kl_w))
        tr = train_epoch(kl_w)
        va = val_epoch(kl_w)
        # ONE host fetch per epoch
        tl, rl, kl, vl, vr, vkl = torch.stack(tr + va).tolist()

        for k, v in zip(_HIST_KEYS, (epoch, kl_w, tl, rl, kl, vl, vr, vkl)):
            hist[k].append(v)
        if log_every and epoch % log_every == 0:
            print(f"[train] epoch {epoch:03d}/{cfg.epochs} | kl_w={kl_w:.6f} | "
                  f"total={tl:.6f} | recon={rl:.6f} | kl={kl:.6f}")
            print(f"[val  ] epoch {epoch:03d}/{cfg.epochs} | total={vl:.6f}")

        if vl < best_val:
            best_val, best_epoch = vl, epoch
            best_params = _clone_state(model)

        if ckpt_path and checkpoint_every and epoch % checkpoint_every == 0:
            save_train_ckpt(
                ckpt_path,
                {"params": model.state_dict(), "opt_state": opt.state_dict(),
                 "best_params": best_params, "rng": gen.get_state()},
                {"epoch": epoch, "best_val": best_val, "best_epoch": best_epoch,
                 "history": hist, "init_consumed": init_consumed})

    model.eval()
    return VAETrainResult(
        params=best_params, last_params=_clone_state(model), history=hist,
        best_val=best_val, best_epoch=best_epoch,
        seconds=time.perf_counter() - t0)


@torch.no_grad()
def reconstruction_mse(
    model: TemporalVAE,
    Z,
    *,
    batch_size: int = 2048,
    sample: bool = False,
    generator: Optional[torch.Generator] = None,
    fused: str | bool = "auto",
    device=None,
) -> np.ndarray:
    """Per-window full MSE ``((Z - Z_hat)**2).mean(axis=(1, 2))``.

    The default ``sample=False`` scores the posterior-mean reconstruction;
    ``sample=True`` draws the reparameterisation noise from ``generator``.
    ``fused="auto"`` routes deterministic scoring on the card through the
    gate-only mode of the fused kernel of the model's cell
    (``with_residual=False``: no residual store), which raises for a cell or
    a shape it does not take;
    ``fused=False``, sampling, or the CPU run the model in padded batches of
    ``batch_size``. The model is moved to ``device``
    (None = the CUDA card) and put in eval mode.
    """
    device = resolve_device(device)
    Z = torch.as_tensor(Z, dtype=torch.float32).to(device)
    N = Z.shape[0]
    if N == 0:
        return np.zeros((0,), np.float32)
    model.to(device).eval()

    from shm_tpu_torch.ops import auto_fused_gate, fused_gate_for

    if fused == "auto":
        fused = auto_fused_gate(device)
    if fused and not sample:
        weights_fn, fused_gate = fused_gate_for(model)
        mse, _ = fused_gate(
            weights_fn(model), Z.contiguous(),
            num_layers=model.num_layers, use_layernorm=model.use_layernorm,
            with_residual=False)
        return mse.cpu().numpy().astype(np.float32)

    nb, pad = _batch_plan(N, batch_size)
    if pad:
        Z = torch.cat([Z, Z.new_zeros((pad,) + tuple(Z.shape[1:]))])
    out = []
    for xb in Z.reshape(nb, batch_size, *Z.shape[1:]):
        recon, _, _ = model(xb, sample=sample, generator=generator)
        out.append(((xb - recon) ** 2).mean(dim=(1, 2)))
    return torch.cat(out)[:N].cpu().numpy().astype(np.float32)


__all__ = [
    "kl_anneal_sigmoid", "make_optimizer", "ClippedAdam", "batch_loss",
    "draw_batch_noise", "train_vae", "reconstruction_mse", "VAETrainResult",
]
