"""Fine-tuning step for Whisper in PyTorch: the port of
openhush_tpu/training/train.py on one device.

Teacher-forced cross-entropy over decoder tokens (`loss_fn`), and the
optimizer the reference builds with optax: clip_by_global_norm(1.0), then
AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay on every leaf) under a
warmup-cosine learning rate that starts at 0. Parameters keep the JAX
package's nested dict layout (models/whisper/weights.py); the optimizer
works over its leaves, in the order jax.tree.leaves gives (sorted keys).
On the GPU the encoder's attention runs forward and backward on the flash
kernels (ops/flash_attention.py). Sharding over a mesh (the reference's
dp × tp) is not ported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from openhush_tpu_torch.models.whisper import model as whisper
from openhush_tpu_torch.models.whisper import weights
from openhush_tpu_torch.models.whisper.config import WhisperConfig

IGNORE_ID = -100

# The reference's clip_by_global_norm(1.0) and optax.adamw's defaults.
_MAX_NORM = 1.0
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def loss_fn(cfg: WhisperConfig, params, mel: torch.Tensor,
            tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL of the targets, IGNORE_ID masked out, over max(n_valid, 1)
    tokens: an all-ignored batch gives 0 (F.cross_entropy would give NaN).
    mel [B, n_mels, F], tokens and targets [B, S]."""
    logits = whisper.forward(cfg, params, mel, tokens)     # [B, S, Vp] fp32
    valid = targets != IGNORE_ID
    safe = torch.where(valid, targets, 0).long()
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -logprobs.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


@dataclasses.dataclass
class OptState:
    count: int                  # updates applied so far
    mu: list[torch.Tensor]      # first moments, one per leaf
    nu: list[torch.Tensor]      # second moments, one per leaf


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax.chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_
    schedule(0, lr, warmup_steps, decay_steps), weight_decay=weight_decay))
    at optax's arithmetic: the clip is g / ‖g‖ when ‖g‖ >= 1 (no epsilon),
    the bias corrections are taken in fp32, and the weight decay reaches
    every leaf (optax's mask is None)."""
    lr: float
    warmup_steps: int
    decay_steps: int
    weight_decay: float = 0.01

    def learning_rate(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps,
        decay_steps) at update `count`: 0 on the first update."""
        if count < self.warmup_steps:
            return self.lr * count / self.warmup_steps
        span = self.decay_steps - self.warmup_steps
        c = min(count - self.warmup_steps, span)
        return self.lr * 0.5 * (1 + math.cos(math.pi * c / span))

    def init(self, params) -> OptState:
        ps = leaves(params)
        return OptState(0, [torch.zeros_like(p) for p in ps],
                        [torch.zeros_like(p) for p in ps])

    @torch.no_grad()
    def apply(self, params, grads, state: OptState) -> None:
        """optax's update, added to the parameters in place one leaf at a
        time (no second copy of the model's updates is ever held); the
        count and every leaf's moments advance in place."""
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        keep = gnorm < _MAX_NORM
        step = -np.float32(self.learning_rate(state.count))
        state.count += 1
        n = np.float32(state.count)
        bc1 = float(np.float32(1) - np.float32(_B1) ** n)
        bc2 = float(np.float32(1) - np.float32(_B2) ** n)
        for g, mu, nu, p in zip(grads, state.mu, state.nu, leaves(params)):
            g = torch.where(keep, g, g / gnorm.to(g.dtype) * _MAX_NORM)
            mu.mul_(_B1).add_((1 - _B1) * g)
            nu.mul_(_B2).add_((1 - _B2) * g.square())
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
            p.add_((u + self.weight_decay * p) * float(step))


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.01,
                   warmup_steps: int = 100, total_steps: int = 10_000
                   ) -> Optimizer:
    return Optimizer(lr=lr, warmup_steps=warmup_steps,
                     decay_steps=max(total_steps, warmup_steps + 1),
                     weight_decay=weight_decay)


def value_and_grad(cfg: WhisperConfig, params, mel, tokens, targets
                   ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The loss and its gradient for every leaf (`leaves` order); a leaf the
    loss does not reach gets zeros, as jax.value_and_grad gives. Every leaf
    is left requiring a gradient."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(cfg, params, mel, tokens, targets)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, ps)]


def train_step(cfg: WhisperConfig, optimizer: Optimizer, params,
               opt_state: OptState, mel, tokens, targets):
    """One training step → (params, opt_state, loss). The parameters and
    the optimizer state are updated in place and returned: the port's
    counterpart of the reference's donate_argnames, which lets XLA reuse
    their buffers."""
    loss, grads = value_and_grad(cfg, params, mel, tokens, targets)
    optimizer.apply(params, grads, opt_state)
    return params, opt_state, loss


def init_train_state(cfg: WhisperConfig, optimizer: Optimizer,
                     generator: torch.Generator,
                     dtype: torch.dtype = torch.float32, device=None):
    """Random parameters (weights.init_params; on the GPU unless `device`
    says otherwise) and a fresh optimizer state."""
    params = weights.init_params(cfg, generator, dtype, device)
    return params, optimizer.init(params)
