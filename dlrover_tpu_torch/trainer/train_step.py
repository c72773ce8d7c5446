"""Training step on one device (port of
``dlrover_tpu/trainer/train_step.py``).

``step(state, batch) -> (state, metrics)`` as in the reference: the
batch's leading dim splits into ``grad_accum`` micro-batches whose
gradients average in f32, the global grad norm is taken on the averaged
(unclipped) gradients, then clip-by-global-norm and AdamW under a
warmup-cosine schedule update the f32 master params. PyTorch updates
the params and the optimizer moments in place (the reference returns
new arrays); the returned state is the same dict with ``step`` advanced.

The reference's mesh, sharding and ring-attention arguments are not
ported yet: this is the one-GPU path.
"""

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from dlrover_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    grad_accum: int = 1              # microbatches per step (fixed batch)


def warmup_cosine_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """lr as a function of the update count: optax's
    ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1), 100_000,
    0.1 * lr)``. Count 0 gives lr 0, so the first update moves nothing
    (the moments still take the first gradient)."""
    peak = tc.learning_rate
    warmup = max(tc.warmup_steps, 1)
    decay = 100_000 - warmup
    alpha = 0.0 if peak == 0.0 else (0.1 * peak) / peak

    def schedule(count: int) -> float:
        count = float(count)
        if count < warmup:
            frac = 1.0 - min(max(count, 0.0), warmup) / warmup
            return -peak * frac + peak
        c = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The param tree's tensors in a fixed order."""
    out = []
    for name in sorted(params):
        value = params[name]
        if isinstance(value, dict):
            out.extend(param_leaves(value))
        else:
            out.append(value)
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the summed squares of every element, in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor):
    """optax's clip, in place and without a host sync: ``g / norm *
    max_norm`` when ``norm >= max_norm``, else ``g`` unchanged (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    keep = norm < max_norm
    denom = torch.where(keep, torch.ones_like(norm), norm)
    mult = torch.where(keep, torch.ones_like(norm),
                       torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(denom).mul_(mult)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Clip by global norm, then AdamW on every leaf (decay unmasked)
    with the warmup-cosine lr: the reference's optax chain. ``init``
    builds the moments over the given params; ``update`` applies one
    step in place."""

    tc: TrainConfig

    @property
    def schedule(self):
        return warmup_cosine_schedule(self.tc)

    def init(self, params) -> torch.optim.AdamW:
        tc = self.tc
        return torch.optim.AdamW(
            param_leaves(params), lr=0.0, betas=(tc.beta1, tc.beta2),
            eps=1e-8, weight_decay=tc.weight_decay, foreach=True,
        )

    def update(self, opt_state: torch.optim.AdamW, params, grads,
               norm: torch.Tensor, count: int) -> None:
        """``grads`` in ``param_leaves`` order; ``count`` updates so far
        (the schedule's argument)."""
        clip_by_global_norm_(grads, self.tc.grad_clip, norm)
        leaves = param_leaves(params)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt_state.param_groups[0]["lr"] = self.schedule(count)
        opt_state.step()
        for p in leaves:
            p.grad = None


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


def init_train_state(config: llama.TpuLMConfig, optimizer: Optimizer,
                     params) -> Dict[str, Any]:
    """{"params", "opt_state", "step"} over ``params`` (f32 master
    params on one device; they become autograd leaves in place)."""
    llama.require_flat_stack(config)
    for p in param_leaves(params):
        if p.dtype != torch.float32:
            raise TypeError(f"master params must be f32, got {p.dtype}")
        p.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": 0}


def make_train_step(config: llama.TpuLMConfig, tc: TrainConfig,
                    optimizer: Optimizer, device="cuda",
                    loss_fn: Optional[Callable] = None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    batch["tokens"]: [grad_accum * micro_batch, seq + 1] int. Metrics:
    loss (mean over micro-batches), grad_norm (before clipping), step.
    The batch's "mask" is not used, as in the reference."""
    device = torch.device(device)
    _loss = loss_fn or (
        lambda params, batch: llama.loss_fn(config, params, batch)
    )

    def single_grad(params, leaves, micro):
        loss, _ = _loss(params, micro)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def step(state, batch):
        params = state["params"]
        leaves = param_leaves(params)
        tokens = torch.as_tensor(batch["tokens"]).to(device)
        ga = tc.grad_accum
        if ga > 1:
            if tokens.shape[0] % ga:
                raise ValueError(
                    f"batch {tokens.shape[0]} not divisible by grad_accum "
                    f"{ga}"
                )
            mb = tokens.shape[0] // ga
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(ga):
                l_i, g_i = single_grad(
                    params, leaves, {"tokens": tokens[i * mb:(i + 1) * mb]}
                )
                for acc, g in zip(grads, g_i):
                    acc.add_(g.float() / ga)
                loss = loss + l_i / ga
        else:
            loss, g_1 = single_grad(params, leaves, {"tokens": tokens})
            grads = list(g_1)

        grad_norm = global_norm(grads)
        optimizer.update(state["opt_state"], params, grads, grad_norm,
                         state["step"])
        new_state = dict(state, step=state["step"] + 1)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "step": new_state["step"]}
        return new_state, metrics

    return step


def make_eval_step(config: llama.TpuLMConfig, device="cuda"):
    """Returns ``ev(params, batch) -> ce`` (no gradients)."""
    device = torch.device(device)

    def ev(params, batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        with torch.no_grad():
            _, metrics = llama.loss_fn(config, params, batch)
        return metrics["ce"]

    return ev
