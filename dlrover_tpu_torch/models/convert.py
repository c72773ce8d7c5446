"""Parameter trees and train states between the reference's numpy
arrays and the port's tensors.

The JAX package's params (``jax.device_get`` gives nested dicts of
numpy arrays) become the port's tensors leaf for leaf, and back. numpy
has no native bf16: such arrays (the ``ml_dtypes`` bfloat16 dtype that
JAX returns) cross bit for bit through a uint16 view.

A whole train state crosses too: the reference's ``{"params",
"opt_state", "step"}``, whose ``opt_state`` is the optax chain of
clip-by-global-norm and AdamW (the clip's empty state, then
``ScaleByAdamState(count, mu, nu)``, the decay's empty state and the
schedule's ``ScaleByScheduleState(count)``), maps to the port's
``{"params", "opt_state": torch.optim.AdamW, "step"}``. The optax
states are found by their fields, so this module needs no optax.
Under a mesh each rank takes only its own slices of the numpy arrays,
as ``train_step.state_specs`` lays them out, and the way back gathers
every DTensor whole (a collective: every rank calls it).

Pipeline stages store the layer leaves ``[stages, layers_per_stage,
...]`` in both packages; :func:`to_stage_layout` and
:func:`to_flat_layout` move a param tree (numpy arrays or tensors)
between that layout and the flat ``[L, ...]`` one.
"""

from typing import Any

import numpy as np
import torch


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_stage_layout(params, stages: int):
    """``params`` with each layer leaf ``[L, ...]`` reshaped to
    ``[stages, L / stages, ...]`` (the reference's ``pp_stages > 1``
    layout)."""
    layers = {}
    for k, w in params["layers"].items():
        if w.shape[0] % stages:
            raise ValueError(f"{w.shape[0]} layers not divisible by "
                             f"{stages} stages")
        layers[k] = w.reshape((stages, w.shape[0] // stages)
                              + tuple(w.shape[1:]))
    return dict(params, layers=layers)


def to_flat_layout(params):
    """Inverse of :func:`to_stage_layout`: layer leaves ``[stages,
    layers_per_stage, ...]`` back to ``[L, ...]``."""
    return dict(params, layers={
        k: w.reshape((w.shape[0] * w.shape[1],) + tuple(w.shape[2:]))
        for k, w in params["layers"].items()})


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts/lists of numpy arrays -> the same tree of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _to_tensor(tree, device)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_numpy` (host numpy arrays)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return _to_numpy(tree)


def _adam_state(opt_state):
    """The optax state with ``mu`` and ``nu`` inside a chain's tuples."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (list, tuple)):
        for child in opt_state:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def params_from_numpy_sharded(config, tree: Any, mesh) -> Any:
    """A param-structured tree of numpy arrays as DTensors on ``mesh``
    laid out by ``llama.param_axes``: each rank keeps its own slice of
    each array."""
    from dlrover_tpu_torch.trainer.train_step import (
        _mesh_device,
        shard_params,
    )

    return shard_params(config, params_from_numpy(tree, _mesh_device(mesh)),
                        mesh)


def train_state_from_numpy(config, tree: Any, optimizer, device="cuda",
                           mesh=None):
    """The reference's train state (after ``jax.device_get``) as the
    port's: f32 params on ``device`` under ``train_step.init_train_state
    (config, optimizer, ...)``, AdamW's per-leaf ``exp_avg``,
    ``exp_avg_sq`` and ``step`` from optax's ``mu``, ``nu`` and
    ``count``, and ``step``. With ``mesh`` (whose device replaces
    ``device``) params and moments are this rank's slices, as
    DTensors."""
    from dlrover_tpu_torch.trainer import train_step as ts

    adam = _adam_state(tree["opt_state"])
    if adam is None:
        raise ValueError("opt_state holds no Adam state (mu, nu)")
    if mesh is None:
        def leaves(t):
            return params_from_numpy(t, device)
    else:
        def leaves(t):
            return params_from_numpy_sharded(config, t, mesh)
    params = leaves(tree["params"])
    state = ts.init_train_state(config, optimizer, params, mesh=mesh)
    count = float(np.asarray(adam.count))
    ts.load_state_tree_(state, {
        "params": params,
        "opt_state": {
            "exp_avg": leaves(adam.mu),
            "exp_avg_sq": leaves(adam.nu),
            "step": ts.params_like(params, lambda p: torch.tensor(count)),
        },
        "step": int(np.asarray(tree["step"])),
    })
    return state


def _with_counts(opt_state, adam_count, schedule_count, mu, nu):
    """``opt_state`` (an optax chain's states) with the Adam state's
    count, mu and nu and every other state's count replaced."""
    fields = getattr(opt_state, "_fields", None)  # a NamedTuple's
    if fields is not None and {"mu", "nu"} <= set(fields):
        return opt_state._replace(
            count=np.asarray(adam_count, np.asarray(opt_state.count).dtype),
            mu=mu, nu=nu)
    if fields is not None and "count" in fields:
        return opt_state._replace(count=np.asarray(
            schedule_count, np.asarray(opt_state.count).dtype))
    if isinstance(opt_state, tuple) and fields is None:
        return tuple(_with_counts(c, adam_count, schedule_count, mu, nu)
                     for c in opt_state)
    return opt_state


def train_state_to_numpy(state, like=None):
    """The port's train state as numpy trees: the inverse of
    :func:`train_state_from_numpy`. With ``like`` (a reference train
    state, e.g. the one converted from) the result has its structure and
    dtypes, optax states included; without it ``opt_state`` is
    ``{"count", "mu", "nu"}``."""
    from dlrover_tpu_torch.trainer import train_step as ts

    view = ts.state_tree(state)
    mu = params_to_numpy(view["opt_state"]["exp_avg"])
    nu = params_to_numpy(view["opt_state"]["exp_avg_sq"])
    counts = {int(t) for t in ts.param_leaves(view["opt_state"]["step"])}
    if len(counts) != 1:
        raise ValueError(f"AdamW leaves at different counts {counts}")
    count = counts.pop()
    params = params_to_numpy(view["params"])
    if like is None:
        return {"params": params,
                "opt_state": {"count": count, "mu": mu, "nu": nu},
                "step": state["step"]}
    return {
        "params": params,
        "opt_state": _with_counts(like["opt_state"], count, state["step"],
                                  mu, nu),
        "step": np.asarray(state["step"], np.asarray(like["step"]).dtype),
    }
