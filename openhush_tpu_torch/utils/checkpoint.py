"""Model and fine-tuning checkpoints, as npz.

The port of openhush_tpu/utils/checkpoint.py for the npz format only: the
reference's Orbax directories stay the JAX package's format. `load_params`
reads the npz that `model convert` writes, and with a mesh restores it onto
the mesh as the reference's `load_orbax(shardings=)` does: each rank keeps
only its shard on its device (the host reads the whole file: an npz member
cannot be read in part); `save_train_state` and `load_train_state` keep a fine-tune's
parameters, its optimizer state (training/train.py's `OptState`: `count`,
`mu`, `nu`) and its step in one npz, flattened by `save_npz`. bf16 leaves
are stored widened to fp32 (numpy has no bf16); `load_train_state` casts
every floating leaf to its `dtype`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from openhush_tpu_torch.models.whisper.weights import (from_numpy_params,
                                                       load_npz, save_npz)
from openhush_tpu_torch.parallel.sharding import shard_params


def _host(node):
    """A tensor tree → numpy arrays (bf16 widened to fp32)."""
    if isinstance(node, dict):
        return {k: _host(v) for k, v in node.items()}
    if torch.is_tensor(node):
        node = node.detach().cpu()
        if node.dtype == torch.bfloat16:
            node = node.float()
        return node.numpy()
    return np.asarray(node)


def load_params(path: str, mesh=None) -> dict:
    """A parameter tree (numpy arrays) from an npz file; with a mesh
    (parallel.sharding.create_mesh), this rank's shard of it
    (sharding.shard_params: tensors on the rank's device)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: Orbax checkpoints are the JAX "
            f"package's format; this package reads .npz files")
    params = load_npz(path)
    if mesh is None:
        return params
    return shard_params(params, mesh)


def save_train_state(path: str, params, opt_state, step: int) -> None:
    """Fine-tuning checkpoint (params + optimizer + step) in one npz."""
    tree = {"params": params,
            "opt_state": {"count": np.asarray(opt_state.count, np.int64),
                          "mu": {str(i): t for i, t in
                                 enumerate(opt_state.mu)},
                          "nu": {str(i): t for i, t in
                                 enumerate(opt_state.nu)}},
            "step": np.asarray(step, np.int64)}
    save_npz(_host(tree), path)


def load_train_state(path: str, dtype: torch.dtype = torch.float32,
                     device=None):
    """(params, OptState, step) from `save_train_state`'s npz, tensors of
    `dtype` on `device` (CUDA unless the caller asks for the CPU)."""
    from openhush_tpu_torch.training.train import OptState
    tree = load_npz(path)
    params = from_numpy_params(tree["params"], dtype, device)
    opt = tree["opt_state"]

    def moments(d):
        m = from_numpy_params(d, dtype, device)
        return [m[k] for k in sorted(m, key=int)]

    state = OptState(int(opt["count"]), moments(opt["mu"]),
                     moments(opt["nu"]))
    return params, state, int(tree["step"])
