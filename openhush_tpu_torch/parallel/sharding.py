"""The (data, model) mesh, its parameter rules and its collectives: the port
of openhush_tpu/parallel/sharding.py.

The reference lays a JAX mesh over its devices and lets GSPMD insert the
collectives. Here each device is a rank of a torch.distributed world
(parallel/world.py) and a mesh is a 2-D
`torch.distributed.device_mesh.DeviceMesh` over the ranks, shaped (data,
model). Each rank holds

- its `model`-axis shard of the parameters, by the reference's rules: q, k,
  v, fc1 (and the cross-attention's xq, xk, xv) column-parallel (their
  output columns split), o, xo and fc2 row-parallel (their input rows
  split), everything else replicated;
- its `data`-axis share of the batch, the slots or the beam groups.

The hand kernels then run on the rank's local (batch, head) block, as a
plain local call on raw tensors: the reference's `shard_map` around the
encoder's flash kernel is this same per-device call, so explicit tensor
parallelism makes `enable_sharded_flash`/`disable_sharded_flash` moot, and
they are not ported. A batch that does not divide over the data axis (the
case the reference's wrapper falls back on) cannot be split here:
`data_sharding` raises, and the caller runs the whole batch on every data
rank instead, which gives the single device's numbers.

The collectives GSPMD inserts are the two autograd Functions below, a pair
around every tensor-parallel block (Megatron's f and g): `copy_to_model`
before a column-parallel product (identity forward, all-reduce of the
gradient over `model` backward) and `reduce_from_model` after a
row-parallel one (all-reduce forward, identity backward). The row-parallel
bias is added once, after the reduce. Both are no-ops without a model
group, so a replicated model (a draft, or an int8 stack the rules leave
whole) runs beside a sharded one with no collective. The model group
travels with the sharded parameters (`ShardedParams.mesh`), not in a module
global.

State layout: the reference's `shard_slot_state` keeps the greedy caches
replicated over `model` and its `shard_beam_state` splits their heads. Here
both split the big model's caches and cross-KV over heads, as
`cache_spec`/`kv_scale_spec` describe, because a rank computes only its own
heads' keys and values; the numbers are the same. Both take the sharded
parameters that will step the state, and read from them whether the
decoder's heads were split: an int8 decoder, which the rules leave whole,
keeps whole caches. A draft's state (the `d_*` fields) stays whole over
`model`, as its parameters do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from openhush_tpu_torch.device import resolve_device
from openhush_tpu_torch.parallel import world

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = tuple                 # the reference's PartitionSpec: an axis name
REPLICATED: Spec = ()        # or None per dimension; () is replicated


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of a (data, model) mesh: the DeviceMesh, the rank's
    device and coordinate, and its two groups (None where the axis has
    size 1: nothing to reduce). `coordinate` is None on a rank of the
    world that is not in the mesh (a sub-mesh)."""
    device_mesh: DeviceMesh
    device: torch.device
    n_data: int
    n_model: int
    coordinate: Optional[tuple[int, int]]
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]

    @property
    def data_rank(self) -> int:
        return self.coordinate[0]

    @property
    def model_rank(self) -> int:
        return self.coordinate[1]


def create_mesh(n_model: Optional[int] = None, device=None,
                backend: Optional[str] = None,
                ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh over all (or the given) ranks of the world, shaped [data,
    model], with the reference's default model axis (1 for one rank, else
    min(4, n)). Every rank of the world (parallel.world.run_world starts
    them) must call it, members or not: the groups are made collectively.
    `device` None means CUDA. `backend` must agree with the world's
    (world.resolve_backend: NCCL refuses two ranks on one card)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: run the ranks with "
                           "parallel.world.run_world (or init_world)")
    actual = dist.get_backend()
    if backend is not None and backend != actual:
        raise ValueError(f"the world runs {actual}, not {backend}")
    world.resolve_backend(dev, dist.get_world_size(), actual)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if n_model is None:
        n_model = 1 if n == 1 else min(4, n)
    if n % n_model:
        raise ValueError(f"{n} devices not divisible by model={n_model}")
    n_data = n // n_model
    # Groups on the world's backend: gloo groups are "cpu" meshes, and take
    # CUDA tensors all the same.
    kind = "cuda" if actual == "nccl" else "cpu"
    names = (DATA_AXIS, MODEL_AXIS)
    if ranks == list(range(dist.get_world_size())):
        dm = init_device_mesh(kind, (n_data, n_model), mesh_dim_names=names)
    else:
        dm = DeviceMesh(kind, torch.tensor(ranks).view(n_data, n_model),
                        mesh_dim_names=names)
    coord = dm.get_coordinate()
    group = lambda axis, size: (dm.get_group(axis)
                                if coord is not None and size > 1 else None)
    return Mesh(dm, dev, n_data, n_model,
                None if coord is None else tuple(coord),
                group(DATA_AXIS, n_data), group(MODEL_AXIS, n_model))


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# Leaf name → spec over the stacked [L, in, out] / [L, out] layer weights
# (their leading L axis is never split).
_LAYER_RULES = {
    # column-parallel (output dim = heads / ffn hidden)
    "q_w": (None, None, MODEL_AXIS), "q_b": (None, MODEL_AXIS),
    "k_w": (None, None, MODEL_AXIS),
    "v_w": (None, None, MODEL_AXIS), "v_b": (None, MODEL_AXIS),
    "xq_w": (None, None, MODEL_AXIS), "xq_b": (None, MODEL_AXIS),
    "xk_w": (None, None, MODEL_AXIS),
    "xv_w": (None, None, MODEL_AXIS), "xv_b": (None, MODEL_AXIS),
    "fc1_w": (None, None, MODEL_AXIS), "fc1_b": (None, MODEL_AXIS),
    # row-parallel (input dim sharded, output reduced)
    "o_w": (None, MODEL_AXIS, None),
    "xo_w": (None, MODEL_AXIS, None),
    "fc2_w": (None, MODEL_AXIS, None),
}


def param_spec(params) -> dict:
    """Spec tree matching a Whisper param tree (the reference's walk: a
    leaf's rule by its name; an int8 weight's inner "q" and "s" match
    none)."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _LAYER_RULES.get(name, REPLICATED)
    return walk(params)


def _is_int8(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "s"}


def _applied_spec(params) -> dict:
    """param_spec as shard_params applies it: a layer stack that holds an
    int8 weight ({"q", "s"}) stays whole, biases included, so that it runs
    whole on every rank with no collective (the reference splits its
    biases and lets GSPMD gather them back)."""
    def walk(node, spec, whole=False):
        if not isinstance(node, dict):
            return REPLICATED if whole else spec
        whole = whole or any(_is_int8(v) for v in node.values())
        return {k: walk(v, spec[k], whole) for k, v in node.items()}
    return walk(params, param_spec(params))


class ShardedParams(dict):
    """A rank's shard of a parameter tree (a dict, as the model takes it),
    with the mesh it lies on and the spec each leaf was cut by."""
    mesh: Mesh
    specs: dict


def _split(a, spec: Spec, mesh: Mesh):
    """This rank's block of a leaf: its `model` axis cut in n_model
    head-contiguous parts."""
    if MODEL_AXIS not in spec:
        return a
    axis = spec.index(MODEL_AXIS)
    size = a.shape[axis]
    if size % mesh.n_model:
        raise ValueError(f"a leaf of shape {tuple(a.shape)} does not split "
                         f"over a model axis of {mesh.n_model}")
    part = size // mesh.n_model
    index = [slice(None)] * len(a.shape)
    index[axis] = slice(mesh.model_rank * part, (mesh.model_rank + 1) * part)
    return a[tuple(index)]


def _tensor(a, device: torch.device):
    if torch.is_tensor(a):
        t = a.detach()
    else:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":     # ml_dtypes bf16: no numpy twin
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device).clone(memory_format=torch.contiguous_format)


def shard_params(params, mesh: Mesh) -> ShardedParams:
    """Place a parameter tree (numpy or torch, on any device) on this
    rank's device with the model-axis split: each leaf's columns or rows
    for this rank, as contiguous tensors of their own, in the leaf's
    dtype."""
    if getattr(params, "mesh", None) is not None:
        raise ValueError("these parameters are a rank's shard already: "
                         "shard the whole tree")
    specs = _applied_spec(params)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return _tensor(_split(node, spec, mesh), mesh.device)

    out = ShardedParams(walk(params, specs))
    out.mesh, out.specs = mesh, specs
    return out


# ---------------------------------------------------------------------------
# Batches, caches and serving state
# ---------------------------------------------------------------------------

def data_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch of `batch` rows (the reference's
    batch-on-'data' sharding)."""
    if batch % mesh.n_data:
        raise ValueError(f"a batch of {batch} does not split over a data "
                         f"axis of {mesh.n_data}: give each data rank the "
                         f"whole batch, or a batch that divides")
    rows = batch // mesh.n_data
    return slice(mesh.data_rank * rows, (mesh.data_rank + 1) * rows)


def _heads(mesh: Mesh, width: int) -> slice:
    if width % mesh.n_model:
        raise ValueError(f"{width} columns do not split over a model axis "
                         f"of {mesh.n_model}")
    part = width // mesh.n_model
    return slice(mesh.model_rank * part, (mesh.model_rank + 1) * part)


def cache_spec(mesh: Mesh, batch: int, width: int) -> tuple:
    """This rank's block of a flat KV cache [L, B, T, H*Dh]: batch rows on
    data, the head-contiguous feature columns on model (head h owns
    columns h*Dh:(h+1)*Dh, so a model-axis split is a split over head
    groups). An index for the cache."""
    return (slice(None), data_sharding(mesh, batch), slice(None),
            _heads(mesh, width))


def kv_scale_spec(mesh: Mesh, batch: int, n_head: int) -> tuple:
    """This rank's block of quantized-KV scales [L, B, T, H]: heads on
    model, aligned with cache_spec's head groups."""
    return cache_spec(mesh, batch, n_head)


def local_slot(mesh: Mesh, slot: int, n_slots: int) -> Optional[int]:
    """A global slot (or beam group) index → this rank's local index, or
    None when another data rank holds it."""
    rows = data_sharding(mesh, n_slots)
    return slot - rows.start if rows.start <= slot < rows.stop else None


def _shard_state(state, mesh: Mesh, n_rows: dict, layer_fields: dict,
                 head_fields: set):
    """A rank's block of a batcher state (a dataclass): each field in
    `layer_fields` ([L, rows, ...], rows counted by n_rows[name]) splits its
    axis 1 over data; of those, `head_fields` split their head-contiguous
    last axis over model (not a [.., 1, 1] placeholder); any other field
    whose axis 0 has one of n_rows' counts splits it over data (host lists
    too); the rest stays whole. Tensors are contiguous copies on the
    mesh's device."""
    out = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name)
        if f.name in layer_fields:
            rows = n_rows[layer_fields[f.name]]
            if a.shape[1] == rows:
                idx = [slice(None), data_sharding(mesh, rows)]
                if f.name in head_fields and a.shape[-1] > 1:
                    idx += [slice(None)] * (a.dim() - 3)
                    idx.append(_heads(mesh, a.shape[-1]))
                a = a[tuple(idx)]
        elif len(a) in n_rows.values():
            a = a[data_sharding(mesh, len(a))]
        out[f.name] = (a.to(mesh.device).contiguous().clone()
                       if torch.is_tensor(a) else list(a))
    return type(state)(**out)


_SLOT_CACHES = ("cache_k", "cache_v", "cache_ks", "cache_vs", "xkv_k",
                "xkv_ks", "xkv_v", "xkv_vs")
_DRAFT_CACHES = ("d_cache_k", "d_cache_v", "d_xkv_k", "d_xkv_ks", "d_xkv_v",
                 "d_xkv_vs")


def _heads_split(params: ShardedParams) -> bool:
    """Whether shard_params cut the decoder stack over `model` (an int8
    stack it leaves whole, and its caches stay whole with it)."""
    spec = params.specs["decoder"]["layers"]["q_w"]
    return isinstance(spec, tuple) and MODEL_AXIS in spec


def shard_slot_state(state, params: ShardedParams, n_slots: int):
    """A rank's block of a continuous-batching SlotState, for the sharded
    `params` that will step it (their mesh): slots over data (the
    multi-chip serving layout: sessions across devices, weights TP within),
    the big model's caches and cross-KV over heads as cache_spec says
    where the decoder's heads are split (not for an int8 decoder, which
    runs whole), the draft's caches whole over model. The host lists
    (temperatures, generators, fresh flags) keep the rank's slots. Slot s
    is local slot local_slot(mesh, s, n_slots) of its data rank."""
    fields = {f: "slots" for f in _SLOT_CACHES + _DRAFT_CACHES}
    heads = set(_SLOT_CACHES) if _heads_split(params) else set()
    return _shard_state(state, params.mesh, {"slots": n_slots}, fields,
                        heads)


_BEAM_ROWS = {"cache_k": "rows", "cache_v": "rows", "cache_ks": "rows",
              "cache_vs": "rows", "xkv_k": "groups", "xkv_ks": "groups",
              "xkv_v": "groups", "xkv_vs": "groups"}


def shard_beam_state(state, params: ShardedParams, n_groups: int,
                     beam_size: int):
    """A rank's block of a beam-serving BeamState, for the sharded `params`
    that will step it (their mesh): GROUPS over data, at group boundaries
    (requires n_groups % n_data == 0), so every beam expansion's cross-row
    work (top-k over K·V candidates, the reorder gathers) stays on one rank
    and only the weights' TP collectives cross devices; the [L, G*K, ...]
    caches and [L, G, ...] cross-KV split their row axis over data and,
    as shard_slot_state's, their heads over model. Placement is by field
    name: shape-sniffing misfires when K == G or L == G."""
    mesh = params.mesh
    if n_groups % mesh.n_data:
        raise ValueError(f"n_groups={n_groups} not divisible by the data "
                         f"axis ({mesh.n_data}); beam groups must not "
                         f"straddle devices")
    gk = n_groups * beam_size
    # Coverage guard: a future [L, G*K|G, ...] BeamState field missing from
    # _BEAM_ROWS would fall through to the axis-0 rule: kept whole, or
    # split over its LAYER axis when L is G or G*K. Catch it here.
    n_layers = state.cache_k.shape[0]
    for f in dataclasses.fields(state):
        a = getattr(state, f.name)
        if (f.name not in _BEAM_ROWS and torch.is_tensor(a) and a.dim() >= 2
                and a.shape[0] == n_layers and a.shape[1] in (gk, n_groups)):
            raise AssertionError(
                f"BeamState.{f.name} looks like a per-layer row-dim buffer "
                f"(shape {tuple(a.shape)}) but is not in shard_beam_state's "
                f"row fields: add it (its row dim must split over 'data')")
    heads = set(_BEAM_ROWS) if _heads_split(params) else set()
    return _shard_state(state, mesh, {"rows": gk, "groups": n_groups},
                        _BEAM_ROWS, heads)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Sum `t` over `group` into a new contiguous tensor; counts the calls
    and bytes (`all_reduce.calls`, `all_reduce.bytes`)."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    all_reduce.calls += 1
    all_reduce.bytes += out.numel() * out.element_size()
    return out


all_reduce.calls = 0
all_reduce.bytes = 0


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group: Optional[dist.ProcessGroup]
                  ) -> torch.Tensor:
    """Before a column-parallel product: x itself forward; its gradient
    summed over the model group backward (every rank's columns add to it).
    A no-op without a group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Optional[dist.ProcessGroup]
                      ) -> torch.Tensor:
    """After a row-parallel product: the ranks' partial sums added over the
    model group forward; the gradient as it is backward (each rank's
    partial reaches the sum once; torch.distributed.nn's all_reduce would
    sum it again, n_model times too large). A no-op without a group."""
    return x if group is None else _ReduceFromModel.apply(x, group)
