"""Sharding-rule resolution (a port of ``repro/distributed/sharding.py``).

Model code annotates parameters with LOGICAL axes: "d" (FSDP over the
data axis) and "m" (tensor parallel over the model axis).  At launch time
these resolve against the physical mesh:

  single-pod (16,16) ("data","model"):   d -> "data",  m -> "model"
  multi-pod (2,16,16) ("pod","data","model"): batch over ("pod","data");
      params FSDP-shard over "data" only (each pod holds a replica of the
      FSDP shards, so the cross-pod axis carries only gradient reductions).

A spec is a ``PartitionSpec``: a tuple with one entry per tensor
dimension, each ``None`` (replicated), an axis name, or a tuple of axis
names (the dimension split over those mesh axes in order).  On a torch
``DeviceMesh`` a resolved spec becomes DTensor placements, one per mesh
dimension: ``Shard(d)`` on each mesh axis that tensor dimension ``d``
names, ``Replicate()`` on the others (``placements``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

__all__ = ["PartitionSpec", "resolve_specs", "named_shardings", "placements",
           "batch_spec", "AXIS_MAP_SINGLE", "AXIS_MAP_MULTI", "set_axis_map",
           "logical_constraint", "is_dtensor"]


class PartitionSpec(tuple):
    """One entry per tensor dimension: None, an axis name, or a tuple of
    axis names.  ``PartitionSpec("m", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# Launcher-installed logical->physical axis map.  Model code calls
# ``logical_constraint(x, "b", None, "m", ...)`` and gets its DTensor
# redistributed to that spec on its own mesh, or x unchanged when no map
# is installed or x is a plain tensor (one device).
_AXIS_MAP: Dict[str, Any] | None = None


def set_axis_map(axis_map: Optional[Dict[str, Any]]) -> None:
    global _AXIS_MAP
    _AXIS_MAP = axis_map


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor; a plain tensor is told apart without
    importing ``torch.distributed``."""
    if type(t).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def logical_constraint(x, *axes):
    if _AXIS_MAP is None or not is_dtensor(x):
        return x
    spec = P(*[(_AXIS_MAP.get(a, a) if isinstance(a, str) else a)
               for a in axes])
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


AXIS_MAP_SINGLE: Dict[str, Any] = {"d": "data", "m": "model",
                                   "b": ("data",)}
AXIS_MAP_MULTI: Dict[str, Any] = {"d": "data", "m": "model",
                                  "b": ("pod", "data")}


def _resolve_one(spec: PartitionSpec, axis_map: Dict[str, Any]
                 ) -> PartitionSpec:
    out = []
    for part in spec:
        if part is None:
            out.append(None)
        elif isinstance(part, str):
            out.append(axis_map.get(part, part))
        else:  # tuple of logical axes
            resolved = []
            for q in part:
                r = axis_map.get(q, q)
                resolved.extend(r if isinstance(r, tuple) else (r,))
            out.append(tuple(resolved))
    return P(*out)


def _tree_map(fn, tree):
    """``fn`` on every ``PartitionSpec`` leaf of nested dicts and lists
    (``None`` leaves stay None)."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if tree is None:
        return None
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def resolve_specs(tree, axis_map: Dict[str, Any]):
    """Map logical-axis PartitionSpecs to physical mesh axes."""
    return _tree_map(lambda s: _resolve_one(s, axis_map), tree)


def placements(spec: PartitionSpec, mesh) -> Tuple:
    """A resolved spec's DTensor placements on ``mesh`` (a ``DeviceMesh``
    with named dimensions): ``Shard(d)`` on every mesh axis that dimension
    ``d`` names, ``Replicate()`` on the rest.  Axes a spec names that the
    mesh lacks raise."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        for ax in ((part,) if isinstance(part, str) else part):
            if ax not in names:
                raise ValueError(f"spec {spec} names axis {ax!r}; mesh "
                                 f"has {names}")
            out[names.index(ax)] = Shard(d)
    return tuple(out)


def named_shardings(tree, mesh):
    """Attach a mesh to a resolved spec tree: each spec becomes its
    placements on ``mesh``."""
    return _tree_map(lambda s: placements(s, mesh), tree)


def batch_spec(mesh, *trailing: Optional[str]) -> PartitionSpec:
    """Batch-leading PartitionSpec over all DP axes of ``mesh``."""
    dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return P(dp, *trailing)
