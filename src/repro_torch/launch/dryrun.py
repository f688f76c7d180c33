"""Multi-pod dry-run (a port of ``repro/launch/dryrun.py``).

Traces every (architecture x input-shape x mesh) cell on the production
meshes -- (16, 16) single-pod and (2, 16, 16) multi-pod -- without a
device and without allocating: a ``fake`` process group of 256 or 512
ranks, the production ``DeviceMesh`` over it, and ``FakeTensorMode``.
The model, its train state, its inputs and (for decode) its caches are
DTensors placed by the resolved ``param_specs``, ``input_specs`` and
``cache_specs_physical``; the cell then runs the train step (forward,
backward and AdamW), the prefill step or the decode step once, on the
plain route (``set_scan_unroll(True)``: attention through
``_sdpa_direct``, the scans through their plain versions), with tensors
made inside treated as replicated (``implicit_replication``), and the
ops that DTensor cannot run as the plain code writes them sent to their
local forms (``launch.dtensor_route``).  Where the
reference compiles with XLA and reads its analyses, this port counts what
rank 0 runs:

* ``flops_per_device``: the flops of every op on the local shards
  (``torch.utils.flop_counter``'s formulas).  The model is unrolled, so
  the count covers every layer in one pass (``cost_unrolled: true``);
* ``bytes_per_device``: each op's local input and output bytes (views
  excluded).  Ops are not fused here, so this is larger than XLA's
  post-fusion "bytes accessed";
* ``collectives``: count and per-device operand bytes by kind (all-gather,
  reduce-scatter, all-reduce, all-to-all, collective-permute), read from
  the functional collectives that DTensor issues;
* ``memory``: the high-water mark of live local bytes over the step
  (arguments included), with the argument and output bytes beside it.

A cell that fails records ``error`` and ``traceback`` (these are bugs to
fix), and the CLI exits 1.  ``run_cell`` needs no default process group
and leaves none: it makes the fake one and destroys it.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \\
      --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import threading
import time
import traceback
import weakref
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..distributed.sharding import (AXIS_MAP_MULTI, AXIS_MAP_SINGLE,
                                    PartitionSpec as P, placements,
                                    resolve_specs, set_axis_map)
from ..models.config import ModelConfig
from ..models.model import (Model, param_specs, set_activation_spec,
                            set_scan_unroll)
from ..models.registry import get_config, list_archs
from .shapes import (SHAPES, cache_specs_physical, cache_structs,
                     input_specs, skip_reason)

__all__ = ["run_cell", "CostCounter", "main"]

# functional collectives -> the reference's HLO collective kinds
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
    "broadcast": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class _Propagating(threading.local):
    depth = 0


_PROPAGATING = _Propagating()


@contextlib.contextmanager
def _mark_sharding_propagation():
    """DTensor works out each op's global output shape by running the op
    on global-shape fake tensors (``ShardingPropagator``); those ops run
    on no device and must not be counted.  This marks them for the
    counter while the cell runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        orig = ShardingPropagator.__dict__.get(name)
        if orig is not None:
            break
    else:
        raise RuntimeError("this torch's ShardingPropagator has no "
                           "tensor-meta propagation to mark")

    def marked(self, *a, **k):
        _PROPAGATING.depth += 1
        try:
            return orig(self, *a, **k)
        finally:
            _PROPAGATING.depth -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class CostCounter:
    """What rank 0 runs, op by op, on its local tensors: flops, bytes in
    and out, functional collectives by kind, and the live bytes of the
    storages the ops make (``track`` adds arguments).  Use as a context
    manager around the step; ops on DTensors pass through to DTensor,
    whose local ops come back here."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._seen: set = set()
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if not _PROPAGATING.depth:
                    counter._count(func, args, kwargs, out, flop_registry)
                return out

        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def track(self, tree) -> int:
        """Count the local storages of ``tree``'s tensors as live; returns
        their bytes (each storage once)."""
        total = 0
        for t in _tensors(tree):
            total += self._track_storage(_local(t))
        return total

    def _track_storage(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return 0
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)
        return n

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def _count(self, func, args, kwargs, out, flop_registry):
        packet = func.overloadpacket
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            name = packet.__name__
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                ins = list(_tensors(args))
                e = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
                e["count"] += 1
                e["bytes"] += sum(_nbytes(t) for t in ins)
        elif ns == "aten" and not func.is_view and packet is not \
                torch.ops.aten.detach:
            f = flop_registry.get(packet)
            if f is not None:
                self.flops += int(f(*args, **kwargs, out_val=out))
            self.bytes += sum(_nbytes(t) for t in _tensors(args))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            if t.device.type != "meta":
                self._track_storage(t)


@contextlib.contextmanager
def _fake_world(n: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists: the dry-run "
                           "makes its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _moments_dtype(cfg: ModelConfig) -> str:
    # int8 moments above 100B params, as the reference's optimizer config
    return "int8" if cfg.param_count() > 100e9 else "fp32"


def _opt_spec(s: P, moments_dtype: str):
    scale_spec = P(*(tuple(s)[:-1] + (None,))) if len(s) else P()
    if moments_dtype == "int8":
        q = {"q": s, "scale": scale_spec}
        return {"m": q, "v": q}
    return {"m": s, "v": s}


def _distribute(t: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh))


def _distribute_model(model: Model, mesh, pspecs: Dict[str, P]) -> None:
    mods = dict(model.named_modules())
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        setattr(mods[owner], attr, torch.nn.Parameter(
            _distribute(p.detach(), mesh, pspecs[name]),
            requires_grad=p.requires_grad))


def _fake_inputs(structs, specs, mesh):
    return {k: _distribute(torch.zeros(s.shape, dtype=s.dtype), mesh,
                           specs[k]) for k, s in structs.items()}


def _mesh_for(multi_pod: bool, mesh_shape: Optional[Sequence[int]]):
    from torch.distributed.device_mesh import init_device_mesh
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if mesh_shape is None:
        from .mesh import make_production_mesh
        return make_production_mesh(multi_pod=multi_pod)
    if len(mesh_shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(mesh_shape)} does not name "
                         f"the axes {axes}")
    return init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=axes)


def _run(cfg: ModelConfig, shape: str, multi_pod: bool, mesh,
         counter: CostCounter) -> Tuple[int, int]:
    """Build the cell's state on ``mesh`` under the ambient fake mode and
    run its step once inside ``counter``.  Returns (argument bytes,
    output bytes)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..optim.adamw import AdamWConfig, init_opt_state
    from ..serve.step import make_decode_step, make_prefill_step
    from ..train.step import make_train_step
    from .dtensor_route import routes
    from .tuning import KNOBS

    case = SHAPES[shape]
    axis_map = AXIS_MAP_MULTI if multi_pod else AXIS_MAP_SINGLE
    pspecs = resolve_specs(param_specs(cfg), axis_map)
    b_axes = ("pod", "data") if multi_pod else ("data",)
    n_dp = 32 if multi_pod else 16
    act_batch = b_axes if case.global_batch % n_dp == 0 else None
    act_spec = {"seq": P(act_batch, "model", None),
                "dmodel": P(act_batch, None, "model"),
                "batch": P(act_batch, None, None)}[KNOBS.act_mode]
    set_activation_spec(placements(act_spec, mesh))
    set_axis_map({"b": act_batch, "m": "model", "d": "data"})

    model = Model(cfg, device="cpu", generator=None)
    _distribute_model(model, mesh, pspecs)
    structs, in_specs = input_specs(cfg, shape, multi_pod=multi_pod)
    inputs = _fake_inputs(structs, in_specs, mesh)
    ctx_key = next((k for k in structs if k in ("frames", "vision_embeds")),
                   None)
    with implicit_replication(), routes():
        if case.mode == "train":
            opt_cfg = AdamWConfig(moments_dtype=_moments_dtype(cfg))
            opt = init_opt_state(model, opt_cfg)
            opt["mu"] = {n: _place_moments(mu, mesh, _opt_spec(
                pspecs[n], opt_cfg.moments_dtype))
                for n, mu in opt["mu"].items()}
            state = {"params": model, "opt": opt,
                     "step": torch.zeros((), dtype=torch.int32)}
            args = (list(model.parameters()), opt, inputs)
            arg_bytes = counter.track(args)
            step = make_train_step(cfg, opt_cfg,
                                   microbatches=KNOBS.microbatches)
            with counter:
                state, metrics = step(state, inputs)
            out = (list(model.parameters()), state["opt"], metrics)
        elif case.mode == "prefill":
            caches = _fake_caches(cfg, case, multi_pod, mesh)
            ctx = inputs.get(ctx_key)
            arg_bytes = counter.track((list(model.parameters()), inputs,
                                       caches))
            pf = _no_grad(make_prefill_step(cfg, case.seq_len))
            with counter:
                out = pf(model, inputs["tokens"], ctx, caches)
        else:
            caches = _fake_caches(cfg, case, multi_pod, mesh)
            ctx = inputs.get(ctx_key)
            arg_bytes = counter.track((list(model.parameters()), inputs,
                                       caches))
            dec = _no_grad(make_decode_step(cfg))
            with counter:
                out = dec(model, inputs["tokens"], inputs["pos"], caches,
                          ctx)
    out_bytes = sum(_nbytes(_local(t)) for t in _tensors(out))
    return arg_bytes, out_bytes


def _no_grad(step):
    """A serving step's body under ``no_grad`` instead of its
    ``inference_mode`` (DTensor cannot make inference tensors)."""
    return torch.no_grad()(step.__wrapped__)


def _place_moments(mu, mesh, spec):
    if isinstance(mu, dict):
        return {k: _place_moments(v, mesh, spec[k]) for k, v in mu.items()}
    return _distribute(mu, mesh, spec)


def _fake_caches(cfg: ModelConfig, case, multi_pod: bool, mesh):
    specs = cache_specs_physical(cfg, case.global_batch,
                                 multi_pod=multi_pod)
    out = []
    for st, sp in zip(cache_structs(cfg, case.global_batch, case.seq_len),
                      specs):
        out.append(None if st is None else
                   {k: _distribute(torch.zeros(s.shape, dtype=s.dtype),
                                   mesh, sp[k]) for k, s in st.items()})
    return out


def run_cell(arch: str, shape: str, multi_pod: bool = False, *,
             cfg: Optional[ModelConfig] = None,
             mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """Trace one cell and return its record.  ``cfg`` replaces
    ``get_config(arch)`` (the tests pass ``reduced()`` configs);
    ``mesh_shape`` replaces the production mesh's shape, keeping its axis
    names (``(1, 1)`` is a mesh of one device)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch) if cfg is None else cfg
    shp = tuple(mesh_shape) if mesh_shape is not None else \
        ((2, 16, 16) if multi_pod else (16, 16))
    n = 1
    for s in shp:
        n *= s
    rec = {"arch": arch, "shape": shape,
           "mesh": "x".join(str(s) for s in shp), "n_devices": n}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["skipped"] = reason
        return rec
    t0 = time.time()
    try:
        with _fake_world(n), _mark_sharding_propagation():
            mesh = _mesh_for(multi_pod, mesh_shape)
            counter = CostCounter()
            set_scan_unroll(True)
            with FakeTensorMode(allow_non_fake_inputs=True):
                arg_bytes, out_bytes = _run(cfg, shape, multi_pod, mesh,
                                            counter)
        rec.update({
            "trace_s": round(time.time() - t0, 2),
            "flops_per_device": float(counter.flops),
            "bytes_per_device": float(counter.bytes),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "peak_bytes": counter.peak},
            "collectives": counter.collectives,
            "cost_unrolled": True,
        })
    except Exception as e:  # record the failure: these are bugs to fix
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-6000:]
    finally:
        set_scan_unroll(False)
        set_activation_spec(None)
        set_axis_map(None)
        gc.collect()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    ok = skip = fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{'multi' if mp else 'single'}_{arch}_{shape}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    if "error" not in rec:
                        print(f"[cached] {tag}")
                        ok += 0 if "skipped" in rec else 1
                        skip += 1 if "skipped" in rec else 0
                        continue
                rec = run_cell(arch, shape, mp)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if "skipped" in rec:
                    skip += 1
                    print(f"[skip]   {tag}: {rec['skipped'][:60]}")
                elif "error" in rec:
                    fail += 1
                    print(f"[FAIL]   {tag}: {rec['error'][:200]}")
                else:
                    ok += 1
                    peak_gb = rec["memory"]["peak_bytes"] / 2**30
                    print(f"[ok]     {tag}: trace={rec['trace_s']}s "
                          f"peak={peak_gb:.2f}GiB/dev "
                          f"flops/dev={rec['flops_per_device']:.3g}")
    print(f"\ndry-run: {ok} ok, {skip} skipped, {fail} FAILED")
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()
