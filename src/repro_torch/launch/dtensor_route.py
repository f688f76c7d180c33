"""The dry-run's DTensor route (``launch.dryrun``): what the model's
plain code needs in order to run on DTensors, applied only while a cell
runs, so that the layers, the model and the numerics know nothing of it.

``routes()`` is a context manager.  For its duration it

* swaps four functions of the model for their DTensor forms:
  ``layers.einsum`` (one local einsum per rank, ``einsum`` below; plain
  operands still take ``numerics.einsum``), ``_embed`` in
  ``models.model`` and ``serve.step`` (the lookup on local shards),
  ``model._chunked_ce`` (the cross-entropy of each rank's rows) and
  ``model.checkpoint`` (the remat's recomputation runs under the mode
  below too);
* installs ``_Ops``, a ``TorchFunctionMode`` that sends five tensor ops,
  when their first argument is a DTensor, to forms that DTensor runs the
  same way on torch 2.11 and 2.13: ``Tensor.reshape`` (shards kept only
  where DTensor can keep them), ``torch.cumsum`` (rank by rank: torch
  2.11's DTensor has no ``flip``, which the backward of its own needs),
  ``F.pad`` of the sequence (a concatenation with zeros: DTensor's
  ``constant_pad_nd`` differs across versions), ``Tensor.index_copy_``
  of cache rows (rank by rank: DTensor has no sharded ``index_copy_``)
  and ``torch._assert_async`` (``prefill_step``'s check that the caches
  it is given are empty; rank by rank: DTensor has no rule for it).
  Every other call, and every call on plain tensors, passes through.

Nothing here runs outside a dry-run cell.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .. import numerics
from ..distributed.sharding import is_dtensor

__all__ = ["routes", "einsum", "wrap_local"]


def wrap_local(local: torch.Tensor, mesh, placements, shape
               ) -> torch.Tensor:
    """A DTensor of global ``shape`` (contiguous) whose rank-local part is
    the contiguous ``local``, with no check and no communication."""
    from torch.distributed.tensor import DTensor
    st, acc = [], 1
    for n in reversed(shape):
        st.append(acc)
        acc *= n
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(st)))


def _replicated(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh``: a plain tensor (made inside the
    step) is replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# =============================================================================
# einsum
# =============================================================================

def _expand_ellipsis(eq: str, ops) -> str:
    """``...`` spelled out with upper-case letters (the port's equations
    use lower case only)."""
    ins, out = eq.replace(" ", "").split("->")
    terms, width = [], 0
    for t, o in zip(ins.split(","), ops):
        if "..." in t:
            n = o.dim() - (len(t) - 3)
            width = max(width, n)
            t = t.replace("...", "ABCDEFGH"[:n])
        terms.append(t)
    return ",".join(terms) + "->" + out.replace("...", "ABCDEFGH"[:width])


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``numerics.einsum``, or, with a DTensor operand, one local einsum
    per rank.  Each mesh dimension shards at most one letter: the letter
    that the largest operand (by global elements) shards there, so the
    smaller operands move (an FSDP all-gather of a weight, or of the keys
    for sharded queries).  Every operand is redistributed to shard that
    letter where it has it and to be replicated where it has not; the
    local einsum's result is then sharded on that letter, a partial sum
    when the letter is contracted, or replicated.  DTensor's own
    decomposition of einsum into folded ``bmm`` products cannot shard two
    folded dimensions at once (the sequence-parallel residual stream
    against tensor-parallel weights)."""
    if not any(is_dtensor(o) for o in ops):
        return numerics.einsum(eq, *ops)
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    eq = _expand_ellipsis(eq, ops)
    ins, out = eq.split("->")
    terms = ins.split(",")
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    size: dict = {}
    for t, o in zip(terms, ops):
        for c, n in zip(t, o.shape):
            size[c] = max(size.get(c, 1), n)
    chosen = []
    for m in range(mesh.ndim):
        votes: dict = {}
        for t, o in zip(terms, ops):
            if isinstance(o, DTensor):
                pl = o.placements[m]
                if isinstance(pl, Shard):
                    c = t[pl.dim]
                    votes[c] = votes.get(c, 0) + o.numel()
        chosen.append(max(votes, key=votes.get) if votes else None)
    local = []
    for t, o in zip(terms, ops):
        want = tuple(Shard(t.index(c)) if c is not None and c in t
                     else Replicate() for c in chosen)
        # an operand replicated where the others are split contributes to
        # every rank's partial result: its gradient is a partial sum there
        grad = tuple(Partial() if c is not None and c not in t else w
                     for c, w in zip(chosen, want))
        o = _replicated(o, mesh)
        if tuple(o.placements) != want:
            o = o.redistribute(mesh, want)
        local.append(o.to_local(grad_placements=grad))
    res = torch.einsum(eq, *local)
    pl = tuple(Shard(out.index(c)) if c is not None and c in out
               else Partial() if c is not None else Replicate()
               for c in chosen)
    return wrap_local(res, mesh, pl, [size[c] for c in out])


# =============================================================================
# the model's embedding and cross-entropy
# =============================================================================

def _embed(model, tokens: torch.Tensor) -> torch.Tensor:
    """``model._embed`` of a DTensor table: each rank looks its own tokens
    up in the whole table (gathered), so the rows come out sharded as the
    tokens are; the table's gradient is a partial sum over the axes that
    split the tokens.  DTensor's own sharded ``index`` / ``index_put``
    (the lookup's backward) is not relied on: it differs across torch
    versions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    table = model.embed
    if not is_dtensor(table):
        return _PLAIN["embed"](model, tokens)
    mesh = table.device_mesh
    tokens = _replicated(tokens, mesh)
    pl = tuple(p if isinstance(p, Shard) else Replicate()
               for p in tokens.placements)
    tokens = tokens.redistribute(mesh, pl)
    split = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    local = table.redistribute(mesh, [Replicate()] * mesh.ndim) \
        .to_local(grad_placements=split)[tokens.to_local().long()]
    return wrap_local(local, mesh, pl, tuple(tokens.shape) + (table.shape[1],))


def _chunked_ce(cfg, x: torch.Tensor, head: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """``model._chunked_ce`` of a DTensor residual stream: each rank
    takes its own rows (x sharded on batch and sequence only, the labels
    alike) against the whole head, chunk by chunk as ``model._ce_sum``;
    the per-rank sums are a partial sum over the mesh axes that split the
    rows.  Slicing row chunks out of a sharded DTensor would gather
    them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..models.model import _ce_sum
    if not is_dtensor(x):
        return _PLAIN["ce"](cfg, x, head, labels)
    mesh = x.device_mesh
    rows_pl = tuple(p if isinstance(p, Shard) and p.dim < 2
                    else Replicate() for p in x.placements)
    x = x.redistribute(mesh, rows_pl)
    labels = _replicated(labels, mesh).redistribute(mesh, rows_pl)
    split = [Partial() if isinstance(p, Shard) else Replicate()
             for p in rows_pl]
    if is_dtensor(head):
        # every rank's rows meet the whole head: its gradient is a
        # partial sum over the axes that split the rows
        head = head.redistribute(mesh, [Replicate()] * mesh.ndim) \
            .to_local(grad_placements=split)
    local = _ce_sum(cfg, x.to_local(), head, labels.to_local())
    total = DTensor.from_local(local, mesh, split, run_check=False)
    return total / (x.shape[0] * x.shape[1])


_PLAIN: dict = {}       # the model's own functions while ``routes`` runs


# =============================================================================
# the tensor ops of ``_Ops``
# =============================================================================

def _reshape(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(*shape)`` of a DTensor.  It keeps a shard of a
    dimension the reshape changes only where DTensor can: a last dimension
    split into parts whose first part divides evenly over the mesh axis,
    or merged dimensions whose first one is the sharded one and divides
    evenly (never a dimension of size 1, which DTensor's view rules drop);
    other shards of the changed dimensions are gathered first (a head
    count such as 40 over a 16-way axis)."""
    from torch.distributed.tensor import Replicate, Shard
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    k = 0                       # unchanged leading dims
    while k < min(t.dim(), len(shape)) and t.shape[k] == shape[k]:
        k += 1
    j = 0                       # unchanged trailing dims
    while j < min(t.dim(), len(shape)) - k \
            and t.shape[t.dim() - 1 - j] == shape[len(shape) - 1 - j]:
        j += 1
    mesh = t.device_mesh
    split = t.dim() - k - j == 1
    merge = len(shape) - k - j == 1
    want = []
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard) and k <= p.dim < t.dim() - j:
            n = mesh.size(m)
            ok = p.dim == k and t.shape[k] > 1 and t.shape[k] % n == 0 \
                and ((split and shape[k] % n == 0) or merge)
            want.append(p if ok else Replicate())
        else:
            want.append(p)
    if tuple(want) != tuple(t.placements):
        t = t.redistribute(mesh, want)
    return t.reshape(*shape)


def _cumsum(t: torch.Tensor, dim: int, **kwargs) -> torch.Tensor:
    """``torch.cumsum`` of a DTensor, rank by rank, its ``dim`` gathered
    first if sharded: the backward then runs on the local tensors."""
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in t.placements]
    t = t.redistribute(t.device_mesh, pl)
    return wrap_local(torch.cumsum(t.to_local(), dim, **kwargs),
                      t.device_mesh, pl, t.shape)


def _pad(x: torch.Tensor, pad, mode="constant", value=None
         ) -> torch.Tensor:
    """``F.pad(x, (0, 0, n, 0))`` of a DTensor, Mamba's causal conv: n
    zero rows before the sequence (dim 1 of a 3-D tensor) as a
    concatenation with zeros, the same values."""
    zeros = torch.zeros((x.shape[0], pad[2]) + tuple(x.shape[2:]),
                        dtype=x.dtype, device=x.device)
    return torch.cat([zeros, x], dim=1)


def _assert_async(t: torch.Tensor, *args) -> None:
    """``torch._assert_async`` of a DTensor condition: each rank asserts
    its own part (DTensor has no rule for the op)."""
    torch._assert_async(t.to_local(), *args)


def _index_copy_(buf: torch.Tensor, dim: int, rows: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``buf.index_copy_(1, rows, vals)`` of a DTensor cache (``dim`` 1),
    ``rows`` consecutive (``start + arange(S)``, the reference's
    ``dynamic_update_slice``).  A cache whose rows are sharded (the
    sequence-sharded KV caches) is written rank by rank, each rank the new
    rows that fall inside its block, one row at a time."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    S = vals.shape[1]
    mesh, pl = buf.device_mesh, buf.placements
    whole_rows = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                  for p in pl]
    v = _replicated(vals, mesh).to(buf.dtype).redistribute(mesh, whole_rows).to_local()
    if isinstance(rows, DTensor):
        rows = rows.full_tensor()
    loc = buf.to_local()
    # this rank's first row: DTensor splits a sharded dim in ceil-size
    # chunks, mesh dimension by mesh dimension
    off, n = 0, buf.shape[1]
    for m, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            cs = -(-n // mesh.size(m))
            first = min(mesh.get_local_rank(m) * cs, n)
            off, n = off + first, min(cs, n - first)
    for i in range(S):
        r = rows[i] - off
        keep = ((r >= 0) & (r < n)).reshape((1, 1) + (1,) * (v.dim() - 2))
        r = r.clamp(0, max(n - 1, 0)).reshape(1)
        cur = loc.index_select(1, r)
        loc.index_copy_(1, r, torch.where(keep, v[:, i:i + 1], cur))
    return buf


class _Ops(TorchFunctionMode):
    """Sends ``_ROUTES``' ops to their DTensor forms when their first
    argument is a DTensor; everything else passes through."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        route = _ROUTES.get(func)
        if route is not None and args and is_dtensor(args[0]):
            return route(*args, **kwargs)
        return func(*args, **kwargs)


_ROUTES = {torch.Tensor.reshape: _reshape, torch.cumsum: _cumsum,
           F.pad: _pad, torch.Tensor.index_copy_: _index_copy_,
           torch._assert_async: _assert_async}


def _checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint.checkpoint`` with ``_Ops`` around the
    recomputation too: the backward does not run under the mode that
    was current when the forward ran."""
    return _PLAIN["checkpoint"](
        fn, *args, context_fn=lambda: (contextlib.nullcontext(), _Ops()),
        **kwargs)


@contextlib.contextmanager
def routes():
    """The DTensor route, for the duration of the ``with`` block."""
    from ..models import layers, model
    from ..serve import step
    _PLAIN.update(embed=model._embed, ce=model._chunked_ce,
                  checkpoint=model.checkpoint)
    saved = (layers.einsum, model._embed, step._embed, model._chunked_ce,
             model.checkpoint)
    layers.einsum = einsum
    model._embed = step._embed = _embed
    model._chunked_ce = _chunked_ce
    model.checkpoint = _checkpoint
    try:
        with _Ops():
            yield
    finally:
        (layers.einsum, model._embed, step._embed, model._chunked_ce,
         model.checkpoint) = saved
        _PLAIN.clear()
