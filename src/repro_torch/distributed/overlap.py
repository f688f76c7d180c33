"""Compute/communication overlap: the ring collective matmul (a port of
``repro/distributed/overlap.py``).

``ring_allgather_matmul`` decomposes x @ W (W column-sharded over the
ranks of a process group, x row-sharded) into P steps: at step i each
rank multiplies the row block it holds while ``batch_isend_irecv`` passes
that block on to the next rank of the ring, so the all-gather of x hides
behind P partial matmuls (the classic collective matmul).  It is the
reference's ``shard_map`` schedule with torch's point-to-point ops in
place of ``ppermute``.

Equivalent semantics: all_gather(x) @ W_local.
"""
from __future__ import annotations

import torch

__all__ = ["ring_allgather_matmul"]


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, group=None
                          ) -> torch.Tensor:
    """x: (S/p, D), this rank's block of rows; w: (D, F/p), this rank's
    block of columns; ``group``: the ring's process group (``None``: the
    default group).  Returns (S, F/p): every row of x times this rank's
    columns.  The rows held at step i came from rank (rank - i) mod p;
    each step's send to rank + 1 and receive from rank - 1 are in flight
    while that block's product runs.  At one rank there is no send."""
    import torch.distributed as dist
    group = group if group is not None else dist.group.WORLD
    p = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % p)
    prv = dist.get_global_rank(group, (me - 1) % p)
    s_blk = x.shape[0]
    out = torch.empty((s_blk * p, w.shape[1]), dtype=x.dtype,
                      device=x.device)
    cur = x.contiguous()
    for i in range(p):
        reqs, buf = [], None
        if i < p - 1:
            buf = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)])
        src = (me - i) % p
        out[src * s_blk:(src + 1) * s_blk] = cur @ w
        for r in reqs:
            r.wait()
        if buf is not None:
            cur = buf
    return out
