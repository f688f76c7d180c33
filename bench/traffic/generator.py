"""The one traffic generator: a stream of genome batches for a closed loop
of one client, read from a mix's parameter file (``<mix>.json`` beside
this file).

Parameters of a mix:

* ``genomes_per_call``: genomes in each ``EvalEngine.evaluate`` call (G);
* ``families``: the architecture families (``homo``, ``hetero_bl``,
  ``hetero_bls``); each call holds them in equal shares (the first ones
  take the remainder), in an order shuffled from the seed;
* ``pool_calls``: calls drawn during set-up.  A window that needs more
  draws the next call's genomes between two calls, outside both.

Genomes come from the paper's uniform draw (``random_genomes``,
the frozen copy in ``bench/reference``) and never repeat within a run:
a draw whose canonical form (the engine's memo key, frozen below) was
seen before is dropped, so every genome misses the memo.  The
paper's per-genome area repair (``sample_in_bracket``) is left out: it
is a host loop of minutes at these sizes.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..reference.core.arch import KNOB_GRID, MAX_TILE_TYPES
from ..reference.core.dse.encoding import (FIELDS_PER_TILE, GENOME_LEN,
                                           _TILE_FIELDS, random_genomes)

HERE = os.path.dirname(os.path.abspath(__file__))

# -- frozen copy of repro_torch.core.dse.engine.canonical_genomes ----------
_FIELD_COL = {f: i for i, f in enumerate(_TILE_FIELDS)}
_SFU = np.asarray(KNOB_GRID["sfu_mask"], np.float64)
_SFU_COL = _FIELD_COL["sfu"]
_SPECIAL_INERT_COLS = tuple(
    _FIELD_COL[f] for f in ("rows", "cols", "engine", "prec", "sparsity",
                            "dataflow", "asym", "pipe"))
_PREC_COL = _FIELD_COL["prec"]
_ASYM_COL = _FIELD_COL["asym"]
_ASYM_CANON = np.asarray([[0, 1, 1, 0],
                          [0, 0, 0, 0],
                          [0, 1, 1, 1],
                          [0, 0, 0, 0]], np.int64)


def canonical_genomes(genomes: np.ndarray) -> np.ndarray:
    """Zero the genes that ``decode`` ignores (tile types beyond
    ``n_tile_types``, the inert genes of Special-Function tiles) and fold
    the equivalent ``asym`` genes, as the engine's memo keys do."""
    g = np.asarray(genomes, dtype=np.int64).reshape(-1, GENOME_LEN).copy()
    n_types = g[:, 0] + 1
    for t in range(MAX_TILE_TYPES):
        base = 1 + t * FIELDS_PER_TILE
        inactive = t >= n_types
        block = g[:, base:base + FIELDS_PER_TILE]
        g[:, base:base + FIELDS_PER_TILE] = \
            np.where(inactive[:, None], 0, block)
        special = (_SFU[g[:, base + _SFU_COL] % len(_SFU)] > 0) & ~inactive
        for col in _SPECIAL_INERT_COLS:
            g[:, base + col] = np.where(special, 0, g[:, base + col])
        g[:, base + _ASYM_COL] = _ASYM_CANON[g[:, base + _PREC_COL] % 4,
                                             g[:, base + _ASYM_COL] % 4]
    return g


# fixed odd multipliers: a canonical genome's 64-bit key is their dot
# product with its genes, wrapping.  Two genomes that collide would only
# drop a fresh draw, never let one repeat.
_KEY_MULT = np.random.default_rng(0x5eed).integers(
    1, 2 ** 63, GENOME_LEN, dtype=np.uint64) * np.uint64(2) + np.uint64(1)


def _hash(canon: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return (canon.astype(np.uint64) * _KEY_MULT).sum(
            axis=1, dtype=np.uint64)


def load_mix(name: str) -> Dict:
    with open(os.path.join(HERE, f"{name}.json")) as fh:
        mix = json.load(fh)
    if mix.get("generator") != "sweep":
        raise ValueError(f"traffic {name!r}: unknown generator "
                         f"{mix.get('generator')!r}")
    return mix


class GenomeStream:
    """Genome batches for one run, all drawn from ``seed``: ``next_call()``
    returns the next (G, GENOME_LEN) int64 batch."""

    def __init__(self, mix: Dict, seed: int):
        self.G = int(mix["genomes_per_call"])
        self.families = list(mix["families"])
        if self.G < 1 or not self.families:
            raise ValueError(f"bad mix parameters {mix}")
        self.rng = np.random.default_rng(int(seed))
        self.seen: List[np.ndarray] = [np.zeros(0, np.uint64)
                                       for _ in self.families]
        self.calls: List[np.ndarray] = []
        self.served = 0
        for _ in range(int(mix["pool_calls"])):
            self._draw_call()

    def _fresh(self, family_idx: int, n: int) -> np.ndarray:
        """``n`` genomes of one family whose canonical forms this run has
        not drawn before, in draw order."""
        out, got = [], 0
        while got < n:
            cand = random_genomes(self.rng, n - got + n // 4 + 64,
                                  family=self.families[family_idx])
            keys = _hash(canonical_genomes(cand))
            _, first = np.unique(keys, return_index=True)
            first = np.sort(first)
            first = first[~np.isin(keys[first], self.seen[family_idx])]
            take = first[:n - got]
            self.seen[family_idx] = np.concatenate(
                [self.seen[family_idx], keys[take]])
            out.append(cand[take].astype(np.int8))
            got += len(take)
        return np.concatenate(out)

    def _draw_call(self) -> None:
        share, extra = divmod(self.G, len(self.families))
        batch = np.concatenate([
            self._fresh(f, share + (1 if f < extra else 0))
            for f in range(len(self.families))])
        # genes are below 8: int8 keeps a pool of many calls small
        self.calls.append(batch[self.rng.permutation(self.G)])

    def next_call(self) -> np.ndarray:
        """The next call's genomes (int64), drawing them now if set-up's pool is
        used up."""
        if self.served == len(self.calls):
            self._draw_call()
        self.served += 1
        return self.calls[self.served - 1].astype(np.int64)
