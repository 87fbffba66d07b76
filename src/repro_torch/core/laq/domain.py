"""Common key-domain construction (paper Alg. 1 lines 1–3) and the domain
cache (port of ``repro.core.laq.domain``).

The paper names domain generation (set union + binary search) a major cost
(§4.2 Q3, Fig. 11) and suggests caching it: ``DomainCache`` keeps domains
by the participating (relation, column) set and merges appended keys into
a cached domain instead of rebuilding it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch

from .table import PAD_KEY


def key_domain(keys: Sequence[torch.Tensor], size: int) -> torch.Tensor:
    """Sorted union of key arrays, padded (or cut) to ``size`` with PAD_KEY.

    ``jnp.unique(size=, fill_value=)`` has no torch counterpart: unique,
    then pad.
    """
    allk = torch.cat([k.reshape(-1) for k in keys])
    u = torch.unique(allk, sorted=True)[:size]
    dom = torch.full((size,), PAD_KEY, dtype=allk.dtype, device=allk.device)
    dom[:u.shape[0]] = u
    return dom


def positions(domain: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Map keys to their slots in the sorted domain (vectorized binary search).

    Returns int32 positions; keys absent from the domain and PAD_KEY map to
    ``len(domain)`` (an out-of-range slot).
    """
    n = domain.shape[0]
    pos = torch.searchsorted(domain, keys, out_int32=True)
    hit = domain[pos.clamp(0, n - 1)] == keys
    pad = keys == PAD_KEY
    return torch.where(hit & ~pad, pos, torch.full_like(pos, n))


class DomainCache:
    """Cache of key domains keyed by (relation, column) identity sets.

    ``get_or_build`` returns a cached domain when the same relation/column
    set was seen with at least the requested size; ``refresh`` merges
    appended keys into a cached domain without a full rebuild.  Domains
    stay on the device they were built on.
    """

    def __init__(self):
        self._store: Dict[Tuple, torch.Tensor] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(names: Sequence[Tuple[str, str]]) -> Tuple:
        return tuple(sorted(names))

    def get_or_build(self, names, keys: Sequence[torch.Tensor], size: int):
        k = self._key(names)
        if k in self._store and self._store[k].shape[0] >= size:
            self.hits += 1
            return self._store[k]
        self.misses += 1
        dom = key_domain(keys, size)
        self._store[k] = dom
        return dom

    def refresh(self, names, new_keys: torch.Tensor, *,
                grow: bool = True) -> torch.Tensor:
        """Merge appended keys into the cached domain.

        The merged unique count is measured exactly: when it exceeds the
        cached domain's capacity the domain grows geometrically (powers of
        two of the old capacity) instead of truncating the largest keys.
        ``grow=False`` raises a capacity error instead, for callers that
        bake the domain's shape in.
        """
        k = self._key(names)
        if k not in self._store:
            raise KeyError(f"no cached domain for {k}")
        dom = self._store[k]
        cap = int(dom.shape[0])
        new = torch.as_tensor(new_keys).to(device=dom.device,
                                           dtype=dom.dtype)
        merged = torch.unique(torch.cat([dom.reshape(-1), new.reshape(-1)]),
                              sorted=True)
        live = merged[merged != PAD_KEY]   # pads sort last; drop, re-pad
        n_live = int(live.shape[0])
        if n_live > cap:
            if not grow:
                raise ValueError(
                    f"domain {k} capacity {cap} exceeded: merged unique key "
                    f"count is {n_live} — rebuild with a larger size, or "
                    "allow grow=True")
            while cap < n_live:
                cap *= 2
        out = torch.full((cap,), PAD_KEY, dtype=dom.dtype, device=dom.device)
        out[:n_live] = live
        self._store[k] = out
        return out

    def refresh_table(self, relation: str,
                      new_keys: Mapping[str, torch.Tensor], *,
                      grow: bool = True) -> int:
        """Refresh every cached domain that references ``relation``.

        ``new_keys`` maps the relation's key columns to their appended
        values; each cached domain whose identity set holds one of those
        ``(relation, column)`` pairs is merged.  Returns the number of
        domains refreshed — the Catalog's append hook.
        """
        n = 0
        for key in list(self._store):
            cols = [c for (rel, c) in key if rel == relation and c in new_keys]
            if cols:
                self.refresh(key, torch.cat(
                    [torch.as_tensor(new_keys[c]).reshape(-1)
                     for c in cols]), grow=grow)
                n += 1
        return n


# Process-wide default cache (the paper's "domain caching strategies").
default_domain_cache = DomainCache()
