"""Collective census: the per-card wire bytes of a step's collectives, by
kind and by level.

Counterpart of ``repro/launch/hlo_census.py``, with its ring model
(:func:`census`) and its split of levels at the pod: a collective whose
group holds ranks of two pods crosses the slow level, one inside a pod
the fast level, under the row-major (pod, data, model) rank order.

What is not ported, and why: the reference parses the compiled HLO text
(its shapes, ``replica_groups`` in both formats, async ``-start``/``-done``
pairs) and multiplies a collective inside a while loop by the loop's
known trip count (``_loop_multipliers``: a scan over layers prints its
body once).  The port runs eagerly, and each call is recorded where it
happens (``launch.mesh.DryAxis``): there is no HLO to parse and no trip
count to multiply.  Its collectives have no ``collective-permute``.
"""
from __future__ import annotations

from collections import defaultdict

__all__ = ["census", "wire_bytes"]


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-card wire bytes of one collective over ``n`` ranks whose
    result has ``nbytes`` (ring algorithms):

      all-reduce:      2 * bytes * (n-1)/n
      all-gather:      out_bytes * (n-1)/n
      reduce-scatter:  shard_bytes * (n-1)
      all-to-all:      bytes * (n-1)/n
    """
    frac = (n - 1) / n if n > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind == "reduce-scatter":
        return float(nbytes * (n - 1))
    if kind in ("all-gather", "all-to-all"):
        return nbytes * frac
    raise ValueError(f"unknown collective kind {kind!r}")


def census(records, chips_per_pod: int) -> dict:
    """PER-CARD wire bytes by level, and the counts by kind and level, of
    ``records`` (``DryAxis.records``: ``kind``, ``bytes``, ``ranks``).

    Returns ``fast_bytes`` (inside a pod), ``slow_bytes`` (across pods),
    ``counts`` (``"all-reduce/fast"``, ...) and ``ops`` (kind, bytes,
    group size, whether it crosses a pod, for each record)."""
    out = {"fast_bytes": 0.0, "slow_bytes": 0.0,
           "counts": defaultdict(int), "ops": []}
    for r in records:
        n = len(r["ranks"])
        slow = len({i // chips_per_pod for i in r["ranks"]}) > 1
        out["slow_bytes" if slow else "fast_bytes"] += \
            wire_bytes(r["kind"], r["bytes"], n)
        out["counts"][f"{r['kind']}/{'slow' if slow else 'fast'}"] += 1
        out["ops"].append({"kind": r["kind"], "bytes": r["bytes"],
                           "group": n, "slow": slow})
    out["counts"] = dict(out["counts"])
    return out
