"""The byte-budgeted cache of the transforms' plans.

A plan is what a transform builds once per shape, filters and device: a
nested structure of dicts, lists and tuples whose leaves hold the bytes.
A leaf counts through its ``nbytes``: numpy arrays, ``banded.Operator``,
and the inverse SWT's merges (``transforms/dwt.py``) define it; any other
leaf (a number, a name, None) counts nothing.  The cached plans are
counted again whenever a plan is added, so an operator's copy in another
dtype made after its plan was cached (the bf16 values K17 reads) counts.
"""
from __future__ import annotations

from collections import OrderedDict

__all__ = ["PLAN_CACHE_BUDGET", "budgeted_plan_cache", "plan_bytes"]

PLAN_CACHE_BUDGET = 4 << 30   # bytes of plans kept, over every cache


def plan_bytes(plan):
    """Total bytes held by a (nested) plan structure."""
    total = 0
    stack = [plan]
    while stack:
        p = stack.pop()
        if hasattr(p, "nbytes"):
            total += p.nbytes
        elif isinstance(p, dict):
            stack.extend(p.values())
        elif isinstance(p, (list, tuple)):
            stack.extend(p)
    return total


def budgeted_plan_cache(fn):
    """LRU cache bounded by total held bytes, not entry count: composed
    plans near MAX_MATMUL_N hold hundreds of MB of operator matrices each,
    so a count-bounded cache could pin tens of GB of host RAM."""
    cache: "OrderedDict" = OrderedDict()

    def wrapper(*args):
        if args in cache:
            cache.move_to_end(args)
            return cache[args]
        out = fn(*args)
        cache[args] = out
        sizes = {k: plan_bytes(v) + 1 for k, v in cache.items()}
        while sum(sizes.values()) > PLAN_CACHE_BUDGET and len(cache) > 1:
            old, _ = cache.popitem(last=False)
            del sizes[old]
        return out

    wrapper.cache_clear = cache.clear
    wrapper.__wrapped__ = fn
    return wrapper
