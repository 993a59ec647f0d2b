"""A copy of ``fedml_tpu/async_agg/staleness.py``.

Staleness-weight decay families for the buffered-async server.

An upload that trained global-model version ``u`` and arrives when the
server is at version ``v`` has staleness ``d = v - u >= 0``. Its fold
weight is ``s(d) * n`` (``n`` the client's sample count): fresh uploads
(``d == 0``) always fold at full weight (``s(0) == 1`` for every family),
stale ones are down-weighted — never dropped, unlike the sync protocol's
stale-round discard (``Comm/StaleUploads``).

The families are FedAsync's (Xie et al., 2019, "Asynchronous Federated
Optimization" §3):

- ``const``           s(d) = 1                         (FedBuff's choice)
- ``poly:a``          s(d) = (1 + d) ** -a             (polynomial decay)
- ``hinge:a,b``       s(d) = 1 if d <= b else 1 / (a * (d - b) + 1)

Weights are computed in python floats so the ``const`` family's fold is
arithmetically IDENTICAL to the sync path's (``1.0 * n == n`` exactly) —
the async-equals-sync bit-identity arm depends on it.
"""

from __future__ import annotations

from typing import Callable

StalenessFn = Callable[[int], float]


def constant() -> StalenessFn:
    return lambda d: 1.0


def polynomial(a: float) -> StalenessFn:
    if a < 0:
        raise ValueError(f"poly staleness exponent must be >= 0, got {a}")
    return lambda d: float((1.0 + d) ** -a)


def hinge(a: float, b: float) -> StalenessFn:
    if a < 0 or b < 0:
        raise ValueError(f"hinge staleness needs a >= 0 and b >= 0, got "
                         f"a={a}, b={b}")
    return lambda d: 1.0 if d <= b else float(1.0 / (a * (d - b) + 1.0))


STALENESS_FAMILIES = {
    "const": constant,
    "poly": polynomial,
    "hinge": hinge,
}


def memoize_staleness(fn: StalenessFn) -> StalenessFn:
    """Cache weights by integer staleness distance. The domain is tiny (a
    handful of distinct lags per run) but the fold path is hot — an async
    edge tier at 10^6 uploads evaluates the family once per fold, and
    ``poly``'s ``**`` is measurably slower than a dict hit. Exact: the
    family functions are pure maps from ``d``, so caching cannot change a
    single fold weight (``const`` stays bit-identical to sync)."""
    cache: dict[int, float] = {}

    def cached(d: int) -> float:
        w = cache.get(d)
        if w is None:
            w = cache[d] = float(fn(d))
        return w

    return cached


def make_staleness_fn(spec: str) -> StalenessFn:
    """Parse a staleness-weight spec: ``const`` | ``poly:a`` |
    ``hinge:a,b`` (e.g. ``poly:0.5``, ``hinge:0.25,4``). Raises on unknown
    family names or malformed arguments, naming the valid set."""
    name, _, argstr = str(spec).partition(":")
    family = STALENESS_FAMILIES.get(name)
    if family is None:
        raise ValueError(
            f"unknown staleness family {name!r} (from spec {spec!r}); "
            f"expected one of {sorted(STALENESS_FAMILIES)} as "
            "'const' | 'poly:a' | 'hinge:a,b'"
        )
    args = []
    if argstr:
        try:
            args = [float(x) for x in argstr.split(",")]
        except ValueError:
            raise ValueError(
                f"malformed staleness args {argstr!r} in spec {spec!r}: "
                "expected comma-separated floats"
            ) from None
    try:
        fn = family(*args)
    except TypeError:
        raise ValueError(
            f"staleness family {name!r} got {len(args)} arg(s) in spec "
            f"{spec!r}: expected 'const' (0), 'poly:a' (1), 'hinge:a,b' (2)"
        ) from None
    if fn(0) != 1.0:
        raise AssertionError(f"staleness family {spec!r} broke s(0) == 1")
    return fn
