"""The heterogeneous population model, a copy of
``fedml_tpu/population/model.py`` (pure numpy, bitwise the reference's
draws): a seeded model of

- a **per-client speed multiplier** (static, drawn once from a configurable
  distribution), which sets per-client step budgets in place of the
  uniform ``straggler_frac`` draw;
- an **availability on/off process** (per-(client, block) draws with a
  configurable block length, so clients go dark for whole stretches of
  rounds), which sets cohort eligibility;
- a **mid-round dropout** probability and executed-fraction draw: a dropped
  client trains part of its budget and its update never aggregates;
- an **upload-arrival jitter** distribution (seconds), a wire-only knob
  that the sim engine refuses (the wire path is ROADMAP §A11).

Everything is a pure function of ``(spec, num_clients, seed, round)``
through :mod:`fedml_tpu_torch.population.prng`, so any round is
random-access (the pipelined driver stages rounds ahead) and a saved trace
(:mod:`fedml_tpu_torch.population.trace`) replays bit-exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.population import prng

# distribution grammar: name:param[,param] — the three families the
# population knobs accept (plus const for degenerate/identity arms)
DIST_ARITY = {"const": 1, "uniform": 2, "lognormal": 2, "zipf": 1}


@dataclasses.dataclass(frozen=True)
class Dist:
    """One parsed distribution. ``draw`` consumes a generator from
    :func:`fedml_tpu_torch.population.prng.spawn` — never global rng state.

    - ``const:v`` — every draw is v
    - ``uniform:lo,hi`` — uniform on [lo, hi)
    - ``lognormal:mu,sigma`` — exp(N(mu, sigma)); median e^mu
    - ``zipf:a`` — **inverse** Zipf: 1/Z with Z ~ zipf(a), a > 1. As a speed
      multiplier this puts the heavy tail on SLOW clients (a 1/k-speed
      straggler at Zipf rank k), the power-law device skew the mobile
      paradigm is about — a raw Zipf draw would make the tail *fast*, which
      no budget model can use (budgets cap at the nominal step count).
    """

    name: str
    params: tuple[float, ...]

    def draw(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        p = self.params
        if self.name == "const":
            return np.full(n, p[0], np.float64)
        if self.name == "uniform":
            return p[0] + (p[1] - p[0]) * rng.random_sample(n)
        if self.name == "lognormal":
            return np.exp(p[0] + p[1] * rng.standard_normal(n))
        # zipf (validated in parse_dist): inverse draw, see class docstring
        return 1.0 / rng.zipf(p[0], n).astype(np.float64)

    @property
    def is_const(self) -> bool:
        return self.name == "const"

    def to_string(self) -> str:
        return f"{self.name}:{','.join(repr(float(v)) for v in self.params)}"


def parse_dist(spec: str) -> Dist:
    """``name:p1[,p2]`` -> :class:`Dist`. Unknown names and wrong arities
    fail loudly — a typo'd distribution silently running a different
    experiment would be worse than a crash (the fault-spec convention)."""
    name, sep, raw = spec.strip().partition(":")
    name = name.strip()
    if name not in DIST_ARITY:
        raise ValueError(
            f"unknown distribution {name!r} in {spec!r} (expected "
            f"{' | '.join(sorted(DIST_ARITY))})"
        )
    if not sep:
        raise ValueError(
            f"distribution {spec!r}: expected '{name}:<param>"
            f"{',<param>' * (DIST_ARITY[name] - 1)}'"
        )
    try:
        params = tuple(float(v) for v in raw.split(","))
    except ValueError:
        raise ValueError(
            f"distribution {spec!r}: non-numeric parameter"
        ) from None
    if len(params) != DIST_ARITY[name]:
        raise ValueError(
            f"distribution {spec!r}: {name} takes {DIST_ARITY[name]} "
            f"parameter(s), got {len(params)}"
        )
    if name == "zipf" and params[0] <= 1.0:
        raise ValueError(f"distribution {spec!r}: zipf needs a > 1")
    if name == "uniform" and params[1] < params[0]:
        raise ValueError(f"distribution {spec!r}: uniform needs hi >= lo")
    if name == "lognormal" and params[1] < 0:
        raise ValueError(f"distribution {spec!r}: lognormal needs sigma >= 0")
    return Dist(name, params)


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """The population's knobs. CLI/`SimConfig` carry the string form
    (:func:`parse_population_spec`); defaults are the identity population
    (every client full speed, always available, never dropping)."""

    speed: Dist = Dist("const", (1.0,))
    avail: float = 1.0        # stationary availability probability
    avail_block: int = 1      # rounds per on/off availability block
    dropout: float = 0.0      # per-(round, cohort member) mid-round dropout
    drop_frac: Dist = Dist("uniform", (0.0, 1.0))  # budget fraction executed
    jitter: Dist = Dist("const", (0.0,))           # upload delay seconds

    def __post_init__(self):
        for name in ("avail", "dropout"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"population {name}={v} must be in [0, 1]"
                )
        if self.avail_block < 1:
            raise ValueError(
                f"population avail_block={self.avail_block} must be >= 1"
            )

    @property
    def jitter_active(self) -> bool:
        """True when the spec schedules upload delays — a wire-only knob
        the sim engine rejects (there is no wire on the sim backend)."""
        return not (self.jitter.is_const and self.jitter.params[0] == 0.0)

    def to_string(self) -> str:
        return ";".join([
            f"speed={self.speed.to_string()}",
            f"avail={self.avail!r}",
            f"avail_block={self.avail_block}",
            f"dropout={self.dropout!r}",
            f"drop_frac={self.drop_frac.to_string()}",
            f"jitter={self.jitter.to_string()}",
        ])


_SCALAR_KEYS = {"avail": float, "avail_block": int, "dropout": float}
_DIST_KEYS = ("speed", "drop_frac", "jitter")


def parse_population_spec(spec: str | PopulationSpec) -> PopulationSpec:
    """The ``--population`` syntax: ``;``-separated ``key=value`` entries,
    e.g. ``"speed=lognormal:0,0.5;avail=0.8;avail_block=4;dropout=0.05"``.
    Unknown keys, duplicate keys, and malformed values fail loudly."""
    if isinstance(spec, PopulationSpec):
        return spec
    kw: dict = {}
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        key, sep, val = entry.partition("=")
        key = key.strip()
        if not sep or not val.strip():
            raise ValueError(
                f"population spec entry {entry!r}: expected 'key=value'"
            )
        if key in kw:
            raise ValueError(f"population spec: duplicate key {key!r}")
        if key in _SCALAR_KEYS:
            kw[key] = _SCALAR_KEYS[key](val)
        elif key in _DIST_KEYS:
            kw[key] = parse_dist(val)
        else:
            raise ValueError(
                f"unknown population key {key!r} (expected "
                f"{' | '.join([*_SCALAR_KEYS, *_DIST_KEYS])})"
            )
    if not kw:
        raise ValueError(f"empty population spec {spec!r}")
    return PopulationSpec(**kw)


@dataclasses.dataclass(frozen=True)
class RoundView:
    """One round's realized population state over a fixed-size cohort.

    ``cohort`` always has exactly ``cohort_size`` slots; when availability
    churn leaves fewer eligible clients than the cohort wants, the tail
    slots hold ``-1`` (an empty slot: zero weight, zero steps — the staging
    machinery's existing padding convention, so compiled shapes never
    change). Per-slot arrays are aligned with ``cohort``; empty slots carry
    neutral values (speed 1, not dropped, jitter 0)."""

    round_idx: int
    cohort: np.ndarray        # [K] int32 client ids, -1 = empty slot
    speed: np.ndarray         # [K] float64 speed multipliers
    dropped: np.ndarray       # [K] bool — drops mid-round
    drop_frac: np.ndarray     # [K] float64 — budget fraction executed
    jitter_s: np.ndarray      # [K] float64 — upload-arrival delay (wire)
    eligible_count: int       # how many clients were available this round

    @property
    def cohort_size(self) -> int:
        return len(self.cohort)

    def real(self) -> np.ndarray:
        """[K] bool — slots holding an actual sampled client."""
        return self.cohort >= 0


class Population:
    """The generative population: static per-client attributes drawn at
    construction, per-round dynamics drawn on demand — every draw seeded
    through :mod:`fedml_tpu_torch.population.prng`, so ``round_view`` is a pure
    function of ``(spec, num_clients, seed, round_idx, cohort_size)``."""

    def __init__(self, spec: PopulationSpec | str, num_clients: int,
                 seed: int = 0):
        self.spec = parse_population_spec(spec)
        if num_clients < 1:
            raise ValueError(f"population needs num_clients >= 1, got "
                             f"{num_clients}")
        self.num_clients = int(num_clients)
        self.seed = int(seed)
        # static per-client speed multipliers; floored away from zero so a
        # pathological draw can never produce a zero-step budget for a
        # non-dropped client
        self.speed = np.maximum(
            self.spec.speed.draw(
                prng.spawn(self.seed, prng.STREAM_SPEED), self.num_clients
            ),
            1e-6,
        )

    def availability_mask(self, round_idx: int) -> np.ndarray:
        """[num_clients] bool — who is reachable this round. Drawn per
        (client, block) with block = round // avail_block, so a client that
        goes dark stays dark for the whole block (temporal correlation, the
        'on/off process'), and any round remains random-access."""
        if self.spec.avail >= 1.0:
            return np.ones(self.num_clients, bool)
        block = int(round_idx) // self.spec.avail_block
        rng = prng.spawn(self.seed, prng.STREAM_AVAIL, block)
        return rng.random_sample(self.num_clients) < self.spec.avail

    def round_view(self, round_idx: int, cohort_size: int) -> RoundView:
        mask = self.availability_mask(round_idx)
        eligible = np.nonzero(mask)[0]
        k = min(int(cohort_size), len(eligible))
        cohort = np.full(cohort_size, -1, np.int32)
        if k:
            cohort[:k] = rnglib.sample_clients(
                round_idx, self.num_clients, k, eligible=eligible
            )
        real = cohort >= 0
        speed = np.where(real, self.speed[np.maximum(cohort, 0)], 1.0)
        # dropout: one uniform + one fraction draw PER SLOT in a fixed
        # order, so the schedule never shifts with eligibility
        rng_d = prng.spawn(self.seed, prng.STREAM_DROP, round_idx)
        u = rng_d.random_sample(cohort_size)
        frac = np.clip(
            self.spec.drop_frac.draw(rng_d, cohort_size), 0.0, 1.0
        )
        dropped = real & (self.spec.dropout > 0) & (u < self.spec.dropout)
        jitter = np.maximum(
            self.spec.jitter.draw(
                prng.spawn(self.seed, prng.STREAM_JITTER, round_idx),
                cohort_size,
            ),
            0.0,
        )
        return RoundView(
            round_idx=int(round_idx),
            cohort=cohort,
            speed=speed,  # empty slots already neutralized to 1.0 above
            dropped=dropped,
            drop_frac=np.where(dropped, frac, 1.0),
            jitter_s=np.where(real, jitter, 0.0),
            eligible_count=int(len(eligible)),
        )

    def describe(self) -> dict:
        """Static accounting for run-start logs (the pack_summary shape)."""
        return {
            "kind": "generative",
            "spec": self.spec.to_string(),
            "num_clients": self.num_clients,
            "seed": self.seed,
            "speed_minmax": [float(self.speed.min()),
                             float(self.speed.max())],
        }


def step_budgets(view: RoundView, nominal_steps: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Map a round view onto per-slot step budgets: ``(actual, predicted)``
    int32 arrays aligned with ``view.cohort``.

    ``predicted`` is the scheduler's view — what the speed model says the
    client completes within the round deadline: ``ceil(min(1, speed) *
    nominal)`` clipped to [1, nominal] for real slots, 0 for empty slots.
    ``actual`` truncates predicted by the mid-round dropout draw
    (``floor(drop_frac * predicted)``, possibly 0 — dropped before the
    first step lands). ``actual <= predicted`` always — the invariant the
    predicted-binning packer (sim/cohort.pack_cohort) relies on."""
    real = view.real()
    nominal = int(nominal_steps)
    frac = np.minimum(view.speed, 1.0)
    predicted = np.where(
        real, np.clip(np.ceil(frac * nominal), 1, nominal), 0
    ).astype(np.int32)
    actual = np.where(
        view.dropped,
        np.floor(view.drop_frac * predicted),
        predicted,
    ).astype(np.int32)
    return actual, predicted
