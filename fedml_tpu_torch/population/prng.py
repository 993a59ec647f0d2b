"""The population subsystem's one seeded-generator constructor, a copy of
``fedml_tpu/population/prng.py``.

Every draw the population model makes (static per-client attributes,
per-round availability, dropout, jitter) flows through :func:`spawn`, keyed
by ``(seed, stream, index)``. That single funnel is what makes a saved trace
replay bit-exactly: there is no global rng state anywhere in
``fedml_tpu_torch/population/``.

Streams are small integer ids (module constants below), never strings:
Python's ``hash(str)`` is randomized per process and would break
determinism across runs.
"""

from __future__ import annotations

import numpy as np

# draw-stream ids: each independent draw family gets its own stream, so
# adding one can never shift another's seeded schedule
STREAM_SPEED = 1      # static per-client speed multipliers
STREAM_AVAIL = 2      # per-(client, block) availability
STREAM_DROP = 3       # per-(round, cohort slot) mid-round dropout
STREAM_JITTER = 4     # per-(round, cohort slot) upload-arrival jitter
STREAM_WIRE = 5       # the wire adapter's static per-rank profiles (ROADMAP §A11)

_MOD = 2**31 - 1  # RandomState seeds must fit 32 bits


def spawn(seed: int, stream: int, index: int = 0) -> np.random.RandomState:
    """A fresh deterministic generator for ``(seed, stream, index)``.

    ``index`` is the time axis of the stream (round index, availability
    block, ...); distinct (stream, index) pairs land on distinct
    multiplicative lanes so neighbouring rounds never share a schedule."""
    mixed = (int(seed) * 1_000_003 + int(stream) * 7_919
             + int(index) * 104_729) % _MOD
    return np.random.RandomState(mixed)
