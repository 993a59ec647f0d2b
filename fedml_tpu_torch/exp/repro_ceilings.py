"""Fixture ceilings, a copy of ``markov_bayes_ceiling`` from
``fedml_tpu/exp/repro_ceilings.py`` (pure numpy).

Not ported: ``centralized_ceiling`` and the per-row ceiling builders, which
are ROADMAP §A7b.
"""

from __future__ import annotations

import numpy as np


def markov_bayes_ceiling(vocab=90, seed=0):
    """Exact Bayes-optimal next-char accuracy of the synthetic_char_lm
    fixture: the generator's transition matrix is reproducible from the
    seed (``data.registry.synthetic_char_lm`` draws it FIRST from its
    RandomState), and the optimum predictor argmax_j T[i, j] is right with
    probability sum_i pi_i max_j T[i, j] under the stationary distribution
    pi."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab)
    # stationary distribution: leading left eigenvector of T
    evals, evecs = np.linalg.eig(trans.T)
    pi = np.real(evecs[:, np.argmax(np.real(evals))])
    pi = np.abs(pi) / np.abs(pi).sum()
    return float(np.sum(pi * trans.max(axis=1)))
