"""The port's numpy copies of the workload scheduler
(``schedule/scheduler.py``) and of TurboAggregate's finite-field math
(``algorithms/turboaggregate.py``) against the JAX package's: bitwise on
the same inputs and seeds, every function, with the errors the JAX package
raises; and the field math's round trips."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import numpy as np
import pytest

from fedml_tpu.algorithms import turboaggregate as jmpc
from fedml_tpu.schedule import scheduler as jsched
from fedml_tpu_torch.algorithms import turboaggregate as mpc
from fedml_tpu_torch.schedule import scheduler as sched


def _equal(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("seed,n,resources", [(0, 12, 4), (1, 30, 3), (2, 5, 8), (3, 1, 1)])
def test_lpt_and_packing_are_copies(seed, n, resources):
    loads = np.random.RandomState(seed).randint(1, 100, n)
    _equal(sched.lpt_schedule(loads, resources), jsched.lpt_schedule(loads, resources))
    _equal(sched.balance_cohort_packing(loads, resources),
           jsched.balance_cohort_packing(loads, resources))
    caps = np.full(resources, loads.sum())
    _equal(sched.lpt_schedule(loads, resources, caps),
           jsched.lpt_schedule(loads, resources, caps))


def test_lpt_capacity_refusal_is_a_copy():
    for mod in (sched, jsched):
        with pytest.raises(ValueError, match="does not fit"):
            mod.lpt_schedule(np.array([5.0, 9.0]), 2, np.array([6.0, 6.0]))


@pytest.mark.parametrize("seed,n,resources", [(0, 8, 2), (1, 10, 3), (2, 6, 4), (3, 3, 1)])
def test_dp_schedule_is_a_copy(seed, n, resources):
    loads = np.random.RandomState(seed).rand(n) * 10
    got, want = sched.dp_schedule(loads, resources), jsched.dp_schedule(loads, resources)
    _equal(got, want)
    # optimal: no worse than the greedy split
    lpt = sched.lpt_schedule(loads, resources)
    assert got[1] <= max(loads[g].sum() for g in lpt if g) + 1e-12
    for mod in (sched, jsched):
        with pytest.raises(ValueError, match="exponential"):
            mod.dp_schedule(np.ones(21), 2)


def test_field_constants_and_inverse_are_copies():
    assert mpc.DEFAULT_PRIME == jmpc.DEFAULT_PRIME == 2**31 - 1
    a = np.random.RandomState(0).randint(1, mpc.DEFAULT_PRIME, 50)
    _equal(mpc.modular_inverse(a), jmpc.modular_inverse(a))
    assert np.all(mpc.modular_inverse(a) * a % mpc.DEFAULT_PRIME == 1)
    _equal(mpc.modular_inverse(7, 13), jmpc.modular_inverse(7, 13))


@pytest.mark.parametrize("n,t,seed", [(5, 2, 0), (7, 3, 11), (3, 1, None)])
def test_bgw_is_a_copy(n, t, seed):
    secret = np.random.RandomState(1).randint(0, 2**31 - 1, 16)
    if seed is None:  # unseeded shares are random: the decode still returns the secret
        shares = mpc.bgw_encode(secret, n, t)
    else:
        shares = mpc.bgw_encode(secret, n, t, seed=seed)
        _equal(shares, jmpc.bgw_encode(secret, n, t, seed=seed))
    idx = np.arange(n)[-(t + 1):]
    _equal(mpc.bgw_decode(shares[idx], idx), jmpc.bgw_decode(shares[idx], idx))
    np.testing.assert_array_equal(mpc.bgw_decode(shares[idx], idx), secret)
    _equal(mpc.lagrange_coefficients(idx + 1, 0), jmpc.lagrange_coefficients(idx + 1, 0))


@pytest.mark.parametrize("k,t,n", [(2, 0, 3), (3, 1, 5), (2, 2, 6)])
def test_lcc_is_a_copy(k, t, n):
    data = np.random.RandomState(2).randint(0, 1000, (k, 6))
    shares = mpc.lcc_encode(data, n, k, t, seed=4)
    _equal(shares, jmpc.lcc_encode(data, n, k, t, seed=4))
    idx = np.arange(n)[: k + t]
    got = mpc.lcc_decode(shares[idx], idx, k, t)
    _equal(got, jmpc.lcc_decode(shares[idx], idx, k, t))
    np.testing.assert_array_equal(got, data)


def test_additive_shares_and_dh_are_copies():
    secret = np.random.RandomState(3).randint(0, 2**31 - 1, (4, 3))
    shares = mpc.additive_shares(secret, 5, seed=7)
    _equal(shares, jmpc.additive_shares(secret, 5, seed=7))
    np.testing.assert_array_equal(shares.sum(axis=0) % mpc.DEFAULT_PRIME, secret)
    pa, pb = mpc.dh_keygen(5, 1234), mpc.dh_keygen(5, 98765)
    assert pa == jmpc.dh_keygen(5, 1234) and pb == jmpc.dh_keygen(5, 98765)
    assert mpc.dh_shared(pb, 1234) == mpc.dh_shared(pa, 98765) == jmpc.dh_shared(pb, 1234)


@pytest.mark.parametrize("scale", [2.0**16, 2.0**10])
def test_quantize_and_secure_sum_are_copies(scale):
    rng = np.random.RandomState(5)
    vecs = [rng.randn(20) for _ in range(4)]
    q = mpc.quantize(vecs[0], scale)
    _equal(q, jmpc.quantize(vecs[0], scale))
    _equal(mpc.dequantize(q, scale), jmpc.dequantize(q, scale))
    np.testing.assert_allclose(mpc.dequantize(q, scale), vecs[0], atol=0.5 / scale)
    got = mpc.secure_sum(vecs, seed=3)
    _equal(got, jmpc.secure_sum(vecs, seed=3))
    np.testing.assert_allclose(got, np.sum(vecs, axis=0), atol=4 * 0.5 / 2**16)
