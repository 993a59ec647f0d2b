"""Decentralized online learning in the port (``data/uci.py``, a copy, and
``exp/main_dol.py`` over ``algorithms/decentralized.py``'s
``run_online_gossip``) against the JAX package's.

Tolerances:

- ``synthetic_stream`` and ``load_streaming`` (the synthetic streams of
  both datasets, and a CSV of each layout): bitwise;
- ``main_dol`` for the three cases of ``tests/test_exp_entries.py``'s
  ``test_main_dol_smoke`` (DSGD; Push-Sum on the time-varying graph;
  static Push-Sum on an irregular 7-node graph, the column-stochastic
  transpose) and the entry's defaults (N=15, T=200): the regret figures
  within 1e-5 relative of the JAX CLI's (f32 logistic gradients and mixing
  products summed in other orders over T steps), the mode and iteration
  count equal; the late half of the stream cheaper than the early half;
- ``--iteration_number`` below 2 raises before the run, as in JAX.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import numpy as np
import pytest

from fedml_tpu.data import uci as juci
from fedml_tpu.exp import main_dol as jmain
from fedml_tpu_torch.data import uci
from fedml_tpu_torch.exp import main_dol

RTOL = 1e-5


@pytest.mark.parametrize("n,dim,seed,drift", [(50, 18, 0, 0.0), (120, 5, 3, 0.01),
                                              (7, 2, 1, 0.5)])
def test_synthetic_stream_is_a_copy(n, dim, seed, drift):
    got, want = uci.synthetic_stream(n, dim, seed, drift), juci.synthetic_stream(n, dim, seed,
                                                                                 drift)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["susy", "room_occupancy", "SUSY"])
def test_load_streaming_fallback_is_a_copy(name):
    got = uci.load_streaming(name, None, n_nodes=6, T=40, seed=2)
    want = juci.load_streaming(name, None, n_nodes=6, T=40, seed=2)
    assert got[0].shape == (40, 6, uci.FEATURE_DIMS[name.lower()])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,label_first", [("susy", True), ("room_occupancy", False)])
def test_load_streaming_csv_is_a_copy(tmp_path, name, label_first):
    """A CSV shorter than the stream is tiled; room occupancy's has a header
    and its label last, SUSY's its label first; a row with a NaN is
    dropped."""
    rng = np.random.RandomState(5)
    rows = rng.randn(37, 6)
    rows[:, 0 if label_first else -1] = rng.randint(0, 2, 37)
    rows[4, 2] = np.nan
    header = "" if label_first else "a,b,c,d,e,label\n"
    (tmp_path / "data.csv").write_text(
        header + "\n".join(",".join("nan" if np.isnan(v) else repr(float(v)) for v in r)
                           for r in rows) + "\n")
    got = uci.load_streaming(name, str(tmp_path), n_nodes=5, T=10)
    want = juci.load_streaming(name, str(tmp_path), n_nodes=5, T=10)
    assert got[0].shape == (10, 5, 5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown streaming dataset"):
        uci.load_streaming("higgs")


_SMOKE = ["--data_name", "SUSY", "--client_number", "6", "--iteration_number", "40",
          "--learning_rate", "0.05"]


@pytest.mark.parametrize("argv", [
    ["--mode", "dsgd", *_SMOKE],
    ["--mode", "pushsum", *_SMOKE, "--time_varying", "1"],
    # static pushsum on an irregular graph: the column-stochastic transpose
    ["--mode", "pushsum", *_SMOKE, "--client_number", "7",
     "--topology_neighbors_num_undirected", "3"],
    [],  # the entry's defaults: SUSY, N=15, T=200, DSGD
    ["--mode", "pushsum", "--data_name", "RO", "--time_varying", "1"],
])
def test_main_dol_matches_jax(argv):
    want = jmain.main(argv)
    got = main_dol.main(argv + ["--device", "cpu"])
    assert set(got) == set(want)
    assert got["mode"] == want["mode"] and got["iterations"] == want["iterations"]
    for k in ("final_regret", "avg_regret", "early_avg_loss", "late_avg_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert np.isfinite(got["final_regret"])
    assert got["late_avg_loss"] < got["early_avg_loss"]


def test_main_dol_refuses_a_one_round_stream():
    with pytest.raises(ValueError, match="iteration_number must be >= 2"):
        jmain.main(["--iteration_number", "1"])
    with pytest.raises(ValueError, match="iteration_number must be >= 2"):
        main_dol.main(["--iteration_number", "1", "--device", "cpu"])
