"""The port's streaming Byzantine-robust wire server
(``fedml_tpu_torch/algorithms/robust_distributed.py``) against the JAX
package's, on the CPU.

The aggregators are fed the same captured uploads (``pack_pytree`` bytes of
a tree with BatchNorm statistics, so the norm mask is exercised) in the
same order. Krum runs with the JAX ``krum_select`` replaced by the Krum rule
(``tests/test_torch_robust.py``'s ``_correct_jax_krum``; the JAX one always
returns client 0, ROADMAP §C).

Tolerances:

- mean (clip on and off) and the reservoir's draws: bitwise (the same numpy
  arithmetic; the clip factor is f32 in both); median and Krum: bitwise (a
  midpoint of two f32 values, a selected upload); trimmed mean: atol 5e-7,
  one f32 ulp at the fixture's magnitudes below 4 (torch's and XLA's f32
  sums run in other orders); the Robust/* records equal (the trimmed
  mean's second round, from globals an ulp apart: rel 1e-6);
- streaming against buffered, a snapshot restored against an uninterrupted
  tally, and a noised aggregate against itself: bitwise;
- the wire runs (``--algorithm fedavg_robust`` and the robust compressed
  arm) atol 1e-5 of the JAX runs at stddev 0 (the port's local steps round
  otherwise); at stddev 0.05 the noise (the run's aggregate less the same
  tally without noise) has mean within 0.01 and standard deviation within
  10% of 0.05 over 4000 coordinates, in both packages (the port draws from
  ``RoundNoise``, JAX from its keys: other numbers, ROADMAP §C).
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import argparse

import numpy as np
import pytest

from fedml_tpu.algorithms import robust_distributed as jrd
from fedml_tpu.comm import message as jmsg
from fedml_tpu.exp import main_fedavg as jmain
from fedml_tpu.obs.checkpoint import load_params as jax_load_params
from fedml_tpu_torch.algorithms import fedavg_distributed as tfd
from fedml_tpu_torch.algorithms import robust as trobust
from fedml_tpu_torch.algorithms import robust_distributed as trd
from fedml_tpu_torch.compress import codec as tcodec
from fedml_tpu_torch.exp import main_fedavg as tmain
from fedml_tpu_torch.obs import checkpoint
from tests.test_torch_fedavg_dist import (
    _assert_close_to_jax,
    _blobs,
    _lr_pair,
    _run_jax,
    _run_port,
)
from tests.test_torch_robust import _correct_jax_krum
from tests.test_torch_wire_families import BASE, init_file  # noqa: F401  (a fixture)

PKG = {"jax": jrd, "port": trd}


def _tree(rng, d=40):
    return {"batch_stats": {"BatchNorm_0": {"mean": rng.randn(6).astype(np.float32)}},
            "params": {"Dense_0": {"bias": rng.randn(4).astype(np.float32),
                                   "kernel": rng.randn(d // 4, 4).astype(np.float32)}}}


def _uploads(seed=0, n=7, d=40):
    """A global and ``n`` uploads in the wire layout: small perturbations,
    one large (clipped at norm_bound 1), one non-finite (rejected)."""
    rng = np.random.RandomState(seed)
    g = _tree(rng, d)
    flat, desc = jmsg.pack_pytree(g)
    base = flat.view(np.float32)
    out = []
    for i in range(n):
        x = base + rng.randn(base.size).astype(np.float32) * np.float32(0.05 * (1 + i % 3))
        if i == 2:
            x = base + rng.randn(base.size).astype(np.float32) * np.float32(3.0)
        if i == 4:
            x = x.copy()
            x[5] = np.nan
        out.append((i, x.astype(np.float32).view(np.uint8), float(5 + i)))
    return flat, desc, out


def _tally(pkg, config_kw, flat, desc, uploads, buffered=False, rounds=1):
    mod = PKG[pkg]
    cfg = mod.RobustDistConfig(**config_kw)
    cls = mod.BufferedRobustDistAggregator if buffered else mod.RobustDistAggregator
    agg = cls(len(uploads), cfg, model_desc=desc)
    state = {"g": flat}
    agg.get_global = lambda: state["g"]
    outs, recs = [], []
    for _ in range(rounds):
        for i, x, n in uploads:
            agg.add_local_trained_result(i, x, n)
        state["g"] = agg.aggregate()
        outs.append(np.array(state["g"]))
        recs.append(agg.pop_round_stats())
    return outs, recs, agg


CONFIGS = [
    dict(rule="mean"), dict(rule="mean", norm_bound=1.0),
    dict(rule="median", norm_bound=1.0), dict(rule="median", reservoir_k=3, dp_seed=4),
    dict(rule="trimmed_mean", trim_ratio=0.2), dict(rule="trimmed_mean", reservoir_k=5),
    dict(rule="krum", norm_bound=1.0), dict(rule="krum", reservoir_k=5, dp_seed=1),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_robust_tally_matches_jax(cfg, monkeypatch):
    monkeypatch.setattr(jrd, "krum_select", _correct_jax_krum)
    flat, desc, ups = _uploads()
    theirs = _tally("jax", cfg, flat, desc, ups, rounds=2)
    ours = _tally("port", cfg, flat, desc, ups, rounds=2)
    for a, b in zip(ours[0], theirs[0]):
        if cfg["rule"] == "trimmed_mean":
            np.testing.assert_allclose(a.view(np.float32), b.view(np.float32), rtol=0, atol=5e-7)
        else:
            np.testing.assert_array_equal(a, b)
    if cfg["rule"] == "trimmed_mean":  # round 1 starts from globals an ulp apart
        assert ours[1][0] == theirs[1][0]
        for a, b in zip(ours[1][1].values(), theirs[1][1].values()):
            assert a == pytest.approx(b, rel=1e-6)
    else:
        assert ours[1] == theirs[1]
    assert ours[1][0]["Robust/FilteredClients"] >= 1  # the non-finite upload
    assert np.isfinite(ours[0][-1].view(np.float32)).all()


def test_flat_norm_helpers_equal_jax():
    from fedml_tpu.algorithms import robust as jrobust

    _, desc, ups = _uploads()
    mask = trobust.flat_norm_mask(desc)
    np.testing.assert_array_equal(mask, jrobust.flat_norm_mask(desc))
    assert mask.sum() == 44 and not mask[:6].any()
    delta = ups[0][1].view(np.float32) - ups[1][1].view(np.float32)
    assert trobust.flat_delta_norm(delta, mask) == jrobust.flat_delta_norm(delta, mask)
    no_bn = jmsg.pack_pytree({"params": {"w": np.ones(3, np.float32)}})[1]
    assert trobust.flat_norm_mask(no_bn) is None is jrobust.flat_norm_mask(no_bn)


def test_every_upload_non_finite_keeps_the_previous_global():
    flat, desc, ups = _uploads()
    bad = [(i, np.full(flat.size // 4, np.inf, np.float32).view(np.uint8), n)
           for i, _, n in ups]
    for rule in ("mean", "median"):
        outs, recs, _ = _tally("port", dict(rule=rule, dp_stddev=0.5), flat, desc, bad)
        np.testing.assert_array_equal(outs[0], flat)
        assert recs[0]["Robust/FilteredClients"] == len(bad)


@pytest.mark.parametrize("cfg", CONFIGS[1:4] + [dict(rule="mean", dp_stddev=0.1, dp_seed=3)],
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_streaming_matches_buffered_bitwise(cfg):
    flat, desc, ups = _uploads(seed=2)
    streaming = _tally("port", cfg, flat, desc, ups, rounds=3)
    buffered = _tally("port", cfg, flat, desc, ups, buffered=True, rounds=3)
    for a, b in zip(streaming[0], buffered[0]):
        np.testing.assert_array_equal(a, b)
    assert streaming[1] == buffered[1]


def test_snapshot_and_restore_resume_the_schedule():
    """A tally snapshotted mid-round (reservoir full) and at a round close,
    restored into a fresh aggregator, continues bitwise as the original;
    the snapshot's keys are the JAX package's."""
    flat, desc, ups = _uploads(seed=5)
    cfg = dict(rule="median", reservoir_k=3, dp_stddev=0.2, dp_seed=9)
    whole = _tally("port", cfg, flat, desc, ups, rounds=2)[0]
    _, _, agg = _tally("port", cfg, flat, desc, ups, rounds=1)
    for i, x, n in ups[:5]:
        agg.add_local_trained_result(i, x, n)
    snap = agg.snapshot_state()
    jagg = jrd.RobustDistAggregator(len(ups), jrd.RobustDistConfig(**cfg), model_desc=desc)
    jagg.get_global = lambda: flat
    for i, x, n in ups[:5]:
        jagg.add_local_trained_result(i, x, n)
    assert snap.keys() == jagg.snapshot_state().keys()
    fresh = trd.RobustDistAggregator(len(ups), trd.RobustDistConfig(**cfg), model_desc=desc)
    fresh.restore_state(snap)
    fresh.get_global = lambda: whole[0]
    for i, x, n in ups[5:]:
        fresh.add_local_trained_result(i, x, n)
    np.testing.assert_array_equal(fresh.aggregate(), whole[1])


def test_dp_noise_is_seeded_and_gaussian():
    """The noise is a function of (dp_seed, round): the same in both arms
    and reruns, other in the next round; its spread is the configured
    stddev in both packages."""
    flat, desc, ups = _uploads(seed=1, d=4000)
    sigma = 0.05
    cfg = dict(rule="mean", dp_stddev=sigma, dp_seed=2)
    clean = _tally("port", dict(rule="mean"), flat, desc, ups)[0][0].view(np.float32)
    for pkg in ("port", "jax"):
        noised = _tally(pkg, cfg, flat, desc, ups)[0][0]
        noise = noised.view(np.float32).astype(np.float64) - clean
        assert abs(noise.mean()) < 0.01 and abs(noise.std() / sigma - 1) < 0.1, pkg
    ours = _tally("port", cfg, flat, desc, ups)[0]
    twice = _tally("port", cfg, flat, desc, ups, rounds=2)[0]
    np.testing.assert_array_equal(ours[0], twice[0])
    other_seed = _tally("port", {**cfg, "dp_seed": 3}, flat, desc, ups)[0]
    assert not np.array_equal(ours[0], other_seed[0])


@pytest.mark.parametrize("arm", ["dense-median", "dense-mean-clip", "topk-mean-clip"])
def test_robust_wire_run_matches_jax(arm, monkeypatch):
    (jtr, ttr), (jdata, tdata) = _lr_pair(), _blobs()
    kind, rule, *clip = arm.split("-")
    kw = dict(rule=rule, norm_bound=0.3 if clip else 0.0)
    # the JAX run's own clients: its runner refuses robust_config= beside
    # custom client classes
    jkw = {"robust_config": jrd.RobustDistConfig(**kw), "robust_stats": {},
           "client_cls_for_rank": None}
    tkw = {"robust_config": trd.RobustDistConfig(**kw), "robust_stats": {}}
    if kind == "topk":
        from fedml_tpu.compress import codec as jcodec

        jkw["codec"] = jcodec.make_codec("topk", topk_frac=0.2)
        tkw["codec"] = tcodec.make_codec("topk", topk_frac=0.2)
    jfinal, template = _run_jax(jtr, jdata, **jkw)
    tfinal = _run_port(ttr, tdata, template, **tkw)
    _assert_close_to_jax(jfinal, tfinal, atol=1e-5)
    assert len(tkw["robust_stats"]["rounds"]) == len(jkw["robust_stats"]["rounds"]) == 2
    for a, b in zip(tkw["robust_stats"]["rounds"], jkw["robust_stats"]["rounds"]):
        assert a.keys() == b.keys() and a["Robust/ClipFraction"] == b["Robust/ClipFraction"]
        assert a["Robust/UpdateNorm"] == pytest.approx(b["Robust/UpdateNorm"], rel=1e-4)


def test_robust_config_is_refused_with_custom_managers():
    _, ttr = _lr_pair()
    _, tdata = _blobs()
    with pytest.raises(ValueError, match="does not compose with custom manager"):
        tfd.run_distributed_fedavg_loopback(ttr, tdata, 4, 1, 10,
                                            robust_config=trd.RobustDistConfig(rule="median"),
                                            server_cls=tfd.FedAvgServerManager)
    with pytest.raises(ValueError, match="unknown robust rule"):
        trd.RobustDistConfig(rule="mode")
    with pytest.raises(ValueError, match="reservoir_k must be >= 0"):
        trd.RobustDistConfig(reservoir_k=-1)
    assert not trd.RobustDistConfig().enabled


@pytest.mark.parametrize("extra", [
    # a reservoir as large as the round keeps every upload: the exact rule,
    # whatever the arrival order (a smaller one samples by arrival order,
    # which differs between runs)
    ["--robust_rule", "median", "--norm_bound", "0.5", "--reservoir_k", "4"],
    ["--robust_rule", "mean", "--norm_bound", "0.2"],
], ids=["median-reservoir", "mean-clip"])
def test_main_fedavg_robust_wire_matches_the_jax_cli(tmp_path, init_file, extra):  # noqa: F811
    argv = BASE + ["--init_from", init_file, "--algorithm", "fedavg_robust"] + extra
    jfinal = jmain.main(argv + ["--save_params_to", str(tmp_path / "jax.npz")])
    tfinal = tmain.main(argv + ["--device", "cpu", "--save_params_to",
                                str(tmp_path / "port.npz")])
    assert jfinal.keys() == tfinal.keys() and "Robust/ClipFraction" in tfinal
    for k, v in jfinal.items():
        assert tfinal[k] == pytest.approx(v, abs=1e-5), k
    _assert_close_to_jax(jax_load_params(tmp_path / "jax.npz"),
                         checkpoint.load_params(tmp_path / "port.npz"), atol=1e-5)


def test_main_fedavg_robust_noise_by_distribution(tmp_path, init_file):  # noqa: F811
    """At ``--stddev`` > 0 the port's run differs from its stddev-0 run by
    noise of that spread (LogisticRegression's 68 variables: mean within
    3 sigma / sqrt(68), spread within 35%), and reruns bitwise."""
    argv = BASE + ["--init_from", init_file, "--algorithm", "fedavg_robust", "--device",
                   "cpu", "--comm_round", "1"]
    outs = []
    for stddev in ("0.0", "0.5", "0.5"):
        path = tmp_path / f"m{len(outs)}.npz"
        tmain.main(argv + ["--stddev", stddev, "--save_params_to", str(path)])
        p = checkpoint.load_params(path)
        outs.append(np.concatenate([p[k].numpy().ravel() for k in sorted(p)]))
    noise = outs[1].astype(np.float64) - outs[0]
    assert abs(noise.mean()) < 3 * 0.5 / np.sqrt(noise.size)
    assert abs(noise.std() / 0.5 - 1) < 0.35
    np.testing.assert_array_equal(outs[1], outs[2])
    args = tmain.add_args(argparse.ArgumentParser()).parse_args(argv + ["--reservoir_k", "2"])
    assert args.reservoir_k == 2
