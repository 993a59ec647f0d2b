"""The port's TFF h5 path (``data/tff_h5.py``, ``data/tff_fixture.py``,
``data/stackoverflow.py``, the registry's h5 branches and the repro entry
points ``exp/repro_femnist_cnn``, ``repro_femnist_lr``,
``repro_fed_cifar100``, ``repro_stackoverflow_nwp``) against the JAX
package's, at small sizes (a few clients).

Tolerances:

- the fixture writers: the datasets in the files either package writes,
  and the vocabulary file, bitwise; the Markov source and its Bayes
  ceiling bitwise (the same numpy draws);
- the loaders, ``stackoverflow.py``'s helpers and the registry's five h5
  branches on the same files: every array bitwise, in the same dtype, and
  the same client partition;
- the repro entry points from the JAX run's initial variables: every round
  record atol 1e-5 (the LogisticRegression row) or 1e-4 (the CNN with its
  dropout rates forced to 0 on both sides, JAX's masks being
  irreproducible; the StackOverflow LSTM: f32 products summed in other
  orders, ``tests/test_torch_cli.py``'s CNN bound), ResNet18-GN's also
  rtol 1e-5 (its one round at lr 0.1 on 8 images drives the losses to ~20
  and ~28, where f32 spacing is ~2e-6), the result's data keys equal. The
  LR row's fixture ceiling is each package's own centralized run from its
  own draws, checked for its bounds only.
"""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import functools
import json

import h5py
import jax
import numpy as np
import pytest

import fedml_tpu.sim.engine as jax_engine
import fedml_tpu_torch.sim.engine as port_engine
from fedml_tpu.data import registry as jregistry
from fedml_tpu.data import stackoverflow as jso
from fedml_tpu.data import tff_fixture as jfix
from fedml_tpu.data import tff_h5 as jh5
from fedml_tpu.exp import repro_fed_cifar100 as j_cifar
from fedml_tpu.exp import repro_femnist_cnn as j_cnn
from fedml_tpu.exp import repro_femnist_lr as j_lr
from fedml_tpu.exp import repro_stackoverflow_nwp as j_nwp
from fedml_tpu.models import cnn as jax_cnn
from fedml_tpu_torch import convert
from fedml_tpu_torch.data import registry
from fedml_tpu_torch.data import stackoverflow as so
from fedml_tpu_torch.data import tff_fixture as fix
from fedml_tpu_torch.data import tff_h5
from fedml_tpu_torch.exp import (
    repro_fed_cifar100,
    repro_femnist_cnn,
    repro_femnist_lr,
    repro_stackoverflow_nwp,
)
from fedml_tpu_torch.models import cnn as port_cnn

# each writer's small arguments
WRITERS = {
    "femnist": ("write_femnist_h5_fixture", dict(n_clients=6, seed=1),
                ["fed_emnist_train.h5", "fed_emnist_test.h5"]),
    "fed_cifar100": ("write_fed_cifar100_h5_fixture",
                     dict(n_train_clients=3, n_test_clients=2, samples_per_client=6, seed=2),
                     ["fed_cifar100_train.h5", "fed_cifar100_test.h5"]),
    "stackoverflow_nwp": ("write_stackoverflow_nwp_fixture",
                          dict(n_clients=12, seed=3, vocab_size=60, active_words=20,
                               test_clients=4, max_sent=5),
                          ["stackoverflow_train.h5", "stackoverflow_test.h5"]),
}


def _datasets(path) -> dict:
    """Every dataset of an h5 file by its path, as numpy arrays."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj[()]))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _write(pkg_fix, name, out_dir):
    fn, kwargs, files = WRITERS[name]
    getattr(pkg_fix, fn)(out_dir, **kwargs)
    return files


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_fixture_writers_hold_the_jax_datasets(tmp_path, name):
    files = _write(fix, name, tmp_path / "port")
    _write(jfix, name, tmp_path / "jax")
    for f in files:
        got, want = _datasets(tmp_path / "port" / f), _datasets(tmp_path / "jax" / f)
        assert got.keys() == want.keys() and got
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{f} {k}")
    if name == "stackoverflow_nwp":
        assert ((tmp_path / "port" / "stackoverflow.word_count").read_bytes()
                == (tmp_path / "jax" / "stackoverflow.word_count").read_bytes())
    # the same marker: either package reuses the other's fixture
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())


@pytest.mark.parametrize("kw", [{}, dict(active_words=40, seed=2, alpha=0.01, clusters=5)])
def test_markov_source_and_bayes_ceiling_are_copies(kw):
    for a, b in zip(fix.stackoverflow_markov_source(**kw), jfix.stackoverflow_markov_source(**kw)):
        np.testing.assert_array_equal(a, b)
    assert fix.stackoverflow_bayes_ceiling(**kw) == jfix.stackoverflow_bayes_ceiling(**kw)


def _write_shakespeare(d):
    """A fed_shakespeare pair in the TFF schema (``snippets`` strings), one
    client with no usable text."""
    dt = h5py.string_dtype()
    texts = {"alice": ["To be, or not to be: that is the question.", "Ay, there's the rub"],
             "bob": ["x"], "carol": ["Now is the winter of our discontent " * 4]}
    for split in ("train", "test"):
        with h5py.File(d / f"shakespeare_{split}.h5", "w") as f:
            g = f.create_group("examples")
            for cid, snippets in texts.items():
                g.create_group(cid).create_dataset("snippets", data=snippets, dtype=dt)


def _write_stackoverflow_lr(d):
    """A stackoverflow_lr set: token and tag strings per client, the word
    and tag count files; a client only in train, an OOV word and tag."""
    dt = h5py.string_dtype()
    clients = {"c1": (["how to sort a list", "sort dict by value"], ["python|list", "python"]),
               "c2": (["segfault in c code", "unknown words here"], ["c|pointers", "zzz"]),
               "c3": (["list of list"], ["python|list"])}
    for split, ids in (("train", ["c1", "c2", "c3"]), ("test", ["c1", "c3"])):
        with h5py.File(d / f"stackoverflow_{split}.h5", "w") as f:
            g = f.create_group("examples")
            for cid in ids:
                toks, tags = clients[cid]
                grp = g.create_group(cid)
                grp.create_dataset("tokens", data=toks, dtype=dt)
                grp.create_dataset("tags", data=tags, dtype=dt)
    words = ["list", "sort", "to", "a", "how", "dict", "by", "value", "in", "c", "code", "of"]
    (d / "stackoverflow.word_count").write_text("".join(f"{w} {100 - i}\n"
                                                        for i, w in enumerate(words)))
    (d / "stackoverflow.tag_count").write_text(json.dumps({"python": 9, "list": 5, "c": 3,
                                                           "pointers": 1}))


def _same_fed(got, want):
    assert got.partition.keys() == want.partition.keys()
    for c in want.partition:
        np.testing.assert_array_equal(got.partition[c], want.partition[c])
    _same_arrays(got.arrays, want.arrays)


def _same_arrays(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _loaded(name, d, mod_h5, mod_so, **kw):
    if name == "femnist":
        return mod_h5.load_federated_emnist(d, **kw)
    if name == "fed_cifar100":
        return mod_h5.load_fed_cifar100(d, **kw)
    if name == "fed_shakespeare":
        return mod_h5.load_fed_shakespeare(d, seq_len=12, **kw)
    if name == "stackoverflow_nwp":
        return mod_h5.load_stackoverflow_nwp(d, vocab_size=60, seq_len=12, **kw)
    return mod_so.load_stackoverflow_lr(d, vocab_size=8, tag_size=3, **kw)


def _jax_files(name, d):
    """The files of ``name``'s branch, written by the JAX package's writer
    or by hand where it has none."""
    if name in WRITERS:
        _write(jfix, name, d)
    elif name == "fed_shakespeare":
        _write_shakespeare(d)
    else:
        _write_stackoverflow_lr(d)


H5_SETS = ["femnist", "fed_cifar100", "fed_shakespeare", "stackoverflow_nwp", "stackoverflow_lr"]


@pytest.mark.parametrize("name", H5_SETS)
@pytest.mark.parametrize("limit", [None, 2])
def test_loaders_read_jax_files_as_jax_does(tmp_path, name, limit):
    d = tmp_path / name
    d.mkdir()
    _jax_files(name, d)
    got = _loaded(name, d, tff_h5, so, limit_clients=limit)
    want = _loaded(name, d, jh5, jso, limit_clients=limit)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            _same_arrays(g, w)
        elif isinstance(w, int):
            assert g == w
        else:
            _same_fed(g, w)


def test_stackoverflow_helpers_are_copies(tmp_path):
    _write_stackoverflow_lr(tmp_path)
    for size in (5, 12, 100):
        assert so.load_word_dict(tmp_path, size) == jso.load_word_dict(tmp_path, size)
    assert so.load_tag_dict(tmp_path, 2) == jso.load_tag_dict(tmp_path, 2)
    words, tags = jso.load_word_dict(tmp_path), jso.load_tag_dict(tmp_path)
    sentences = ["how to sort a list", "nothing known", "list list of c"]
    np.testing.assert_array_equal(so.sentences_to_bow(sentences, words),
                                  jso.sentences_to_bow(sentences, words))
    np.testing.assert_array_equal(so.tags_to_multihot(["python|c", "zzz", "list"], tags),
                                  jso.tags_to_multihot(["python|c", "zzz", "list"], tags))
    assert so.has_real_files(tmp_path) and jso.has_real_files(tmp_path)
    assert not so.has_real_files(tmp_path / "none")


@pytest.mark.parametrize("name", H5_SETS)
def test_registry_h5_branches_match_jax(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    _jax_files(name, d)
    got = registry.load_partition_data(name, str(d), client_num_in_total=2)
    want = jregistry.load_partition_data(name, str(d), client_num_in_total=2)
    assert got.class_num == want.class_num
    _same_fed(got.train, want.train)
    _same_arrays(got.test_arrays, want.test_arrays)
    if want.test_fed is not None:
        _same_fed(got.test_fed, want.test_fed)
    else:
        assert got.test_fed is None


# -- the repro entry points --------------------------------------------------------


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _port_from_jax_init(monkeypatch, jax_main, port_main, argv, tmp_path):
    """The JAX entry point, then the port's from the JAX run's initial
    variables; each writes its fixture under its own directory. Returns
    ``(port result, JAX result, port records, JAX records)``."""
    captured = {}
    original = jax_engine.FedSim.init_round_variables

    def capture(self, overrides=None):
        v = original(self, overrides)
        captured["v"] = convert.from_flax(jax.tree.map(np.asarray, dict(v)))
        return v

    monkeypatch.setattr(jax_engine.FedSim, "init_round_variables", capture)
    want = jax_main(argv + ["--data_dir", str(tmp_path / "jax_data"),
                            "--metrics_out", str(tmp_path / "jax.jsonl"),
                            "--out", str(tmp_path / "JAX.md")])
    monkeypatch.setattr(port_engine.FedSim, "init_variables",
                        lambda self: {k: t.clone() for k, t in captured["v"].items()})
    got = port_main(argv + ["--data_dir", str(tmp_path / "port_data"), "--device", "cpu",
                            "--metrics_out", str(tmp_path / "port.jsonl"),
                            "--out", str(tmp_path / "PORT.md")])
    return got, want, _records(tmp_path / "port.jsonl"), _records(tmp_path / "jax.jsonl")


def _hold(got, want, t_recs, j_recs, atol, keys=("dataset", "clients", "samples", "rounds"),
          rtol=1e-7):
    assert set(got) == set(want)
    for k in keys:
        assert got[k] == want[k], k
    assert len(t_recs) == len(j_recs) > 0
    for j, t in zip(j_recs, t_recs):
        ks = set(j) - {"round_time", "_ts"}
        assert ks == set(t) - {"round_time"}
        for k in ks:
            np.testing.assert_allclose(t[k], j[k], rtol=rtol, atol=atol,
                                       err_msg=f"round {j['round']} {k}")


SMALL_FEMNIST = ["--client_num_in_total", "6", "--client_num_per_round", "3", "--comm_round",
                 "2", "--frequency_of_the_test", "1"]


def test_repro_femnist_cnn_matches_jax(monkeypatch, tmp_path):
    flax_dropout = jax_cnn.nn.Dropout
    monkeypatch.setattr(jax_cnn.nn, "Dropout",
                        lambda rate, deterministic: flax_dropout(0.0, deterministic=deterministic))
    monkeypatch.setattr(port_cnn, "CNNDropOut",
                        functools.partial(port_cnn.CNNDropOut, dropout_rates=(0.0, 0.0)))
    got, want, t_recs, j_recs = _port_from_jax_init(
        monkeypatch, j_cnn.main, repro_femnist_cnn.main, SMALL_FEMNIST + ["--batch_size", "40"],
        tmp_path)
    _hold(got, want, t_recs, j_recs, 1e-4)
    assert "femnist_cnn_torch" in (tmp_path / "PORT.md").read_text()


def test_repro_femnist_lr_matches_jax(monkeypatch, tmp_path):
    got, want, t_recs, j_recs = _port_from_jax_init(
        monkeypatch, j_lr.main, repro_femnist_lr.main, SMALL_FEMNIST, tmp_path)
    _hold(got, want, t_recs, j_recs, 1e-5)
    assert 0.0 < got["fixture_ceiling"] <= 1.0 and got["ceiling_epochs"] >= 1
    best = max(r["Test/Acc"] for r in t_recs if "Test/Acc" in r)
    assert got["pct_of_ceiling"] == round(100 * best / got["fixture_ceiling"], 1)


def test_repro_fed_cifar100_matches_jax(monkeypatch, tmp_path):
    got, want, t_recs, j_recs = _port_from_jax_init(
        monkeypatch, j_cifar.main, repro_fed_cifar100.main,
        ["--client_num_in_total", "4", "--n_test_clients", "2", "--samples_per_client", "8",
         "--client_num_per_round", "2", "--batch_size", "8", "--comm_round", "1",
         "--frequency_of_the_test", "1"], tmp_path)
    _hold(got, want, t_recs, j_recs, 1e-4, rtol=1e-5)


def test_repro_stackoverflow_nwp_matches_jax(monkeypatch, tmp_path):
    got, want, t_recs, j_recs = _port_from_jax_init(
        monkeypatch, j_nwp.main, repro_stackoverflow_nwp.main,
        ["--client_num_in_total", "12", "--test_clients", "4", "--vocab_size", "60",
         "--embedding_dim", "8", "--hidden_size", "16", "--client_num_per_round", "4",
         "--comm_round", "2", "--frequency_of_the_test", "1", "--fixture_max_sent", "5",
         "--train_eval_samples", "0", "--stop_at_learnable_frac", "0"], tmp_path)
    _hold(got, want, t_recs, j_recs, 1e-4,
          keys=("dataset", "clients", "samples", "rounds", "fixture_bayes_ceiling",
                "eos_only_floor"))


def test_repro_stackoverflow_nwp_refuses_a_mesh(tmp_path):
    """``--mesh_shape`` lays its mesh over the world the run is started in:
    a 1 x 2 mesh in one process raises ``shard_mesh``'s count error."""
    with pytest.raises(ValueError, match=r"requires 2 devices .* only 1 are available"):
        repro_stackoverflow_nwp.main(["--client_num_in_total", "4", "--test_clients", "2",
                                      "--vocab_size", "30", "--mesh_shape", "1x2",
                                      "--data_dir", str(tmp_path), "--device", "cpu"])
