"""The ``tag`` task (multi-label tag prediction, ``stackoverflow_lr``) and
the CLI's recurrent rows, the port against the JAX package.

Tolerances: ``tag_loss`` and ``tag_metrics`` against JAX at atol 1e-6 (the
same f32 log-sigmoids, summed in other orders); the engines' pooled and
per-client eval of the tag metrics from the same variables at rtol 1e-6
(per-client sums of up to hundreds of counts and losses); the CLI's final round
record, port against JAX from the same initial variables, at atol 1e-4
(``--model lr --dataset stackoverflow_lr``: two rounds of SGD on 500
sigmoid outputs; ``--model rnn`` on ``shakespeare`` and ``fed_shakespeare``:
two rounds through two LSTM layers over 20 steps). The StackOverflow NWP
row runs once, port only: its fixture draws a 10004 x 10004 transition
matrix, and the model's parity is ``tests/test_torch_rnn.py``'s."""

from tests import test_torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.sim.engine as jax_engine
import fedml_tpu_torch.sim.engine as port_engine
from fedml_tpu.core import trainer as jax_trainer
from fedml_tpu.exp import main_fedavg as jax_cli
from fedml_tpu_torch import convert
from fedml_tpu_torch.core import trainer
from fedml_tpu_torch.exp import main_fedavg as port_cli


def _tag_batch(rng, b=9, tags=13):
    logits = (3 * rng.randn(b, tags)).astype(np.float32)
    y = (rng.rand(b, tags) < 0.3).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0
    return logits, {"x": np.zeros((b, 4), np.float32), "y": y, "mask": mask}


def test_tag_loss_and_metrics_match_jax(rng):
    logits, batch = _tag_batch(rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(trainer.tag_loss(torch.tensor(logits), tb)),
                               float(jax_trainer.tag_loss(jnp.asarray(logits), jb)), atol=1e-6)
    want = jax_trainer.tag_metrics(jnp.asarray(logits), jb)
    got = trainer.tag_metrics(torch.tensor(logits), tb)
    assert set(got) == set(want) == {"test_correct", "test_loss", "test_total",
                                     "test_precision", "test_recall"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6, err_msg=k)
    # an all-padding batch: counts 0, the clamped denominators 1
    empty = {**tb, "mask": torch.zeros(9)}
    m = trainer.tag_metrics(torch.tensor(logits), empty)
    assert float(m["test_total"]) == 1.0 and float(m["test_correct"]) == 0.0
    assert "tag" in trainer.TASKS


def test_tag_gradients_match_jax(rng):
    logits, batch = _tag_batch(rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g_j = jax.grad(lambda z: jax_trainer.tag_loss(z, jb))(jnp.asarray(logits))
    z = torch.tensor(logits, requires_grad=True)
    trainer.tag_loss(z, {k: torch.tensor(v) for k, v in batch.items()}).backward()
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(g_j), atol=1e-6)


def test_engine_eval_treats_tag_metrics_as_jax(rng):
    """The pooled eval reads test_correct / test_total / test_loss and drops
    the precision and recall; the per-client eval returns every key summed
    over each client's batches. Both as the JAX engine does."""
    from fedml_tpu.core.trainer import ClientTrainer as JaxTrainer
    from fedml_tpu.data.registry import synthetic_tag_prediction as jax_tag_data
    from fedml_tpu.models.linear import LogisticRegression as JaxLR
    from fedml_tpu.sim.engine import FedSim as JaxSim
    from fedml_tpu.sim.engine import SimConfig as JaxConfig
    from fedml_tpu_torch.data.registry import synthetic_tag_prediction
    from fedml_tpu_torch.models.linear import LogisticRegression
    from fedml_tpu_torch.sim.engine import FedSim, SimConfig

    cfg = dict(client_num_in_total=4, client_num_per_round=4, batch_size=16,
               eval_batch_size=16)
    j_train, j_test, _ = jax_tag_data(n_clients=4, dim=60, tags=20, samples=24, seed=3)
    train, test, _ = synthetic_tag_prediction(n_clients=4, dim=60, tags=20, samples=24, seed=3)
    jsim = JaxSim(JaxTrainer(module=JaxLR(num_classes=20), task="tag"), j_train, j_test,
                  JaxConfig(**cfg))
    j_vars = jsim.init_round_variables()
    tsim = FedSim(trainer.ClientTrainer(module=LogisticRegression(20, 60, device="cpu"),
                                        task="tag"), train, test, SimConfig(**cfg), device="cpu")
    t_vars = convert.from_flax(jax.tree.map(np.asarray, dict(j_vars)))
    j_eval, t_eval = jsim.evaluate(j_vars), tsim.evaluate(t_vars)
    assert set(t_eval) == set(j_eval) == {"Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"}
    for k in j_eval:
        np.testing.assert_allclose(t_eval[k], j_eval[k], rtol=1e-6, err_msg=k)
    j_pc, t_pc = jsim.evaluate_per_client(j_vars), tsim.evaluate_per_client(t_vars)
    assert set(t_pc) == set(j_pc) >= {"test_precision", "test_recall"}
    for k in j_pc:
        np.testing.assert_allclose(t_pc[k], j_pc[k], rtol=1e-6, err_msg=k)


def _port_run_from_jax_init(monkeypatch, argv, tmp_path):
    """JAX main, then the port's main from the JAX run's initial variables."""
    captured = {}
    original = jax_engine.FedSim.init_round_variables

    def capture(self, overrides=None):
        v = original(self, overrides)
        captured["v"] = convert.from_flax(jax.tree.map(np.asarray, dict(v)))
        return v

    monkeypatch.setattr(jax_engine.FedSim, "init_round_variables", capture)
    argv = argv + ["--data_dir", str(tmp_path / "none")]
    want = jax_cli.main(argv)
    monkeypatch.setattr(port_engine.FedSim, "init_variables",
                        lambda self: {k: t.clone() for k, t in captured["v"].items()})
    got = port_cli.main(argv + ["--device", "cpu"])
    return got, want


RUNS = {
    "stackoverflow_lr": ["--model", "lr", "--dataset", "stackoverflow_lr", "--lr", "0.5"],
    "shakespeare_rnn": ["--model", "rnn", "--dataset", "shakespeare", "--lr", "1.0",
                        "--batch_size", "4"],
    "fed_shakespeare_rnn": ["--model", "rnn", "--dataset", "fed_shakespeare", "--lr", "1.0",
                            "--batch_size", "8"],
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_final_record_matches_jax(monkeypatch, tmp_path, name):
    argv = ["--client_num_in_total", "4", "--client_num_per_round", "3", "--comm_round", "2",
            "--frequency_of_the_test", "2"] + RUNS[name]
    got, want = _port_run_from_jax_init(monkeypatch, argv, tmp_path)
    assert set(got) - {"round_time"} == set(want) - {"round_time", "_ts"}
    assert got["round"] == want["round"] == 1
    for k in set(want) - {"round", "round_time", "_ts"}:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_cli_stackoverflow_nwp_runs_on_the_fallback(tmp_path):
    final = port_cli.main(["--model", "rnn", "--dataset", "stackoverflow_nwp",
                           "--client_num_in_total", "3", "--client_num_per_round", "2",
                           "--batch_size", "8", "--comm_round", "1", "--lr", "0.316",
                           "--data_dir", str(tmp_path / "none"), "--device", "cpu"])
    assert final["round"] == 0
    assert all(np.isfinite(final[k]) for k in ("Train/Loss", "Test/Loss", "Test/Acc"))
    assert abs(final["Train/Loss"] - np.log(10004)) < 1.0  # near uniform after one round
