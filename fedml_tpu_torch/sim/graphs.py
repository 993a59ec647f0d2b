"""CUDA graphs of the FedSim's work on the card: a round captured once and
replayed for every round of a block (:class:`RoundGraph`), and a packed
round's lane pass captured once and replayed for every pass
(:class:`PassGraph`).

The JAX engine runs an eval-aligned block of R rounds as one program, a
``lax.scan`` over the rounds' stacked index maps
(``fedml_tpu/sim/engine.py:1268-1365``): one dispatch per block instead of
one per round, which amortises the host's cost of dispatch where a round is
many small kernels. Eager PyTorch launches every kernel from the host; its
counterpart of the block program is a CUDA graph. :class:`RoundGraph`
captures a whole round of a :class:`~fedml_tpu_torch.sim.engine.FedSim`
(:meth:`FedSim.round_step`: the gather, every local step of every client,
the aggregation and the round's metrics) once, and a block replays it once
a round:

- the round's inputs live in static buffers: its index map, weights, step
  budgets and augmentation draws, copied in from the staged block before
  each replay, and its dropout masks, drawn before each replay by the
  round's :class:`~fedml_tpu_torch.core.trainer.DropoutStream` (a draw
  reseeds a generator, which a capture cannot hold), so they are bitwise the
  eager round's; so are the server rule's random draws (weak-DP noise, a
  quantizing codec's uniforms, :class:`StaticNoise`), drawn before each
  replay by the round's :class:`~fedml_tpu_torch.core.rng.RoundNoise`. A
  round's host work is these copies and one graph launch, however many
  kernels a step has;
- the global variables and the server state live in static buffers too: the
  graph reads them and writes the round's aggregate back into them, so
  consecutive replays carry the model on the device. Every leaf of a server
  state is a tensor (FedOpt's step count too), so nothing the round moves is
  frozen into the graph; nothing in a captured round reads the device from
  the host (a robust rule's statistics and Krum's choice stay on it);
- each replay's metrics are copied into the block's ``[R]`` stacks.

Capture: one warm-up round first runs on a side stream on scratch copies of
the variables (lazy initialisations, such as cuBLAS handles, the autograd
device thread and the kernels' build, then happen outside the capture, as
the ``torch.cuda.graphs`` documentation requires) and changes no variable;
then the round is captured into the graph's own memory pool, which the graph
holds for its life. A failed capture or replay raises: nothing falls back to
eager rounds.

The prefetch thread (``sim/prefetch.py``) pins host memory and copies to the
device, which a capture in the global mode refuses from any thread, so
:meth:`FedSim.run` captures before it starts the thread. The copies the
thread issues later go on the device's default stream, on which the block's
input copies and replays are issued after them, so a staged block has landed
before the replay that reads it.

The flash kernel's launches made while a graph is captured are tallied
(``ops/attention.py``, :func:`~fedml_tpu_torch.ops.attention.captured_launches`)
and each replay adds the tally to the launch counters, which so count
launches on the device.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from fedml_tpu_torch.core.trainer import LaneDropout, site_dtype
from fedml_tpu_torch.ops import attention


class StaticDropout:
    """A round's dropout keep masks (and the GAN's latent draws) in static
    ``[E * S, C, B, ...]`` buffers, served by :meth:`masks` as
    :class:`DropoutStream` serves them and filled from the round's stream
    before each replay."""

    def __init__(self, sites: dict, steps: int, cohort: int, batch: int,
                 device: torch.device):
        self.buffers = {name: torch.empty((steps, cohort, batch) + tuple(shape),
                                          dtype=site_dtype(rate), device=device)
                        for name, (shape, rate) in sites.items()}
        self.steps = steps

    def masks(self, step: int) -> dict[str, torch.Tensor]:
        return {k: b[step] for k, b in self.buffers.items()}

    def fill(self, stream) -> None:
        for t in range(self.steps):
            for k, m in stream.masks(t).items():
                self.buffers[k][t].copy_(m)


class StaticNoise:
    """A captured round's random draws in static buffers, served in call
    order by :meth:`normal` and :meth:`uniform` as
    :class:`~fedml_tpu_torch.core.rng.RoundNoise` serves them, and filled
    from the round's ``RoundNoise`` before each replay: each buffer
    remembers the kind of draw it holds, and :meth:`fill` redraws each of
    its kind, so a replayed round has fresh gaussians and uniforms. The
    buffers are made at the warm-up round's calls, outside the capture;
    :meth:`rewind` starts a round's calls over."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buffers: list[tuple[str, torch.Tensor]] = []
        self._k = 0

    def rewind(self) -> None:
        self._k = 0

    def _serve(self, kind: str, shape, dtype: torch.dtype) -> torch.Tensor:
        k, self._k = self._k, self._k + 1
        if k == len(self.buffers):
            if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("StaticNoise: a draw the warm-up round did not make")
            self.buffers.append((kind, torch.zeros(tuple(shape), dtype=dtype,
                                                   device=self.device)))
        held, buf = self.buffers[k]
        if held != kind or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            raise RuntimeError(f"StaticNoise: draw {k} is {kind} {tuple(shape)} {dtype}, the "
                               f"warm-up's {held} {tuple(buf.shape)} {buf.dtype}")
        return buf

    def normal(self, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self._serve("normal", shape, dtype)

    def uniform(self, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self._serve("uniform", shape, dtype)

    def fill(self, noise) -> None:
        for kind, buf in self.buffers:
            buf.copy_(getattr(noise, kind)(buf.shape, buf.dtype))


class RoundGraph:
    """One round of ``sim`` captured as a CUDA graph, on the inputs' shapes
    of ``staged`` (a round of a block; its values feed the warm-up), with
    ``variables`` and ``server_state`` as the warm-up's model."""

    def __init__(self, sim, staged, variables, server_state):
        device = sim.device
        # no host budgets: the scan mode masks its steps on the device
        self.inputs = type(staged)(
            staged.round_idx, staged.cohort, staged.idx.clone(), None, staged.weights.clone(),
            staged.num_steps.clone(), None,
            None if staged.draws is None else {k: d.clone() for k, d in staged.draws.items()})
        sites = sim.trainer.dropout_sites
        self.dropout = (StaticDropout(sites, sim.trainer.epochs * sim._steps,
                                      len(staged.cohort), sim.config.batch_size, device)
                        if sites else None)
        if self.dropout is not None:
            self.dropout.fill(sim._dropout(staged.round_idx, len(staged.cohort)))
        self.variables = {k: v.detach().clone() for k, v in variables.items()}
        leaves, self._state_spec = pytree.tree_flatten(server_state)
        self.state = [t.detach().clone() for t in leaves]
        self.noise = StaticNoise(device)

        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            # one warm-up round on scratch copies (see the module docstring);
            # it makes the noise buffers
            sim.round_step(self.inputs, {k: v.clone() for k, v in self.variables.items()},
                           self._server_state(clone=True), self.dropout, self.noise)
        current.wait_stream(side)
        torch.cuda.synchronize(device)
        self.noise.fill(sim._round_noise(staged.round_idx))

        self.graph = torch.cuda.CUDAGraph()
        before = attention.captured_launches()
        self.noise.rewind()
        with torch.cuda.graph(self.graph):
            new_variables, new_state, self.metrics = sim.round_step(
                self.inputs, self.variables, self._server_state(), self.dropout, self.noise)
            for k, t in new_variables.items():
                self.variables[k].copy_(t)
            for old, t in zip(self.state, pytree.tree_flatten(new_state)[0]):
                old.copy_(t)
        after = attention.captured_launches()
        # the flash kernel's launches that each replay makes
        self.launches = {k: after[k] - before[k] for k in after}

    def _server_state(self, clone: bool = False):
        return pytree.tree_unflatten([t.clone() if clone else t for t in self.state],
                                     self._state_spec)

    def replay_round(self, sim, block, j: int) -> dict[str, torch.Tensor]:
        """Round ``j`` of ``block`` (a :class:`BlockStaged`): its inputs
        copied into the static buffers, its dropout masks drawn into them,
        one replay. Returns the graph's metric buffers, which the next
        replay overwrites."""
        staged = block.round(j)
        self.inputs.idx.copy_(staged.idx)
        self.inputs.weights.copy_(staged.weights)
        self.inputs.num_steps.copy_(staged.num_steps)
        for k, d in (staged.draws or {}).items():
            self.inputs.draws[k].copy_(d)
        if self.dropout is not None:
            self.dropout.fill(sim._dropout(staged.round_idx, len(staged.cohort)))
        self.noise.fill(sim._round_noise(staged.round_idx))
        self.graph.replay()
        attention.count_replay(self.launches)
        return self.metrics

    def run_block(self, sim, block, variables, server_state):
        """The rounds of ``block`` from ``variables`` and ``server_state``:
        ``(variables, server_state, metrics)``, the metrics stacked
        ``[n_rounds]``, the model and state fresh copies of the carried
        buffers."""
        for k, t in variables.items():
            self.variables[k].copy_(t)
        for old, t in zip(self.state, pytree.tree_flatten(server_state)[0]):
            old.copy_(t)
        stacked = {k: torch.empty((block.n_rounds,) + v.shape, dtype=v.dtype, device=v.device)
                   for k, v in self.metrics.items()}
        for j in range(block.n_rounds):
            for k, v in self.replay_round(sim, block, j).items():
                stacked[k][j].copy_(v)
        return ({k: v.clone() for k, v in self.variables.items()},
                self._server_state(clone=True), stacked)


class PassGraph:
    """One lane pass of a packed round of ``sim``
    (:meth:`FedSim.lane_pass`) captured as a CUDA graph on the shapes of
    ``staged``'s first pass, with ``variables`` as the warm-up's model: the
    port's counterpart of the JAX engine's one compiled program per pass
    (``fedml_tpu/sim/engine.py:1829-1856``). Each pass of a round, overflow
    passes included, is one replay.

    The pass's inputs live in static buffers: its lane data (index map or
    lane batch stacks), ``slot``, ``gidx`` and ``boundary``, the round's
    augmentation draws and the global model, copied in before the replay,
    and its dropout masks, drawn into a
    :class:`~fedml_tpu_torch.core.trainer.LaneDropout` from the round's
    stream. The round's output buffers (update stack, written flags, loss
    and weight buffers) are static too: zeroed before the round's first
    pass, each replay writes its clients' rows, and the aggregation reads
    them after the last, outside the graph. Warm-up and capture as
    :class:`RoundGraph`'s."""

    def __init__(self, sim, staged, variables):
        device = sim.device
        lp = staged.passes[0]
        L = lp.slot.shape[0]

        def clone(tree):
            return None if tree is None else {k: v.clone() for k, v in tree.items()}

        data = clone(lp.data) if isinstance(lp.data, dict) else lp.data.clone()
        self.inputs = type(lp)(data, lp.slot.clone(), lp.gidx.clone(), lp.boundary.clone(),
                               None)
        self.draws = clone(staged.draws)
        sites = sim.trainer.dropout_sites
        self.dropout = (LaneDropout(sites, lp.slot.shape[1], L, sim.config.batch_size, device)
                        if sites else None)
        stream = sim._dropout(staged.round_idx, len(staged.cohort))
        if self.dropout is not None:
            self.dropout.fill(stream, lp.dropout)
        self.variables = {k: v.detach().clone() for k, v in variables.items()}
        self.bufs = sim._packed_buffers(self.variables, L)

        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            # one warm-up pass on scratch buffers (see RoundGraph)
            sim.lane_pass(self.inputs, clone(self.variables),
                          sim._packed_buffers(self.variables, L), self.draws, self.dropout)
        current.wait_stream(side)
        torch.cuda.synchronize(device)

        self.graph = torch.cuda.CUDAGraph()
        before = attention.captured_launches()
        with torch.cuda.graph(self.graph):
            sim.lane_pass(self.inputs, self.variables, self.bufs, self.draws, self.dropout)
        after = attention.captured_launches()
        self.launches = {k: after[k] - before[k] for k in after}

    def replay_pass(self, lp, stream) -> None:
        """One pass ``lp`` (a :class:`LanePass`): its inputs copied into the
        static buffers, its dropout masks drawn from ``stream`` into them,
        one replay."""
        if isinstance(lp.data, dict):
            for k, v in lp.data.items():
                self.inputs.data[k].copy_(v)
        else:
            self.inputs.data.copy_(lp.data)
        for name in ("slot", "gidx", "boundary"):
            getattr(self.inputs, name).copy_(getattr(lp, name))
        if self.dropout is not None:
            self.dropout.fill(stream, lp.dropout)
        self.graph.replay()
        attention.count_replay(self.launches)

    def run_round(self, staged, variables, stream):
        """The passes of ``staged`` (a :class:`PackedStaged`) from the global
        model ``variables``, one replay each, with ``stream`` the round's
        dropout stream; returns the round's output buffers, which the next
        round's :meth:`run_round` zeroes."""
        for k, t in variables.items():
            self.variables[k].copy_(t)
        for k, d in (staged.draws or {}).items():
            self.draws[k].copy_(d)
        stack, written, lbuf, wbuf = self.bufs
        for t in (*stack.values(), written, lbuf, wbuf):
            t.zero_()
        for lp in staged.passes:
            self.replay_pass(lp, stream)
        return self.bufs
