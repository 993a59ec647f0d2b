"""Parameter files and round checkpoints, the port of
``fedml_tpu/obs/checkpoint.py``.

- :func:`save_params` / :func:`load_params` / :func:`graft_params`: one model's
  variables as a portable ``.npz`` in **the JAX package's layout**: flax key
  paths joined with ``/`` (``params/Dense_0/kernel``) and flax leaf shapes,
  made by ``convert.to_flax`` and read back by ``convert.from_flax``. A file
  the JAX package saved warm-starts the port (``--init_from``), and the
  port's file loads into the JAX package; a file that holds part of a model
  (a backbone without its head, the parameters without the BatchNorm
  statistics) grafts over a fresh model.
- :class:`RoundCheckpointer`: the round's ``(variables, server_state,
  round, history)`` saved every N rounds under ``<dir>/round_<k>/``, so a
  run resumes exactly. It uses the JAX module's ``.npz`` layout (the leaves
  as ``arr_0, arr_1, ...`` in the order of a flatten that visits dict keys
  sorted) plus ``meta.json`` with the round and the history; the server
  state may have any structure of dicts, tuples and tensors (FedOpt's named
  optimizer states) and round-trips bitwise. The last ``keep`` rounds are
  kept. Its server half (``save_server`` / ``restore_server``) stores a
  nested dict of numpy arrays and JSON values, the ``.json`` written last as
  the commit marker. Where orbax is installed, the JAX package writes its
  rounds through orbax (``round_<k>/state/``) instead: the port's
  ``restore`` refuses such a round with a ``ValueError``, as only params
  files cross between the packages.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch import convert

StateDict = dict[str, torch.Tensor]


def save_params(path: str | Path, variables: StateDict) -> Path:
    """Save a model's variables (the port's state dict) as a single ``.npz``
    in the JAX package's layout, keyed by ``/``-joined flax key paths; a
    path without the ``.npz`` suffix gains it (as ``np.savez`` would).
    Returns the path written."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    if not variables:
        raise ValueError("save_params: empty variables")
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", convert.to_flax(variables))
    np.savez(path, **flat)
    return path


def _read_nested(path: str | Path) -> dict:
    """A ``save_params`` file (either package's) as flax's nested dict."""
    with np.load(Path(path)) as blob:
        out: dict = {}
        for key in blob.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = blob[key]
    return out


def load_params(path: str | Path, like: StateDict | None = None) -> StateDict:
    """Load a :func:`save_params` file (the JAX package's or the port's) as
    the port's state dict: CPU tensors, only the leaves the file holds.
    With ``like`` (the model's state dict), every loaded leaf must exist in
    the model with the same shape, and the result is ``like`` with the
    loaded leaves grafted in (:func:`graft_params`)."""
    loaded = convert.from_flax(_read_nested(path),
                               resnet=None if like is None else convert.is_resnet(like))
    return loaded if like is None else graft_params(like, loaded)


def graft_params(template: StateDict, loaded: StateDict) -> StateDict:
    """``template`` with ``loaded``'s leaves grafted over it, each cast to
    the template leaf's dtype and device: a name the template lacks, or a
    shape that differs, raises; a template leaf ``loaded`` lacks keeps its
    value (a backbone-only file keeps the fresh head)."""
    unknown = sorted(set(loaded) - set(template))
    if unknown:
        raise ValueError(f"load_params: {unknown} not present in the model "
                         f"(has {sorted(template)})")
    out = {}
    for k, t in template.items():
        if k not in loaded:
            out[k] = t
            continue
        v = torch.as_tensor(loaded[k])
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"load_params: {k} shape {tuple(v.shape)} does not match "
                             f"model {tuple(t.shape)}")
        out[k] = v.to(device=t.device, dtype=t.dtype)
    return out


# -- round checkpoints --------------------------------------------------------


def _flatten(tree) -> list:
    """The leaves of a tree of dicts (keys visited sorted, as JAX flattens
    them), tuples and lists (in order) and tensors."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in _flatten(node)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure (its dicts in their own key order) with the leaves
    of :func:`_flatten`'s order, each a tensor of the template leaf's dtype
    on its device."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            parts = [build(n) for n in node]
            if hasattr(node, "_fields"):  # a NamedTuple
                return type(node)(*parts)
            return type(node)(parts)
        arr = next(it)
        t = torch.as_tensor(node)
        return torch.from_numpy(np.asarray(arr)).to(device=t.device, dtype=t.dtype)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("checkpoint holds more leaves than the template")
    return out


def _np(t) -> np.ndarray:
    return torch.as_tensor(t).detach().cpu().numpy()


def _has_leaves(tree) -> bool:
    return tree is not None and bool(_flatten(tree))


class RoundCheckpointer:
    """Round checkpoints under ``ckpt_dir``: ``round_<k>/state.npz`` (the
    leaves of ``{"server_state": ..., "variables": ...}``) and
    ``round_<k>/meta.json`` (round and history), the last ``keep`` rounds
    kept."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, round_idx: int, variables: StateDict, server_state: Any = None,
             history: list | None = None) -> Path:
        path = self.dir / f"round_{round_idx:06d}"
        path.mkdir(parents=True, exist_ok=True)
        payload = {"variables": variables}
        if _has_leaves(server_state):
            payload["server_state"] = server_state
        np.savez(path / "state.npz", *[_np(leaf) for leaf in _flatten(payload)])
        with open(path / "meta.json", "w") as fh:
            json.dump({"round": round_idx, "history": history or []}, fh)
        self._gc()
        return path

    def latest_round(self) -> int | None:
        rounds = sorted(int(p.name.split("_")[1]) for p in self.dir.glob("round_*")
                        if (p / "meta.json").exists())
        return rounds[-1] if rounds else None

    def restore(self, like_variables: StateDict, round_idx: int | None = None,
                like_server_state: Any = None):
        """``(variables, server_state, round_idx, history)`` of round
        ``round_idx`` (default: the latest), each tensor of its template
        leaf's dtype and device. A round the JAX package wrote through orbax
        (``round_k/state/``) raises ``ValueError``."""
        if round_idx is None:
            round_idx = self.latest_round()
        if round_idx is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"round_{round_idx:06d}"
        if not (path / "state.npz").exists() and (path / "state").is_dir():
            raise ValueError(
                f"{path} holds an orbax checkpoint (round_k/state/, written by the JAX "
                "package's RoundCheckpointer where orbax is installed), which "
                "fedml_tpu_torch cannot read without JAX: only params files "
                "(save_params/load_params) cross between the packages")
        template = {"variables": like_variables}
        if _has_leaves(like_server_state):
            template["server_state"] = like_server_state
        with np.load(path / "state.npz") as blob:
            leaves = [blob[f"arr_{i}"] for i in range(len(blob.files))]
        if len(leaves) != len(_flatten(template)):
            raise ValueError(f"{path}: {len(leaves)} leaves, the template has "
                             f"{len(_flatten(template))}")
        payload = _unflatten(template, leaves)
        with open(path / "meta.json") as fh:
            meta = json.load(fh)
        server_state = payload.get("server_state", like_server_state)
        return payload["variables"], server_state, meta["round"], meta.get("history", [])

    def _gc(self):
        rounds = sorted(self.dir.glob("round_*"), key=lambda p: p.name)
        for p in rounds[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)
            logging.debug("checkpoint gc: removed %s", p)

    # -- a server's round snapshots -------------------------------------------

    def _server_paths(self, round_idx: int) -> tuple[Path, Path]:
        stem = self.dir / f"server_round_{round_idx:06d}"
        return stem.with_suffix(".npz"), stem.with_suffix(".json")

    def save_server(self, round_idx: int, state: dict) -> Path:
        """Save a server round snapshot (atomic at the .json commit marker).
        ``state`` is a nested dict of np.ndarray leaves and JSON-safe
        values."""
        arrays: dict[str, np.ndarray] = {}

        def strip(node, prefix: str):
            if isinstance(node, dict):
                return {k: strip(v, f"{prefix}/{k}" if prefix else str(k))
                        for k, v in node.items()}
            if isinstance(node, np.ndarray):
                arrays[prefix] = node
                return {"__array__": prefix}
            return node

        meta = strip(state, "")
        npz_path, json_path = self._server_paths(round_idx)
        if arrays:
            np.savez(npz_path, **arrays)
        # the .json is the commit marker, so its own write is atomic: dump to
        # a temporary file and rename it into place
        tmp = json_path.with_suffix(".json.tmp")
        with open(tmp, "w") as fh:
            json.dump({"round": round_idx, "state": meta, "has_arrays": bool(arrays)}, fh)
        tmp.replace(json_path)
        self._gc_server()
        return json_path

    def latest_server_round(self) -> int | None:
        rounds = sorted(int(p.stem.split("_")[-1])
                        for p in self.dir.glob("server_round_*.json"))
        return rounds[-1] if rounds else None

    def restore_server(self, round_idx: int | None = None) -> dict:
        """A server snapshot (the latest committed round by default) as the
        nested dict :meth:`save_server` was given."""
        if round_idx is None:
            round_idx = self.latest_server_round()
        if round_idx is None:
            raise FileNotFoundError(f"no server checkpoints under {self.dir}")
        npz_path, json_path = self._server_paths(round_idx)
        with open(json_path) as fh:
            payload = json.load(fh)
        blob = np.load(npz_path) if payload.get("has_arrays") else None

        def graft(node):
            if isinstance(node, dict):
                if set(node) == {"__array__"}:
                    return blob[node["__array__"]]
                return {k: graft(v) for k, v in node.items()}
            return node

        return graft(payload["state"])

    def _gc_server(self):
        rounds = sorted(self.dir.glob("server_round_*.json"))
        for json_path in rounds[: -self.keep]:
            json_path.with_suffix(".npz").unlink(missing_ok=True)
            json_path.unlink(missing_ok=True)
            logging.debug("checkpoint gc: removed %s", json_path.stem)
