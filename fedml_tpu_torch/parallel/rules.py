"""Partition rules, the port of ``fedml_tpu/parallel/rules.py``: regex over
state-dict names -> a partition spec.

A *rule set* maps every tensor of a state dict (the model's variables, or
an optimizer's state) to a :class:`PartitionSpec` by regex-matching its
name, the fmengine ``match_partition_rules`` pattern of the JAX package:
scalars are always replicated, the first matching rule wins, and an
unmatched non-scalar tensor raises naming it. The JAX package matches
flax's ``/``-joined paths; the port matches its own state-dict names
(``blocks.0.attn.qkv.weight``), and its rules are written over the port's
names and layouts:

- a Dense ``weight`` is ``[out, in]``, the transpose of flax's ``[in, out]``
  kernel (``models/transformer.py``), so JAX's ``P(None, model)`` on a
  kernel is ``P(model, None)`` here, and ``P(model, None)`` is
  ``P(None, model)``;
- a conv ``weight`` is ``[out, in, kh, kw]`` (flax's HWIO), so JAX's
  output-channel split ``P(None, None, None, model)`` is ``P(model, None,
  None, None)``;
- the embedding tables (``tok_embed.weight``, ``pos_embed``) keep flax's
  layout.

The port's optimizer states key each tensor by its parameter's name (SGD's
momentum trace), or by ``mu/<name>`` and ``nu/<name>`` beside a scalar
``count`` (Adam), so the same rules, matched on name *suffixes*
(``re.search``), match the states as JAX's match ``0/trace/<path>``.

Built-in rule sets (:func:`rule_set`): ``transformer_tp`` is Megatron's
split of the TransformerLM (qkv and the MLP's first layer column-parallel,
proj and the MLP's second layer row-parallel, the embeddings over their
width, the head over the vocabulary), run by the model's own collectives
(``models/transformer.py`` ``mp_axis``); ``transformer_fsdp`` shards every
matrix and gathers it for compute, which keeps the round bitwise the
unsharded one; ``cnn_tp`` / ``cnn_fsdp`` (and their ``resnet_*`` names)
shard the conv zoo's output channels and output features, BatchNorm's
parameters and statistics replicated.

JAX's ``constrain`` (``with_sharding_constraint`` at block boundaries) has
no counterpart: the port's tensor parallelism is explicit, and the modules'
collectives (``parallel/collectives.py`` ``copy_to_axis``,
``reduce_from_axis``, ``gather_axis``) stand where GSPMD would insert them.

Rules are cohort-layout-agnostic, as in the JAX package: a spec names only
model axes, never the ``clients`` axis, so the same rule set serves the
padded cohort and the packed lanes.
"""

from __future__ import annotations

import dataclasses
import re

from fedml_tpu_torch.parallel.mesh import MODEL_AXIS


class PartitionSpec(tuple):
    """One axis name or None per leading dimension of a tensor (JAX's
    ``PartitionSpec``): ``PartitionSpec(None, "model")`` splits dimension 1
    over the ``model`` axis; ``PartitionSpec()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self) if len(self) != 1 else f'({self[0]!r})'}"


P = PartitionSpec


def match_partition_rules(rules, tree: dict) -> dict:
    """``{name: PartitionSpec}`` for a state dict ``tree`` (only each
    tensor's ``.shape`` is read).

    ``rules`` is a sequence of ``(regex, PartitionSpec)`` pairs tried in
    order against each name (``re.search``). Scalar tensors (rank 0, or a
    single element) are replicated without consulting the rules. A
    non-scalar tensor no rule matches raises ``ValueError`` naming it; end a
    rule list with ``(".*", P())`` to replicate the rest. A matched spec
    longer than the tensor's rank raises naming both."""

    def spec_for(name: str, leaf) -> PartitionSpec:
        shape = tuple(getattr(leaf, "shape", ()))
        n = 1
        for s in shape:
            n *= int(s)
        if len(shape) == 0 or n == 1:
            return P()  # scalars are never partitioned
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                if len(spec) > len(shape):
                    raise ValueError(
                        f"partition rule {rule!r} assigns spec {spec} "
                        f"(rank {len(spec)}) to param '{name}' of shape "
                        f"{shape} (rank {len(shape)})"
                    )
                return spec
        raise ValueError(
            f"no partition rule matched param '{name}' (shape {shape}); "
            "add a rule or end the rule list with ('.*', PartitionSpec()) "
            "to replicate unmatched leaves explicitly"
        )

    return {name: spec_for(name, leaf) for name, leaf in tree.items()}


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """A named partition plan: the regex rules plus how to compute with it.

    ``gather_compute=True`` is the FSDP-style contract: parameters are
    sharded over the model axis (in the JAX engine, the global model between
    rounds; the port's engine keeps it whole and cuts the blocks inside a
    round) but gathered for the training math itself, one all-gather per
    tensor at the round's entry, so every arithmetic op sees the tensors the unsharded
    round sees and the round stays bitwise. ``False`` is tensor
    parallelism: a module with an ``mp_axis`` (the TransformerLM) computes
    on its blocks with its own collectives, whose sums reassociate (~1 ULP).

    ``act_spec`` is JAX's block-boundary activation layout, which marks the
    sets whose modules take the model axis (``mp_axis``). ``groups`` is the
    port's own: ``(regex, n)`` pairs for tensors whose sharded dimension is
    ``n`` equal parts each split over the ranks (the TransformerLM's fused
    ``[q|k|v]`` projection, so that a rank holds whole heads of each; the
    full tensor it gathers back is the same)."""

    name: str
    rules: tuple
    gather_compute: bool = False
    act_spec: tuple | None = None
    groups: tuple = ()

    def groups_of(self, name: str) -> int:
        """The part count of ``name``'s sharded dimension (1: one part)."""
        for rule, n in self.groups:
            if re.search(rule, name) is not None:
                return n
        return 1


def _transformer_tp_rules():
    # Megatron split: column-parallel into the block, row-parallel out
    # (the port's [out, in] weights: JAX's kernel specs transposed)
    return (
        (r"qkv\.weight$", P(MODEL_AXIS, None)),
        (r"proj\.weight$", P(None, MODEL_AXIS)),
        (r"fc_0\.weight$", P(MODEL_AXIS, None)),
        (r"fc_0\.bias$", P(MODEL_AXIS)),
        (r"fc_1\.weight$", P(None, MODEL_AXIS)),
        (r"tok_embed\.weight$", P(None, MODEL_AXIS)),
        (r"pos_embed$", P(None, MODEL_AXIS)),
        (r"head\.weight$", P(MODEL_AXIS, None)),
        (r"head\.bias$", P(MODEL_AXIS)),
        (r".*", P()),  # norms, remaining biases: replicated
    )


def _transformer_fsdp_rules():
    # every matrix sharded on its output/embedding axis at rest; 1-D
    # params stay replicated (negligible storage, always divisible-safe)
    return (
        (r"(qkv|proj|fc_\d+|head)\.weight$", P(MODEL_AXIS, None)),
        (r"tok_embed\.weight$", P(None, MODEL_AXIS)),
        (r"pos_embed$", P(None, MODEL_AXIS)),
        (r".*", P()),
    )


def _cnn_rules():
    # conv weights [cout, cin, kh, kw]: shard output channels; dense
    # weights [out, in]: shard output features; BN params/stats replicated
    return (
        (r"conv_\d+\.weight$", P(MODEL_AXIS, None, None, None)),
        (r"(dense_\d+|fc|head|classifier)\.weight$", P(MODEL_AXIS, None)),
        (r".*", P()),
    )


RULE_SETS: dict[str, RuleSet] = {
    "transformer_tp": RuleSet(
        "transformer_tp", _transformer_tp_rules(), gather_compute=False,
        act_spec=(None, None, None), groups=((r"qkv\.weight$", 3),),
    ),
    "transformer_fsdp": RuleSet(
        "transformer_fsdp", _transformer_fsdp_rules(), gather_compute=True,
    ),
    "cnn_tp": RuleSet("cnn_tp", _cnn_rules(), gather_compute=False),
    "cnn_fsdp": RuleSet("cnn_fsdp", _cnn_rules(), gather_compute=True),
}
# the conv rules fit the ResNet/VGG zoo unchanged; keep the names the
# models are asked for by
RULE_SETS["resnet_tp"] = dataclasses.replace(
    RULE_SETS["cnn_tp"], name="resnet_tp")
RULE_SETS["resnet_fsdp"] = dataclasses.replace(
    RULE_SETS["cnn_fsdp"], name="resnet_fsdp")


def rule_set(name: str) -> RuleSet:
    """Look up a built-in rule set; unknown names raise listing the options."""
    try:
        return RULE_SETS[name]
    except KeyError:
        raise ValueError(
            f"unknown shard rule set {name!r}; built-ins: "
            f"{sorted(RULE_SETS)}"
        ) from None
