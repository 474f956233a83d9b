"""State that crosses between the reference package and the port.

What crosses is configuration, data, fitted models, LM weights and
elastic job snapshots.

* :func:`job_config_from_reference` — a reference ``JobConfig`` (as
  ``dataclasses.asdict``) becomes the port's, with the reduce backend
  renamed through :data:`REFERENCE_BACKEND_NAMES`;
* :func:`regression_model_from_reference` — a reference
  ``RegressionModel.to_dict()`` becomes a port model that predicts the
  same values;
* :meth:`ModelDatabase.load` reads a JSON file written by the reference
  (the format is shared);
* :func:`lm_params_from_reference` — the reference LM's ``init_params``
  pytree, as numpy arrays, becomes the state dict of the port's
  ``models.transformer.Transformer``;
* :func:`snapshot_from_reference` / :func:`snapshot_to_reference` — an
  elastic snapshot tree (``CheckpointManager.restore(step)`` of either
  package) with its cursor's reduce backend renamed, so a job preempted in
  one package resumes in the other.  The arrays cross unchanged.

Corpora cross through their seed: ``mapreduce.datagen`` draws the same
RNG sequence as the reference.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core.predictor import ModelDatabase
from repro_torch.core.regression import RegressionModel
from repro_torch.mapreduce.engine import JobConfig

__all__ = [
    "REFERENCE_BACKEND_NAMES",
    "ModelDatabase",
    "job_config_from_reference",
    "lm_params_from_reference",
    "regression_model_from_reference",
    "snapshot_from_reference",
    "snapshot_to_reference",
]

#: reference reduce backend name -> the port's backend of the same role
REFERENCE_BACKEND_NAMES = {
    "jnp": "torch",
    "xla": "scatter_reduce",
    "pallas": "cuda",
}


def job_config_from_reference(d: dict) -> JobConfig:
    """The port's ``JobConfig`` for ``dataclasses.asdict`` of a reference one."""
    fields = dict(d)
    name = fields.get("reduce_backend", "jnp")
    if name not in REFERENCE_BACKEND_NAMES:
        raise ValueError(
            f"unknown reference reduce backend {name!r}; "
            f"known: {sorted(REFERENCE_BACKEND_NAMES)}"
        )
    fields["reduce_backend"] = REFERENCE_BACKEND_NAMES[name]
    return JobConfig(**fields)


def regression_model_from_reference(d: dict) -> RegressionModel:
    """A port model from a reference ``RegressionModel.to_dict()``."""
    return RegressionModel.from_dict(d)


def lm_params_from_reference(tree: dict) -> dict:
    """State dict of the port's ``Transformer`` from a reference params pytree.

    The reference stacks each in-period position's parameters over repeats
    (``blocks/pos{p}/...`` with leading axis ``n_rep``), so layer
    ``i = rep * P + p``.  Leaves may be numpy or anything ``np.asarray``
    takes; dtypes are kept (bfloat16 through float32).
    """

    def tensor(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))  # a writable copy

    state = {"embed": tensor(tree["embed"]), "final_norm": tensor(tree["final_norm"]["w"])}
    if "lm_head" in tree:
        state["lm_head"] = tensor(tree["lm_head"])
    P = len(tree["blocks"])
    for p in range(P):
        blk = tree["blocks"][f"pos{p}"]
        n_rep = np.asarray(blk["norm1"]["w"]).shape[0]
        leaves = {"norm1": blk["norm1"]["w"], "norm2": blk["norm2"]["w"]}
        if "rwkv" in blk:  # the channel-mix weights are among the rwkv leaves
            leaves.update({f"rwkv.{k}": w for k, w in blk["rwkv"].items()})
        else:
            leaves.update({f"attn.{k}": blk["attn"][k] for k in ("wq", "wk", "wv", "wo")})
            for k in ("q_norm", "k_norm"):
                if k in blk["attn"]:
                    leaves[f"attn.{k}"] = blk["attn"][k]["w"]
            leaves.update({f"ffn.{k}": w for k, w in blk["ffn"].items()})
        for name, stacked in leaves.items():
            stacked = np.asarray(stacked)
            for rep in range(n_rep):
                state[f"blocks.{rep * P + p}.{name}"] = tensor(stacked[rep])
    return state


def _rename_cursor_backend(tree: dict, names: dict) -> dict:
    cursor = json.loads(str(np.asarray(tree["cursor"])[()]))
    name = cursor["reduce_backend"]
    if name not in names:
        raise ValueError(
            f"unknown reduce backend {name!r} in snapshot cursor; "
            f"known: {sorted(names)}"
        )
    cursor["reduce_backend"] = names[name]
    return {"cursor": np.asarray(json.dumps(cursor, sort_keys=True)),
            "arrays": dict(tree["arrays"])}


def snapshot_from_reference(tree: dict) -> dict:
    """A reference snapshot tree, ready for the port's ``tree_to_state``."""
    return _rename_cursor_backend(tree, REFERENCE_BACKEND_NAMES)


def snapshot_to_reference(tree: dict) -> dict:
    """A port snapshot tree, ready for the reference's ``tree_to_state``."""
    return _rename_cursor_backend(
        tree, {v: k for k, v in REFERENCE_BACKEND_NAMES.items()}
    )
