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
  (the format is shared); :func:`model_database_from_reference` /
  :func:`model_database_to_reference` rename the backend in each model's
  category key (the ``@dN`` depth and ``+c`` combiner suffixes kept), so
  a database fitted by either package's scheduler warm-starts the other's;
* :func:`lm_params_from_reference` — the reference LM's ``init_params``
  pytree, as numpy arrays, becomes the state dict of the port's
  ``models.transformer.Transformer``; :func:`lm_params_to_reference` is
  its inverse;
* :func:`adamw_state_from_reference` / :func:`adamw_state_to_reference` —
  the AdamW state (``step`` and the ``m`` / ``v`` / ``master`` trees shaped
  like the params) both ways, so a train checkpoint (params, AdamW state)
  written by either package's ``CheckpointManager`` resumes in the other;
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

from repro_torch.core.predictor import _SEP, ModelDatabase
from repro_torch.core.regression import RegressionModel
from repro_torch.mapreduce.engine import JobConfig

__all__ = [
    "REFERENCE_BACKEND_NAMES",
    "ModelDatabase",
    "adamw_state_from_reference",
    "adamw_state_to_reference",
    "job_config_from_reference",
    "lm_params_from_reference",
    "lm_params_to_reference",
    "model_database_from_reference",
    "model_database_to_reference",
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


#: numpy's view of a bfloat16 array it has no dtype for: what ``np.load``
#: returns for a reference checkpoint's (ml_dtypes) bfloat16 leaves
_BF16_BITS = np.dtype("V2")


def _tensor(x) -> torch.Tensor:
    """A reference leaf (numpy, ml_dtypes bfloat16, or bfloat16 bits as
    ``|V2``) as a tensor of the same dtype."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype == _BF16_BITS:
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a reference leaf; bfloat16 as its bits in ``|V2`` items,
    the bytes ``np.save`` writes for an ml_dtypes bfloat16 array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


#: the LM's parameters outside the blocks that some configurations lack
_TOP_LEVEL = ("embed", "lm_head", "in_proj")


def lm_params_from_reference(tree: dict) -> dict:
    """State dict of the port's ``Transformer`` from a reference params pytree.

    The reference stacks each in-period position's parameters over repeats
    (``blocks/pos{p}/...`` with leading axis ``n_rep``), so layer
    ``i = rep * P + p``: the norms, ``attn``, ``mamba`` or ``rwkv``, and
    ``ffn``, ``moe`` or both (arctic).  ``embed``, ``lm_head`` and
    ``in_proj`` cross where the tree has them (an audio encoder has no
    ``embed``; a VLM or an encoder has ``in_proj``).  Leaves may be numpy
    or anything ``np.asarray`` takes; dtypes are kept (bfloat16 through
    float32).
    """

    state = {"final_norm": _tensor(tree["final_norm"]["w"])}
    for name in _TOP_LEVEL:
        if name in tree:
            state[name] = _tensor(tree[name])
    P = len(tree["blocks"])
    for p in range(P):
        blk = tree["blocks"][f"pos{p}"]
        n_rep = np.asarray(blk["norm1"]["w"]).shape[0]
        leaves = {"norm1": blk["norm1"]["w"], "norm2": blk["norm2"]["w"]}
        if "attn" in blk:
            leaves.update({f"attn.{k}": blk["attn"][k] for k in ("wq", "wk", "wv", "wo")})
            for k in ("q_norm", "k_norm"):
                if k in blk["attn"]:
                    leaves[f"attn.{k}"] = blk["attn"][k]["w"]
        # rwkv holds the channel-mix weights too; arctic's ffn sits beside moe
        for sub in ("rwkv", "mamba", "moe", "ffn"):
            if sub in blk:
                leaves.update({f"{sub}.{k}": w for k, w in blk[sub].items()})
        for name, stacked in leaves.items():
            stacked = np.asarray(stacked)
            for rep in range(n_rep):
                state[f"blocks.{rep * P + p}.{name}"] = _tensor(stacked[rep])
    return state


def lm_params_to_reference(cfg, state: dict) -> dict:
    """The reference's params pytree (numpy) from the port's state dict
    (``model.state_dict()``, or any tree keyed the same, such as AdamW's
    ``m``): layer ``i = rep * P + p`` stacked under ``blocks/pos{p}``."""
    P = cfg.pattern_period
    n_rep = cfg.n_layers // P
    tree = {"final_norm": {"w": _array(state["final_norm"])}}
    for name in _TOP_LEVEL:
        if name in state:
            tree[name] = _array(state[name])
    blocks = {}
    for p in range(P):
        layers = [rep * P + p for rep in range(n_rep)]
        names = sorted({k.split(".", 2)[2] for k in state if k.startswith(f"blocks.{p}.")})
        blk: dict = {}
        for name in names:
            stacked = np.stack([_array(state[f"blocks.{i}.{name}"]) for i in layers])
            *parents, leaf = name.split(".")
            node = blk
            for key in parents:
                node = node.setdefault(key, {})
            if leaf in ("norm1", "norm2", "q_norm", "k_norm"):
                node[leaf] = {"w": stacked}
            else:
                node[leaf] = stacked
        blocks[f"pos{p}"] = blk
    tree["blocks"] = blocks
    return tree


def adamw_state_from_reference(tree: dict) -> dict:
    """The port's AdamW state (``repro_torch.optim.init_state``'s layout)
    from the reference's: ``step`` an int32 tensor; ``m``, ``v`` and
    ``master`` (when present) from params-shaped trees to dicts keyed as
    the model's parameters, dtypes kept."""
    state = {"step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32)}
    for key in ("m", "v", "master"):
        if key in tree:
            state[key] = lm_params_from_reference(tree[key])
    return state


def adamw_state_to_reference(cfg, state: dict) -> dict:
    """The reference's AdamW state (numpy) from the port's: the inverse of
    :func:`adamw_state_from_reference`."""
    tree = {"step": np.asarray(int(state["step"]), dtype=np.int32)}
    for key in ("m", "v", "master"):
        if key in state:
            tree[key] = lm_params_to_reference(cfg, state[key])
    return tree


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



def _rename_category(cat: str, names: dict) -> str:
    """``backend[@dN][+c]`` with the backend renamed, suffixes kept."""
    combined = cat.endswith("+c")
    base = cat[:-2] if combined else cat
    backend, at, depth = base.partition("@d")
    if backend not in names:
        raise ValueError(
            f"unknown reduce backend {backend!r} in model category "
            f"{cat!r}; known: {sorted(names)}"
        )
    return names[backend] + at + depth + ("+c" if combined else "")


def _rename_model_database(db_json: dict, names: dict) -> dict:
    out = {}
    for key, model in db_json.items():
        parts = key.split(_SEP)
        if len(parts) >= 3 and parts[2]:
            parts[2] = _rename_category(parts[2], names)
        out[_SEP.join(parts)] = model
    return out


def model_database_from_reference(db_json: dict) -> dict:
    """A reference ``ModelDatabase`` file's JSON (``--save-models``) with
    each model's backend category renamed to the port's (``jnp@d2+c`` ->
    ``torch@d2+c``); write it out and ``ModelDatabase.load`` reads it."""
    return _rename_model_database(db_json, REFERENCE_BACKEND_NAMES)


def model_database_to_reference(db_json: dict) -> dict:
    """The inverse of :func:`model_database_from_reference`: a port
    database file's JSON with its categories renamed to the reference's."""
    return _rename_model_database(
        db_json, {v: k for k, v in REFERENCE_BACKEND_NAMES.items()}
    )
