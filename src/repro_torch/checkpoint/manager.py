"""Checkpoints: atomic save, async save, template-free restore, retention
(counterpart of ``repro.checkpoint.manager``).

Layout (one directory per step), the reference's byte for byte:

    ckpt_dir/
      step_000000123.tmp/...   # staged writes
      step_000000123/          # atomic rename == commit
        MANIFEST.json          # step, leaf shapes and dtypes, key-paths
        arr_000000.npy ...     # one file per leaf, allow_pickle=False
      LATEST                   # text file with the newest committed step

Leaves are numbered in the order ``jax.tree_util`` flattens the tree
(dict keys sorted, depth first), which is what pairs each ``arr_%06d.npy``
with the manifest's ``paths``; so either package restores the other's
checkpoints.  The port writes ``"treedef": null``: the reference reads a
treedef only from a ``like=`` template, and its template-free restore
rebuilds the tree from ``paths``.

Guarantees: a checkpoint is visible only after the directory rename (a
crash mid-save leaves a ``.tmp`` directory that restore ignores and the
next manager removes); ``save_async`` copies tensors to host memory at
once and writes on a background thread; ``keep`` newest checkpoints
survive; ``restore`` places the tensors on the device the restoring job
names, whatever device saved them.

bfloat16 leaves are stored as numpy stores the reference's (ml_dtypes)
bfloat16 arrays: 2-byte void items (``|V2``) holding the bits, with the
dtype ``bfloat16`` in the manifest.  A bfloat16 tensor template restores
them bit for bit; numpy has no bfloat16, so without a device they come
back as those ``|V2`` arrays.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

__all__ = ["CheckpointManager"]


#: how numpy holds a bfloat16 array it has no dtype for (np.save of an
#: ml_dtypes bfloat16 array writes this)
BF16_BITS = np.dtype("V2")


def _is_dtensor(leaf) -> bool:
    if type(leaf) is torch.Tensor or not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):  # the whole array, gathered on every rank
            leaf = leaf.full_tensor()
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(BF16_BITS)
        return leaf.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_BITS else str(arr.dtype)


def _flatten(tree, path=()):
    """(leaves, key-paths) in ``jax.tree_util``'s order: dict keys sorted,
    lists and tuples in order, depth first.  A path holds None for a step
    that is not a string dict key."""
    if isinstance(tree, dict):
        out = ([], [])
        for key in sorted(tree):
            leaves, paths = _flatten(tree[key], path + (key,))
            out[0].extend(leaves)
            out[1].extend(paths)
        return out
    if isinstance(tree, (list, tuple)):
        out = ([], [])
        for sub in tree:
            leaves, paths = _flatten(sub, path + (None,))
            out[0].extend(leaves)
            out[1].extend(paths)
        return out
    return [tree], [path]


def _unflatten(like, leaves):
    """The structure of ``like`` with ``leaves`` (an iterator) in order."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _dict_key_paths(paths) -> list[list[str]] | None:
    """Leaf key-paths of a pure nested-dict tree with string keys, else
    None (the reference stores None for such trees too)."""
    if any(not p or any(not isinstance(k, str) for k in p) for p in paths):
        return None
    return [list(p) for p in paths]


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BF16_BITS
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _distribute(tree, placements, mesh):
    """``tree``'s tensors laid out on ``mesh`` by ``placements`` (same shape)."""
    if isinstance(tree, dict):
        return {k: _distribute(v, placements[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_distribute(v, pl, mesh) for v, pl in zip(tree, placements))
    if placements is None or not isinstance(tree, torch.Tensor):
        return tree
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.context import clean_spec
    from repro_torch.sharding.rules import placements as spec_placements

    return distribute_tensor(tree, mesh, spec_placements(
        clean_spec(placements, mesh.mesh_dim_names), mesh), src_data_rank=None)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._sharded_in_flight = False  # the last save_async held DTensors
        self._gc_stale_tmp()

    # ------------------------------------------------------------------ io

    def _gc_stale_tmp(self):
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(
                    os.path.join(self.directory, name), ignore_errors=True
                )

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def latest_step(self) -> int | None:
        latest = os.path.join(self.directory, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            s = f.read().strip()
        return int(s) if s else None

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    # ---------------------------------------------------------------- save

    def save(self, step: int, tree) -> None:
        """Synchronous save: copy to host, write, commit.

        A tree with DTensor leaves is saved whole: every rank gathers (a
        collective, so every rank calls ``save``), rank 0 writes, and the
        ranks meet at a barrier after the commit."""
        leaves, paths = _flatten(tree)
        sharded = any(_is_dtensor(x) for x in leaves)
        host = [_to_host(x) for x in leaves]
        if not sharded or _rank() == 0:
            self._write(step, host, paths)
        if sharded:
            _barrier()

    def save_async(self, step: int, tree) -> None:
        """Copy to host now; write on a background thread (with DTensor
        leaves: every rank gathers, rank 0 writes, and every rank's next
        ``wait`` meets the others once the commit is done)."""
        self.wait()  # one save in flight at a time
        leaves, paths = _flatten(tree)
        sharded = any(_is_dtensor(x) for x in leaves)
        host = [_to_host(x) for x in leaves]
        self._sharded_in_flight = sharded
        if sharded and _rank() != 0:
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, host, paths), daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        """Until the last ``save_async`` has committed.  After a save of
        DTensor leaves every rank calls it: the ranks meet at a barrier
        once rank 0's writer is done, so none reads ``LATEST`` (or a step
        that rank 0's retention is pruning) before the commit."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded_in_flight:
            self._sharded_in_flight = False
            _barrier()

    def _write(self, step: int, leaves: list, paths: list) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "treedef": None,
            "n_leaves": len(leaves),
            "leaves": [
                {"shape": list(leaf.shape), "dtype": _dtype_name(leaf)}
                for leaf in leaves
            ],
            # Key-paths for nested-dict trees (None otherwise): restore
            # rebuilds the tree from them without a template.
            "paths": _dict_key_paths(paths),
        }
        for i, leaf in enumerate(leaves):
            np.save(os.path.join(tmp, f"arr_{i:06d}.npy"), leaf,
                    allow_pickle=False)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # atomic commit
        latest_tmp = os.path.join(self.directory, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(self.directory, "LATEST"))
        self._gc(step)

    def _gc(self, newest_step: int) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            if s != newest_step:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------- restore

    def restore(self, step: int | None, like=None, device=None, mesh=None, placements=None):
        """Load a checkpoint (the latest with ``step=None``): ``(tree,
        step)``.

        ``like=None`` rebuilds the tree from the manifest's key-paths
        (nested-dict checkpoints only): the caller learns shapes and dtypes
        from the checkpoint, which is how an elastic job snapshot is
        reloaded.  With a ``like`` template (any nest of dicts, lists and
        tuples) every leaf must match its template leaf's shape and dtype
        exactly: a silent int32 / float32 or bool / int8 cast would break
        bit-exact resume, so it raises instead.

        Leaves come back as numpy arrays; with ``device`` every numeric
        leaf becomes a tensor on that device (string leaves stay numpy).

        With ``mesh`` and ``placements`` (a tree shaped as the restored one,
        each leaf a spec of ``sharding.rules``, or None to keep a plain
        tensor) the leaves are laid out on the current mesh: each rank reads
        the whole array and keeps its shard, whatever mesh saved it (the
        reference's ``shardings=``).
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        if like is None:
            tree = self._restore_from_paths(d, manifest)
        else:
            like_leaves, _ = _flatten(like)
            if manifest["n_leaves"] != len(like_leaves):
                raise ValueError(
                    f"checkpoint has {manifest['n_leaves']} leaves, target "
                    f"structure has {len(like_leaves)} — structure mismatch"
                )
            arrays = []
            for i, ref in enumerate(like_leaves):
                arr = np.load(os.path.join(d, f"arr_{i:06d}.npy"))
                want_shape = tuple(ref.shape) if hasattr(ref, "shape") \
                    else np.shape(ref)
                if tuple(arr.shape) != tuple(want_shape):
                    raise ValueError(
                        f"leaf {i}: checkpoint shape {arr.shape} != expected "
                        f"{tuple(want_shape)}"
                    )
                want_dtype = _np_dtype(ref)
                if arr.dtype != want_dtype:
                    raise ValueError(
                        f"leaf {i}: checkpoint dtype {arr.dtype} != expected "
                        f"{want_dtype} — refusing a silent cast"
                    )
                arrays.append(arr)
            tree = _unflatten(like, iter(arrays))
        if device is not None:
            tree = self._place(tree, torch.device(device))
        if mesh is not None:
            tree = _distribute(tree, placements, mesh)
        return tree, step

    @classmethod
    def _place(cls, tree, device):
        if isinstance(tree, dict):
            return {k: cls._place(v, device) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cls._place(v, device) for v in tree)
        if tree.dtype.kind in "US":
            return tree
        if tree.dtype == BF16_BITS:
            return torch.from_numpy(tree.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(tree).to(device)

    def _restore_from_paths(self, d: str, manifest: dict):
        """Template-free restore: rebuild a nested-dict tree from the
        manifest's key-paths."""
        paths = manifest.get("paths")
        if paths is None:
            raise ValueError(
                "checkpoint was not saved as a nested-dict tree (or "
                "predates path manifests); pass like= to restore it"
            )
        if len(paths) != manifest["n_leaves"]:
            raise ValueError("manifest paths/leaves count mismatch")
        tree: dict = {}
        for i, keys in enumerate(paths):
            arr = np.load(os.path.join(d, f"arr_{i:06d}.npy"))
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = arr
        return tree
