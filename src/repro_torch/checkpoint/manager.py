"""Atomic, resumable checkpointing (port of ``repro.checkpoint.manager``).

Layout per step:  <dir>/step_<n>/
    tree.msgpack      — array manifest (+ user metadata), MessagePack
    arrays.npz        — all array leaves, keyed by manifest index
    DONE              — commit marker (written last; readers require it)

Writes go to ``<path>.tmp`` and are committed with an atomic rename, so a
killed writer never leaves a half-readable checkpoint.  An optional
background thread makes saves async; ``wait()`` drains it.

The layout is the reference's, so checkpoints go both ways between the
packages.  A leaf is named by its path in the tree, as JAX's key paths
print it: dict keys sorted and written ``[{key!r}]``, list and tuple
entries ``[i]``, the parts joined by ``/`` (``['payload']/['eapca_box']``,
``['lst']/[1]/[0]``); ``None`` and empty containers hold no leaves.  The
manifest's keys are ``a{i}`` in that order.  Leaves are torch tensors or
numpy arrays (or anything ``np.asarray`` takes); a tensor goes to the host
with ``.detach().cpu().numpy()``.  ``tree.msgpack`` goes through the
port's own codec (:mod:`._msgpack`).
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from . import _msgpack


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(path part, child) pairs of a container in flattening order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{key!r}]", node[key]) for key in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", child) for i, child in enumerate(node)]
    return None


def flatten_with_paths(tree: Any) -> Tuple[List[str], List[Any]]:
    """(paths, leaves) of ``tree`` in JAX's flattening order."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            paths.append("/".join(prefix))
            leaves.append(node)
            return
        for part, child in kids:
            walk(child, prefix + [part])

    walk(tree, [])
    return paths, leaves


def map_leaves(fn: Callable[[str, Any], Any], tree: Any,
               prefix: Tuple[str, ...] = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)`` (the path as
    :func:`flatten_with_paths` names it); containers keep their type and
    dicts their key order."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn("/".join(prefix), tree)
    new = {part: map_leaves(fn, child, prefix + (part,))
           for part, child in kids}
    if isinstance(tree, dict):
        return type(tree)((key, new[f"[{key!r}]"]) for key in tree)
    return type(tree)(new[part] for part, _ in kids)


def _host(leaf: Any, copy: bool = False) -> np.ndarray:
    """A leaf as a host numpy array (``copy``: never sharing the leaf's
    memory, which ``.cpu()`` of a CPU tensor would)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return (leaf.to("cpu", copy=True) if copy else leaf.cpu()).numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def save_pytree(path: str, tree: Any, metadata: Optional[dict] = None
                ) -> None:
    """Atomic save of a tree of arrays (dicts, lists and tuples of tensors
    or numpy arrays) with a metadata dict."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    paths, leaves = flatten_with_paths(tree)
    arrays = {}
    manifest = []
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        arr = _host(leaf)
        arrays[f"a{i}"] = arr
        manifest.append({"path": p, "key": f"a{i}",
                         "dtype": str(arr.dtype), "shape": list(arr.shape)})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    blob = _msgpack.packb({"manifest": manifest,
                           "metadata": metadata or {}})
    with open(os.path.join(tmp, "tree.msgpack"), "wb") as f:
        f.write(blob)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _restore(arr: np.ndarray, leaf: Any):
    """A loaded array in ``leaf``'s dtype: a tensor on ``leaf``'s device
    for a tensor leaf, else a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def load_pytree(path: str, like: Any = None) -> Tuple[Any, dict]:
    """Load a saved tree.  With ``like``, restore into its structure and
    dtypes (its paths must be in the checkpoint; a tensor leaf comes back
    as a tensor on that leaf's device); otherwise return a flat
    {path: array} dict.  Also returns the metadata."""
    if not os.path.exists(os.path.join(path, "DONE")):
        raise FileNotFoundError(f"checkpoint at {path} is not committed")
    with open(os.path.join(path, "tree.msgpack"), "rb") as f:
        meta = _msgpack.unpackb(f.read())
    with np.load(os.path.join(path, "arrays.npz")) as z:
        by_path = {e["path"]: z[e["key"]] for e in meta["manifest"]}
    if like is None:
        return by_path, meta["metadata"]
    paths, leaves = flatten_with_paths(like)
    missing = [p for p in paths if p not in by_path]
    if missing:
        raise KeyError(f"checkpoint missing {len(missing)} leaves, "
                       f"e.g. {missing[:3]}")
    return (map_leaves(lambda p, leaf: _restore(by_path[p], leaf), like),
            meta["metadata"])


class CheckpointManager:
    """Step-indexed checkpoints with retention and optional async saves."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, "DONE")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             blocking: Optional[bool] = None) -> None:
        blocking = (not self.async_save) if blocking is None else blocking
        # copied to the host *before* the thread starts, so the caller may
        # change its tensors in place as soon as save returns
        host_tree = map_leaves(lambda _, x: _host(x, copy=True), tree)
        meta = dict(metadata or {})
        meta["step"] = step

        def work():
            save_pytree(self._step_dir(step), host_tree, meta)
            self._gc()

        self.wait()
        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[Any, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_pytree(self._step_dir(step), like)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
