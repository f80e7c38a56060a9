"""Atomic checkpointing of the port: ``repro.distributed.checkpoint``
without JAX, in the reference's format, so that either package restores
what the other wrote.

Layout on disk (one directory per step):

    <root>/step_000000123.tmp/...   (written, fsynced)
    <root>/step_000000123/          (atomic rename marks the step durable)
        manifest.json               (treedef, leaf shapes/dtypes, step, checksum)
        leaf_00000.npy ...

The reference flattens its tree with ``jax.tree.flatten``: for the nested
dicts of parameters that is every leaf in sorted-key order, depth first,
which :func:`flatten` reproduces.  A leaf is a numpy array or a torch
tensor (written as numpy; bfloat16, which numpy lacks, as float32 — the
reference keeps its parameters in float32).  The manifest's ``treedef``
is this module's own description of the tree in the reference's notation;
the reference's ``restore`` reads only ``num_leaves`` and the leaves'
shapes.  Model parameters go through ``models.transformer.to_jax_layout``
(save) and ``from_jax_params`` (restore).

Durability protocol: write to a ``.tmp`` dir -> fsync every file + dir ->
rename.  A crash mid-write leaves only ``.tmp`` garbage, which is swept on
the next save; ``latest_step`` only ever sees complete checkpoints.  The
last ``keep`` steps are kept.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def flatten(tree) -> tuple[list, str]:
    """(leaves, treedef description) of a tree of nested dicts: the leaves
    in sorted-key order, depth first, as ``jax.tree.flatten`` orders a
    dict's; the description in its notation (``PyTreeDef({'a': *})``)."""
    leaves: list = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{key!r}: {walk(node[key])}" for key in sorted(node)) + "}"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(tree, leaves: list):
    """``tree``'s structure with its leaves replaced, in :func:`flatten`'s
    order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(tree)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def save(root: str, step: int, tree, keep: int = 3) -> str:
    """Atomically persist ``tree`` for ``step``.  Returns the final path."""
    os.makedirs(root, exist_ok=True)
    # sweep stale partial writes
    for d in os.listdir(root):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    leaves, treedef = flatten(tree)
    name = f"step_{step:09d}"
    tmp = os.path.join(root, name + ".tmp")
    final = os.path.join(root, name)
    os.makedirs(tmp, exist_ok=True)

    digest = hashlib.sha256()
    meta = []
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        fn = os.path.join(tmp, f"leaf_{i:05d}.npy")
        with open(fn, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        digest.update(arr.tobytes()[:4096])  # cheap spot-checksum
        meta.append({"shape": list(arr.shape), "dtype": str(arr.dtype)})

    manifest = {
        "step": step,
        "treedef": treedef,
        "num_leaves": len(leaves),
        "leaves": meta,
        "checksum": digest.hexdigest(),
        "format": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(root)

    # retention
    steps = sorted(all_steps(root))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)
    return final


def all_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(root, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = all_steps(root)
    return steps[-1] if steps else None


def restore(root: str, step: int | None, target_tree):
    """Restore into the structure of ``target_tree`` (nested dicts whose
    leaves have the checkpoint's shapes: arrays, or tensors — on the
    ``meta`` device for the shapes alone).  Returns (the tree with numpy
    leaves as saved, the step); the latest step when ``step`` is None."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, _ = flatten(target_tree)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, target has {len(leaves)}"
        )
    out = []
    for i, ref in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} != target {tuple(ref.shape)}")
        out.append(arr)
    return _unflatten(target_tree, out), step
