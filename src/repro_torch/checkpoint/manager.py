"""Checkpointing: atomic, integrity-checked, async-capable (torch port of
``repro.checkpoint.manager``).

  * **atomicity**: a save writes ``step_XXXXXXXX.tmp`` and renames it only
    after the manifest (with each file's sha256) is fsynced, so a crash
    mid-save never damages the latest checkpoint;
  * **integrity**: ``restore`` checks every file's sha256 before handing its
    tensor out, and raises ``IOError`` on a mismatch;
  * **async**: ``save_async`` copies the tensors to the host (the only part
    that blocks) and writes in a background thread;
  * **retention**: the ``keep`` newest checkpoints stay.

The layout is the reference's, so either package restores the other's
checkpoints: one ``.npy`` file a leaf (named by its path in the tree), a
``manifest.json`` with each file's sha256, shape and dtype name, and a
``latest`` file.  numpy has no bfloat16 or fp8 dtype (the reference's come
from ``ml_dtypes``), so the port saves those tensors as their unsigned bits
under the manifest's dtype name and views them back on restore; the
reference's files hold such arrays as raw void bytes, which restore the
same way.  A state that is not a tree but can be rebuilt from one (a
``train.step.TrainState``: ``tree()`` and ``from_tree``) saves as its tree,
and restores through ``state_like.from_tree``.

Not ported yet: ``save_plans``/``restore_plans`` (with the plan cache's
persistence) and ``restore(shardings=)`` (with ``launch/mesh.py``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels

# torch dtypes without a numpy twin: saved as the unsigned bits of their width
_BITS_ONLY = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}
_UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_SIGNED = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _tree_paths(tree, prefix: str = ""):
    """``(name, leaf)`` pairs in ``tree_util.tree_flatten`` order, named as
    the reference names them: dict keys and sequence indices joined by
    ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _tree_paths(t, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _tree_of(state):
    """The tree a checkpoint holds for ``state``: its ``tree()`` when it can
    be rebuilt from one (``from_tree``), else ``state`` itself."""
    return state.tree() if hasattr(state, "from_tree") else state


def _host(leaf) -> tuple:
    """(numpy array to save, manifest dtype name) of a leaf."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().contiguous().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if name in _BITS_ONLY:
        size = t.element_size()
        return t.view(_SIGNED[size]).numpy().view(_UNSIGNED[size]), name
    return t.numpy(), name


def _restore(arr: np.ndarray, dtype_name: str, dev: torch.device) -> torch.Tensor:
    """The tensor of a saved array under its manifest dtype, on ``dev``."""
    if dtype_name in _BITS_ONLY:
        size = arr.dtype.itemsize
        bits = np.array(arr, order="C").view(_UNSIGNED[size])
        t = torch.from_numpy(bits.view({1: np.uint8, 2: np.int16, 4: np.int32}[size]))
        return t.view(_BITS_ONLY[dtype_name]).to(dev)
    if str(arr.dtype) != dtype_name:
        arr = arr.view(np.dtype(dtype_name))
    return torch.from_numpy(np.array(arr, order="C")).to(dev)


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state) -> str:
        """Write ``state`` (a tree of tensors and numpy arrays) as ``step``;
        returns the checkpoint's directory."""
        return self._write(step, [(n, *_host(leaf))
                                  for n, leaf in _tree_paths(_tree_of(state))])

    def save_async(self, step: int, state) -> None:
        """Copy ``state`` to the host now and write it in a background
        thread; :meth:`wait` joins it and raises its error, if any."""
        self.wait()  # one save in flight at a time
        host = [(n, *_host(leaf)) for n, leaf in _tree_paths(_tree_of(state))]

        def work():
            try:
                self._write(step, host)
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write(self, step: int, host) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "files": {}}
        for name, arr, dtype_name in host:
            fn = name.replace("/", "__") + ".npy"
            path = os.path.join(tmp, fn)
            np.save(path, arr)
            manifest["files"][name] = {"file": fn, "sha256": _sha256(path),
                                       "shape": list(arr.shape), "dtype": dtype_name}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "latest"), "w") as f:
            f.write(os.path.basename(final))
        self._gc()
        return final

    def _gc(self):
        ckpts = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in ckpts[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, d))

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip().split("_")[1])

    def available_steps(self) -> tuple:
        """Every restorable step on disk, newest first."""
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_") and not d.endswith(".tmp")]
        return tuple(sorted(steps, reverse=True))

    def restore(self, state_like, *, step: Optional[int] = None, device="cuda",
                verify: bool = True):
        """Load a checkpoint (the latest unless ``step``) into the structure
        of ``state_like``, every leaf a tensor on ``device`` (a state with
        ``from_tree`` is rebuilt from the restored tree).  Returns (state,
        step); a file whose sha256 differs from the manifest's raises
        ``IOError``."""
        from repro_torch.tree_util import tree_flatten, tree_unflatten

        dev = kernels.resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like = _tree_of(state_like)
        out = []
        for name, _ in _tree_paths(like):
            ent = manifest["files"][name]
            path = os.path.join(d, ent["file"])
            if verify and _sha256(path) != ent["sha256"]:
                raise IOError(f"checksum mismatch for {name} in {d}")
            out.append(_restore(np.load(path), ent["dtype"], dev))
        tree = tree_unflatten(tree_flatten(like)[1], out)
        return (tree if like is state_like else state_like.from_tree(tree)), step
