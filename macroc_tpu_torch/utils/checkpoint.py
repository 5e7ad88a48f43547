"""Checkpoint/resume of (u, constitutive state) in the on-disk format of
``macroc_tpu/utils/checkpoint.py``, so a checkpoint moves both ways between
the two packages.

Format: a ``step_<N>/`` directory with one ``proc_<p>.npz`` per writing
process and a ``proc_<p>.json`` index of its blocks
(``{"blocks": [{"leaf", "key", "start", "shape"}]}``).  Leaves are in the
JAX flatten order of the tree: tuples and lists in order, dataclasses field
by field, dicts by sorted key, ``None`` and ``()`` empty.  For ``(u,
state)`` that is ``[u]`` for the elastic engine's ``()`` state, ``[u,
eps_p, alpha]`` for a J2State and ``[u, eps_p, alpha, micro_u]`` for a
MicroState.  One process writes one block per leaf as ``proc_0``; each
rank of an N-process run writes its block of each leaf, at its place in
the padded node box, as ``proc_<rank>``.  The reader assembles each leaf,
or a rank's block of it, from every block that covers it, so a checkpoint
moves between rank counts and between the packages (several JAX
processes write one block per shard), as does the legacy single-file
``step_<N>.npz`` (``leaf_<i>`` arrays).  ``ckpt_dir`` must be one
directory that every rank sees.

Publication is atomic: the files are written into ``step_<N>.writing/``
and renamed; an existing ``step_<N>`` is moved to ``step_<N>.old`` first
and dropped after, and ``load_latest`` takes a ``.old`` directory whose
published copy is missing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_DIR_RE = re.compile(r"step_(\d+)$")
_STEP_NPZ_RE = re.compile(r"step_(\d+)\.npz$")
_STEP_OLD_RE = re.compile(r"step_(\d+)\.old$")


def flatten(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in the JAX flatten order (module docstring)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in flatten(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in flatten(getattr(tree, f.name))]
    return [tree]


def unflatten(like: Any, leaves) -> Any:
    """``like`` with its leaves replaced, in order, from the iterator
    ``leaves``."""
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        return type(like)(unflatten(t, leaves) for t in like)
    if isinstance(like, dict):
        return {k: unflatten(like[k], leaves) for k in sorted(like)}
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)
        })
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, mesh=None) -> str:
    """Save ``tree`` as ``ckpt_dir/step_<step>/``: one block per leaf.
    With ``mesh`` (a rank of an N-process run) every rank writes its own
    ``proc_<rank>`` with its blocks at their global start and gathers
    nothing; rank 0 clears a stale staging dir before a barrier and
    publishes after one (``macroc_tpu/utils/checkpoint.py:77-132``).  Every
    rank calls it.  Returns the published directory."""
    comm = None if mesh is None else mesh.comm
    pid = 0 if comm is None else comm.rank
    final = os.path.join(ckpt_dir, f"step_{step}")
    staging = final + ".writing"
    # a crashed earlier save (maybe under another rank count) may have left
    # stale files in the staging dir
    if pid == 0 and os.path.isdir(staging):
        shutil.rmtree(staging)
    if comm is not None:
        comm.barrier()
    os.makedirs(staging, exist_ok=True)
    index: Dict[str, Any] = {"blocks": []}
    arrays: Dict[str, np.ndarray] = {}
    for i, leaf in enumerate(flatten(tree)):
        data = _host(leaf)
        start = [0] * data.ndim if mesh is None else list(mesh.start) + [0] * (data.ndim - 3)
        key = f"l{i}_b0"
        arrays[key] = data
        index["blocks"].append(dict(leaf=i, key=key, start=start, shape=list(data.shape)))
    npz_tmp = os.path.join(staging, f"proc_{pid}.npz.tmp")
    with open(npz_tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(npz_tmp, os.path.join(staging, f"proc_{pid}.npz"))
    with open(os.path.join(staging, f"proc_{pid}.json"), "w") as f:
        json.dump(index, f)
    if comm is not None:
        comm.barrier()
    if pid == 0:
        # overwrite without a destruction window: a crash at any point
        # leaves one complete copy on disk (step_<N> or step_<N>.old)
        old = final + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        if os.path.isdir(final):
            os.replace(final, old)
        os.replace(staging, final)
        if os.path.isdir(old):
            shutil.rmtree(old)
    if comm is not None:
        comm.barrier()
    return final


class _BlockReader:
    """Opens proc_<p>.npz files on demand and serves global-index slices
    of one leaf assembled from its saved blocks."""

    def __init__(self, ckpt_dir: str):
        self.dir = ckpt_dir
        self._files: Dict[str, Any] = {}
        # leaf id -> [(start, shape, file, key)]
        self.blocks: Dict[int, List[Tuple]] = {}
        for name in sorted(os.listdir(ckpt_dir)):
            if not (name.startswith("proc_") and name.endswith(".json")):
                continue
            with open(os.path.join(ckpt_dir, name)) as f:
                idx = json.load(f)
            npz = name[: -len(".json")] + ".npz"
            for b in idx["blocks"]:
                self.blocks.setdefault(b["leaf"], []).append(
                    (tuple(b["start"]), tuple(b["shape"]), npz, b["key"])
                )

    def _data(self, npz: str, key: str) -> np.ndarray:
        if npz not in self._files:
            self._files[npz] = np.load(os.path.join(self.dir, npz))
        return self._files[npz][key]

    def read(self, leaf: int, index: Tuple[slice, ...],
             shape: Tuple[int, ...], dtype) -> np.ndarray:
        """Global slice ``index`` of a leaf, from its blocks."""
        sls = tuple(sl.indices(n) for sl, n in zip(index, shape))
        starts = [s for s, _, _ in sls]
        sizes = [e - s for s, e, _ in sls]
        out = np.zeros(sizes, dtype=dtype)
        filled = 0
        for bstart, bshape, npz, key in self.blocks.get(leaf, []):
            # overlap of [bstart, bstart+bshape) with [starts, starts+sizes)
            lo = [max(bs, s) for bs, s in zip(bstart, starts)]
            hi = [
                min(bs + bn, s + n)
                for bs, bn, s, n in zip(bstart, bshape, starts, sizes)
            ]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            src = tuple(slice(l - bs, h - bs) for l, h, bs in zip(lo, hi, bstart))
            dst = tuple(slice(l - s, h - s) for l, h, s in zip(lo, hi, starts))
            out[dst] = self._data(npz, key)[src]
            filled += int(np.prod([h - l for l, h in zip(lo, hi)]))
        if filled != int(np.prod(sizes)):
            raise ValueError(
                f"checkpoint {self.dir}: leaf {leaf} slice {index} not fully "
                "covered by saved blocks (is every proc_<p>.npz of the "
                "writing processes present?)"
            )
        return out

    def close(self):
        for f in self._files.values():
            f.close()


def _like(like, full: np.ndarray):
    """``full`` (host numpy) in the type, dtype and device of ``like``."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(full, device=like.device).to(like.dtype)
    return full


def _np_dtype(like):
    if isinstance(like, torch.Tensor):
        return torch.empty((), dtype=like.dtype).numpy().dtype
    return np.asarray(like).dtype


def load(path: str, like: Any, mesh=None) -> Any:
    """Load a tree saved by :func:`save` or by the JAX package, with
    ``like`` giving the structure, shapes, dtypes and devices.  Takes the
    ``step_<N>/`` directory format and the legacy single-file npz.

    With ``mesh`` (a rank of an N-process run; every rank calls it) the
    leaves of ``like`` are the rank's blocks of the padded node box and
    each rank reads only its block's slice, from whichever files cover it:
    a checkpoint moves between rank counts.  A slice that no saved block
    covers (the padding of a box the writer did not pad) raises
    ValueError on every rank, as the JAX reader does; nothing is filled
    in."""
    leaves = flatten(like)
    new = []
    if os.path.isdir(path):
        reader = _BlockReader(path)
        error = None
        try:
            for i, leaf in enumerate(leaves):
                shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
                index = (slice(None),) * len(shape)
                if mesh is not None:
                    shape = tuple(mesh.node_shape) + shape[3:]
                    index = tuple(mesh.slices()) + index[3:]
                new.append(_like(leaf, reader.read(i, index, shape, _np_dtype(leaf))))
        except ValueError as e:
            if mesh is None:
                raise
            error = e
        finally:
            reader.close()
        if mesh is not None:
            # the ranks agree before any of them goes on to a collective
            failed = int(mesh.comm.sum(torch.tensor([int(error is not None)],
                                                    device=mesh.comm.device)))
            if failed:
                raise error or ValueError(
                    f"checkpoint {path}: another rank's block is not fully covered by "
                    "the saved blocks")
    else:
        with np.load(path) as data:
            for i, leaf in enumerate(leaves):
                full = np.asarray(data[f"leaf_{i}"])
                if mesh is not None:
                    full = mesh.local(full)
                new.append(_like(leaf, np.ascontiguousarray(full).astype(_np_dtype(leaf))))
    return unflatten(like, iter(new))


def load_latest(ckpt_dir: str, like: Any, mesh=None) -> Optional[Tuple[int, Any]]:
    """(step, tree) of the newest checkpoint in ``ckpt_dir``, or None.  A
    ``step_<N>.old`` directory counts when ``step_<N>`` is absent (a crash
    between the move-aside and the publish of an overwrite).  ``mesh``:
    as in :func:`load`."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands: Dict[int, Tuple[int, str]] = {}  # step -> (priority, path)
    for name in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, name)
        if _STEP_DIR_RE.match(name) and os.path.isdir(full):
            s, prio = int(_STEP_DIR_RE.match(name).group(1)), 1
        elif _STEP_NPZ_RE.match(name):
            s, prio = int(_STEP_NPZ_RE.match(name).group(1)), 1
        elif _STEP_OLD_RE.match(name) and os.path.isdir(full):
            s, prio = int(_STEP_OLD_RE.match(name).group(1)), 0
        else:
            continue
        if s not in cands or prio > cands[s][0]:
            cands[s] = (prio, full)
    if not cands:
        return None
    best = max(cands)
    return best, load(cands[best][1], like, mesh)
