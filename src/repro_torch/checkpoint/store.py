"""Grid-quorum checkpoint store of torch tensors - compartmentalization 2
applied to checkpoint I/O (port of ``checkpoint/store.py``).

Storage nodes form an ``r x w`` grid (paper section 3.2).  A checkpoint is
split into per-leaf shards; shard ``i`` is assigned to column ``i % w`` and
written to **every row of that column** (a write quorum).  A restore picks
any **row** (a read quorum): every row intersects every column, so one row
holds at least one replica of every shard.  Each leaf carries a crc32; a
restore falls back across the rows of its column past a dead node or a
corrupt payload.  The manifest is the unit the training coordinator
orders through the RSM log (CKPT_COMMIT).

Trees are nested dicts, lists and tuples of tensors (or numpy arrays or
Python numbers); leaves are named by their key paths as the reference
names them (``['params']['layers.0.attn.w_q']``).  A bf16 tensor is stored
as a uint16 view, every other dtype as itself; a restore gives tensors of
the saved dtype on the device of the matching leaf of ``like_tree``.
:meth:`GridCheckpointStore.save_async` copies every leaf to the host
before it returns, so training may go on writing its tensors in place.
"""
from __future__ import annotations

import json
import threading
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch


@dataclass
class Manifest:
    step: int
    leaves: Dict[str, dict]   # name -> {column, shape, dtype, crc32, bytes}
    treedef_repr: str
    created_at: float

    def to_json(self) -> str:
        return json.dumps({"step": self.step, "leaves": self.leaves,
                           "treedef_repr": self.treedef_repr,
                           "created_at": self.created_at})

    @staticmethod
    def from_json(s: str) -> "Manifest":
        d = json.loads(s)
        return Manifest(step=d["step"], leaves=d["leaves"],
                        treedef_repr=d["treedef_repr"],
                        created_at=d["created_at"])


def _items(tree: dict) -> List[Tuple[Any, Any]]:
    """A dict's items in sorted key order, the order in which
    ``jax.tree_util`` walks a dict: a leaf's index, column and shard file
    follow from it."""
    return [(k, tree[k]) for k in sorted(tree)]


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in order: dicts by sorted key, lists and
    tuples by index."""
    if isinstance(tree, dict):
        return [kv for k, v in _items(tree)
                for kv in _flatten(v, f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order, from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in _items(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(v)}"
                               for k, v in _items(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _to_host(leaf) -> np.ndarray:
    """A leaf's bytes as a numpy array: bf16 as a uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


class GridCheckpointStore:
    def __init__(self, base_dir: str, rows: int = 2, cols: int = 2) -> None:
        self.base = Path(base_dir)
        self.rows, self.cols = rows, cols
        self.dead: Set[Tuple[int, int]] = set()
        self.write_bytes_per_node: Dict[Tuple[int, int], int] = {}
        for r in range(rows):
            for c in range(cols):
                self._node_dir(r, c).mkdir(parents=True, exist_ok=True)
        self._async_threads: List[threading.Thread] = []

    # -- fault injection ------------------------------------------------------
    def fail_node(self, row: int, col: int) -> None:
        self.dead.add((row, col))

    def recover_node(self, row: int, col: int) -> None:
        self.dead.discard((row, col))

    def _node_dir(self, row: int, col: int) -> Path:
        return self.base / f"node_r{row}_c{col}"

    # -- save -------------------------------------------------------------------
    def save(self, step: int, tree) -> Manifest:
        manifest_leaves: Dict[str, dict] = {}
        for i, (name, leaf) in enumerate(_flatten(tree)):
            arr = _to_host(leaf)
            dtype_str = ("bfloat16" if isinstance(leaf, torch.Tensor)
                         and leaf.dtype == torch.bfloat16 else str(arr.dtype))
            data = arr.tobytes()
            col = i % self.cols
            crc = zlib.crc32(data)
            fname = f"step{step}_{i:05d}.bin"
            for row in range(self.rows):  # write quorum = the whole column
                if (row, col) in self.dead:
                    continue
                path = self._node_dir(row, col) / fname
                path.write_bytes(data)
                key = (row, col)
                self.write_bytes_per_node[key] = (
                    self.write_bytes_per_node.get(key, 0) + len(data))
            manifest_leaves[name] = {
                "index": i, "column": col, "shape": list(arr.shape),
                "dtype": dtype_str, "crc32": crc, "bytes": len(data),
                "file": fname,
            }
        manifest = Manifest(step=step, leaves=manifest_leaves,
                            treedef_repr=_structure(tree),
                            created_at=time.time())
        (self.base / f"manifest_step{step}.json").write_text(manifest.to_json())
        return manifest

    def save_async(self, step: int, tree) -> threading.Thread:
        """Copy every leaf to the host first, then write in the background -
        training continues while bytes hit 'storage'."""
        host_tree = _unflatten(tree, iter(
            leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else np.array(leaf)
            for _, leaf in _flatten(tree)))
        t = threading.Thread(target=self.save, args=(step, host_tree),
                             daemon=True)
        t.start()
        self._async_threads.append(t)
        return t

    def wait(self) -> None:
        for t in self._async_threads:
            t.join()
        self._async_threads.clear()

    # -- restore ----------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.stem.split("step")[1])
                       for p in self.base.glob("manifest_step*.json"))
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree) -> Any:
        """Read one live row (read quorum); per leaf fall back across rows of
        its column if a node is dead or the payload is corrupt."""
        manifest = Manifest.from_json(
            (self.base / f"manifest_step{step}.json").read_text())
        out_leaves = []
        # pick a starting row that is maximally alive
        row_order = sorted(range(self.rows),
                           key=lambda r: sum((r, c) in self.dead
                                             for c in range(self.cols)))
        for name, like in _flatten(like_tree):
            meta = manifest.leaves[name]
            col = meta["column"]
            data = None
            for row in row_order:
                if (row, col) in self.dead:
                    continue
                path = self._node_dir(row, col) / meta["file"]
                if not path.exists():
                    continue
                blob = path.read_bytes()
                if zlib.crc32(blob) != meta["crc32"]:
                    continue  # bit rot: try the next replica
                data = blob
                break
            if data is None:
                raise IOError(
                    f"no intact replica of {name} (column {col}) - more than "
                    f"f failures in that column")
            dtype = meta["dtype"]
            if dtype == "bfloat16":
                arr = np.frombuffer(data, np.int16).reshape(meta["shape"])
                leaf = torch.from_numpy(arr.copy()).view(torch.bfloat16)
            else:
                arr = np.frombuffer(data, np.dtype(dtype)).reshape(
                    meta["shape"])
                leaf = torch.from_numpy(arr.copy())
            device = like.device if isinstance(like, torch.Tensor) else "cpu"
            out_leaves.append(leaf.to(device))
        return _unflatten(like_tree, iter(out_leaves))

    # -- accounting ---------------------------------------------------------------
    def write_load_fractions(self) -> Dict[str, float]:
        total = sum(self.write_bytes_per_node.values())
        if not total:
            return {}
        return {f"r{r}c{c}": b / total
                for (r, c), b in sorted(self.write_bytes_per_node.items())}
