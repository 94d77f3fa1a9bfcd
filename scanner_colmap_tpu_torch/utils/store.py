"""Typed columnar artifact store — the stage-checkpoint backbone.

The port's own copy of the JAX package's ``utils/store.py``, with the same
on-disk format, so a table written by either package reads back through
the other.

Design:
- a store is a directory; each *table* is a subdirectory holding a
  ``manifest.json`` plus one file per column
- columns are either *uniform* (one ndarray, rows on axis 0 → ``.npy``) or
  *ragged* (list of per-row ndarrays → flattened data ``.npy`` + row offsets)
  or *bytes* (list of bytes → blob + offsets)
- writes are atomic (write to ``<name>.tmp-<pid>``, fsync, rename), so a
  crashed stage never leaves a half-written table and re-running is always
  safe
- the manifest records schema, row count, creation time, and arbitrary
  stage metadata (the config used, metrics) for provenance

Column payloads are written by Python (tmp, fsync, rename: the same
durability guarantee as the JAX package's optional C++ writer, which the
port does not carry).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import time
from typing import Dict, List, Optional, Union

import numpy as np

from scanner_colmap_tpu_torch.utils.metrics import count, span

Column = Union[np.ndarray, List[np.ndarray], List[bytes]]

# columns at or above this many bytes are read as zero-copy memmaps; small
# columns load eagerly — a memmap per tiny file wastes fd/page overhead
MMAP_READ_THRESHOLD = 1 << 20


def _write_bytes(path: str, payload: bytes):
    """Durable write of one file (a column payload, a manifest): tmp,
    fsync, rename."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    count("store.bytes_written", len(payload))
    count("store.fsyncs")


def _save_npy(path: str, arr: np.ndarray):
    bio = io.BytesIO()
    np.lib.format.write_array(bio, np.ascontiguousarray(arr),
                              allow_pickle=False)
    _write_bytes(path, bio.getvalue())


def _load_npy(path: str) -> np.ndarray:
    if os.path.getsize(path) >= MMAP_READ_THRESHOLD:
        return np.load(path, mmap_mode="r")
    return np.load(path)


class ArtifactStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------
    def _table_dir(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ValueError(f"bad table name: {name!r}")
        return os.path.join(self.root, name)

    def list_tables(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
            and os.path.exists(os.path.join(self.root, d, "manifest.json"))
        )

    def has_table(self, name: str) -> bool:
        return os.path.exists(os.path.join(self._table_dir(name), "manifest.json"))

    def delete_table(self, name: str):
        d = self._table_dir(name)
        if os.path.isdir(d):
            shutil.rmtree(d)

    # ------------------------------------------------------------------
    def write_table(self, name: str, columns: Dict[str, Column],
                    meta: Optional[dict] = None, overwrite: bool = True):
        with span("store.write"):
            self._write_table(name, columns, meta, overwrite)

    def _write_table(self, name, columns, meta, overwrite):
        final = self._table_dir(name)
        if self.has_table(name) and not overwrite:
            raise FileExistsError(f"table {name} exists")
        tmp = final + f".tmp-{os.getpid()}"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        manifest = {
            "name": name,
            "created": time.time(),
            "meta": meta or {},
            "columns": {},
            "num_rows": None,
        }
        num_rows = None
        for col, data in columns.items():
            info = self._write_column(tmp, col, data)
            manifest["columns"][col] = info
            if num_rows is None:
                num_rows = info["num_rows"]
            elif num_rows != info["num_rows"]:
                shutil.rmtree(tmp)
                raise ValueError(
                    f"column {col} has {info['num_rows']} rows, expected {num_rows}")
        manifest["num_rows"] = num_rows

        _write_bytes(os.path.join(tmp, "manifest.json"),
                     json.dumps(manifest, indent=2).encode())
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    def _write_column(self, tdir: str, col: str, data: Column) -> dict:
        if isinstance(data, np.ndarray):
            _save_npy(os.path.join(tdir, f"{col}.npy"), data)
            return {"kind": "uniform", "num_rows": int(data.shape[0]) if data.ndim else 1,
                    "dtype": str(data.dtype), "shape": list(data.shape)}
        if isinstance(data, list) and (not data or isinstance(data[0], bytes)):
            blob = b"".join(data)
            offsets = np.zeros(len(data) + 1, dtype=np.int64)
            if data:
                np.cumsum([len(b) for b in data], out=offsets[1:])
            _write_bytes(os.path.join(tdir, f"{col}.blob"), blob)
            _save_npy(os.path.join(tdir, f"{col}.offsets.npy"), offsets)
            return {"kind": "bytes", "num_rows": len(data)}
        if isinstance(data, list):
            arrs = [np.asarray(a) for a in data]
            if arrs:
                trailing = arrs[0].shape[1:]
                dtype = arrs[0].dtype
                for a in arrs:
                    if a.shape[1:] != trailing or a.dtype != dtype:
                        raise ValueError(f"ragged column {col}: inconsistent trailing shape/dtype")
                flat = np.concatenate([a.reshape((-1,) + trailing) for a in arrs], axis=0)
            else:
                trailing, dtype, flat = (), np.float32, np.zeros((0,), np.float32)
            offsets = np.zeros(len(arrs) + 1, dtype=np.int64)
            if arrs:
                np.cumsum([a.shape[0] for a in arrs], out=offsets[1:])
            _save_npy(os.path.join(tdir, f"{col}.npy"), flat)
            _save_npy(os.path.join(tdir, f"{col}.offsets.npy"), offsets)
            return {"kind": "ragged", "num_rows": len(arrs), "dtype": str(dtype),
                    "trailing_shape": list(trailing)}
        raise TypeError(f"unsupported column type for {col}: {type(data)}")

    # ------------------------------------------------------------------
    def read_manifest(self, name: str) -> dict:
        with open(os.path.join(self._table_dir(name), "manifest.json")) as f:
            return json.load(f)

    def read_table(self, name: str, columns: Optional[List[str]] = None
                   ) -> Dict[str, Column]:
        """The table's columns (all, or those named); columns of 1 MiB or
        more come back as memmaps, read from disk as they are used."""
        with span("store.read"):
            manifest = self.read_manifest(name)
            tdir = self._table_dir(name)
            out: Dict[str, Column] = {}
            for col, info in manifest["columns"].items():
                if columns is not None and col not in columns:
                    continue
                out[col] = self._read_column(tdir, col, info)
            return out

    def read_column(self, name: str, col: str) -> Column:
        with span("store.read"):
            manifest = self.read_manifest(name)
            return self._read_column(self._table_dir(name), col, manifest["columns"][col])

    def _read_column(self, tdir: str, col: str, info: dict) -> Column:
        kind = info["kind"]
        if kind == "uniform":
            # large columns come back as read-only zero-copy memmaps
            return _load_npy(os.path.join(tdir, f"{col}.npy"))
        if kind == "bytes":
            offsets = np.load(os.path.join(tdir, f"{col}.offsets.npy"))
            with open(os.path.join(tdir, f"{col}.blob"), "rb") as f:
                blob = f.read()
            return [blob[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]
        if kind == "ragged":
            flat = _load_npy(os.path.join(tdir, f"{col}.npy"))
            offsets = np.load(os.path.join(tdir, f"{col}.offsets.npy"))
            return [flat[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]
        raise ValueError(f"unknown column kind {kind}")

    def num_rows(self, name: str) -> int:
        return self.read_manifest(name)["num_rows"]
