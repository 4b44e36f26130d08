"""Store abstraction for the Spark estimators' data and checkpoints (a
copy of ``horovod_tpu/spark/store.py``; reference:
horovod/spark/common/store.py).

A ``Store`` resolves run-scoped paths for the intermediate training data
(Parquet), checkpoints and logs: :class:`LocalStore` on the local
filesystem, :class:`FsspecStore` on any fsspec filesystem (s3://, gs://,
hdfs://, memory://). The Parquet layout is the JAX package's, so a
dataset written by either package reads in the other; it is what lets
workers stream their shards without the driver in the loop, the role
Petastorm plays in the reference.
"""

import os
import shutil
from typing import List, Optional


class Store:
    """Resolves run-scoped storage paths (reference store.py Store)."""

    def get_train_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_val_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def sync_fn(self, run_id: str):
        """Returns a callable that persists a local working dir into the
        store's checkpoint location (reference: store.py sync_fn)."""
        raise NotImplementedError

    @staticmethod
    def create(prefix_path: str, *args, **kwargs) -> "Store":
        """Route a path to a store backend by scheme (reference
        store.py Store.create → LocalStore | HDFSStore). Remote schemes
        (s3://, gs://, hdfs://, memory://, ...) go through fsspec when a
        backend for the scheme is installed — the HDFSStore role,
        generalized."""
        if "://" in prefix_path and not prefix_path.startswith("file://"):
            scheme = prefix_path.split("://", 1)[0]
            try:
                import fsspec
            except ImportError:
                raise ValueError(
                    f"no store backend for scheme {scheme!r}: fsspec is "
                    f"not installed; use a local path (LocalStore)")
            try:
                fsspec.get_filesystem_class(scheme)
            except ImportError as e:
                # fsspec itself is present; the SCHEME's backend package
                # (s3fs, gcsfs, ...) is what's missing — say so
                raise ValueError(
                    f"store scheme {scheme!r} needs an fsspec backend "
                    f"package: {e}")
            except ValueError as e:
                raise ValueError(
                    f"no store backend for scheme {scheme!r}: {e}")
            return FsspecStore(prefix_path, *args, **kwargs)
        return LocalStore(prefix_path.removeprefix("file://"),
                          *args, **kwargs)


class FilesystemStore(Store):
    """Shared path logic for filesystem-like stores."""

    def __init__(self, prefix_path: str,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 checkpoint_path: Optional[str] = None):
        self.prefix_path = prefix_path
        self._train_path = train_path
        self._val_path = val_path
        self._checkpoint_path = checkpoint_path

    def _run_path(self, base: Optional[str], run_id: str, leaf: str) -> str:
        if base:
            return os.path.join(base, run_id)
        return os.path.join(self.prefix_path, "runs", run_id, leaf)

    def get_train_data_path(self, run_id: str = "") -> str:
        return self._run_path(self._train_path, run_id, "train_data")

    def get_val_data_path(self, run_id: str = "") -> str:
        return self._run_path(self._val_path, run_id, "val_data")

    def get_checkpoint_path(self, run_id: str = "") -> str:
        return self._run_path(self._checkpoint_path, run_id, "checkpoints")

    def get_logs_path(self, run_id: str = "") -> str:
        return self._run_path(None, run_id, "logs")


class LocalStore(FilesystemStore):
    """Local-filesystem store (reference store.py LocalStore)."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def sync_fn(self, run_id: str):
        target = self.get_checkpoint_path(run_id)

        def sync(local_dir: str) -> None:
            os.makedirs(target, exist_ok=True)
            for name in os.listdir(local_dir):
                src = os.path.join(local_dir, name)
                dst = os.path.join(target, name)
                if os.path.isdir(src):
                    shutil.copytree(src, dst, dirs_exist_ok=True)
                else:
                    shutil.copy2(src, dst)
        return sync


class FsspecStore(FilesystemStore):
    """Remote store over any fsspec filesystem — s3://, gs://, hdfs://,
    memory:// (tests) ... (reference: store.py HDFSStore, generalized to
    every scheme fsspec knows). Paths keep their scheme; the Parquet IO
    helpers route through :attr:`fs` instead of the local filesystem."""

    def __init__(self, prefix_path: str, *args, **kwargs):
        import fsspec
        # url_to_fs, not fsspec.filesystem(scheme): the URL may carry
        # host/port/credentials (hdfs://namenode:8020/..., s3://key:secret@
        # bucket/...) that scheme-only construction silently discards,
        # connecting to the default-configured endpoint instead
        self.fs, _ = fsspec.core.url_to_fs(prefix_path)
        super().__init__(prefix_path, *args, **kwargs)

    def _run_path(self, base: Optional[str], run_id: str, leaf: str) -> str:
        # posix joins: remote object paths never use os.sep
        if base:
            return f"{base.rstrip('/')}/{run_id}"
        return f"{self.prefix_path.rstrip('/')}/runs/{run_id}/{leaf}"

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)

    def makedirs(self, path: str) -> None:
        self.fs.makedirs(path, exist_ok=True)

    def sync_fn(self, run_id: str):
        target = self.get_checkpoint_path(run_id)
        fs = self.fs

        def sync(local_dir: str) -> None:
            fs.makedirs(target, exist_ok=True)
            fs.put(local_dir.rstrip("/") + "/", target.rstrip("/") + "/",
                   recursive=True)
        return sync


# ---------------------------------------------------------------------------
# Parquet IO helpers (the Petastorm-equivalent data path). ``fs=None``
# means the local filesystem; estimators pass ``store.fs`` so the same
# code streams local and remote datasets.
# ---------------------------------------------------------------------------

def _list_parquet_files(path: str, fs=None) -> List[str]:
    """Sorted part files of a Parquet dataset directory (shared by the
    in-memory shard reader and the streaming iterator, so both always
    see the same file set)."""
    if fs is None:
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".parquet"))
    else:
        files = sorted(f for f in fs.ls(path, detail=False)
                       if f.endswith(".parquet"))
    if not files:
        raise FileNotFoundError(f"no parquet files under {path}")
    return files


def _column_to_numpy(col):
    """Arrow column -> numpy without boxing every cell: columnar
    conversion for flat types; fixed-size list columns (the vector
    encoding write_parquet uses) stack into a 2-d array."""
    import numpy as np

    arr = col.combine_chunks().to_numpy(zero_copy_only=False)
    if arr.dtype == object:
        arr = np.stack(arr)
    return arr

def write_parquet(path: str, columns: dict, row_group_rows: int = 4096,
                  partitions: int = 1, fs=None) -> None:
    """Write named numpy columns as one or more Parquet files under
    ``path`` (a directory, like a Spark parquet dataset)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    if fs is None:
        os.makedirs(path, exist_ok=True)
    else:
        fs.makedirs(path, exist_ok=True)
    n = len(next(iter(columns.values())))
    per = (n + partitions - 1) // partitions
    for p in range(partitions):
        sl = slice(p * per, min((p + 1) * per, n))
        if sl.start >= n:
            break
        arrays, names = [], []
        for name, col in columns.items():
            col = np.asarray(col)[sl]
            if col.ndim > 1:   # fixed-size vectors become list columns
                arrays.append(pa.array(list(col)))
            else:
                arrays.append(pa.array(col))
            names.append(name)
        part = f"{path.rstrip('/')}/part-{p:05d}.parquet" if fs is not None \
            else os.path.join(path, f"part-{p:05d}.parquet")
        table = pa.Table.from_arrays(arrays, names=names)
        if fs is None:
            pq.write_table(table, part, row_group_size=row_group_rows)
        else:
            with fs.open(part, "wb") as f:
                pq.write_table(table, f, row_group_size=row_group_rows)


def read_parquet_shard(path: str, columns: List[str], rank: int = 0,
                       size: int = 1, fs=None):
    """Read this worker's shard (rows ``rank::size``) of a Parquet dataset
    directory into numpy arrays, one per requested column."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    files = _list_parquet_files(path, fs)
    if fs is None:
        tables = [pq.read_table(f, columns=columns) for f in files]
    else:
        tables = []
        for f in files:
            with fs.open(f, "rb") as fh:
                tables.append(pq.read_table(fh, columns=columns))
    table = pa.concat_tables(tables)
    return [_column_to_numpy(table.column(c))[rank::size]
            for c in columns]


class ParquetBatchIterator:
    """Stream batches from a Parquet dataset directory WITHOUT
    materializing it — the Petastorm reader role (reference:
    spark/common/store.py + keras/estimator.py feed workers through
    petastorm's make_batch_reader). Sharding is by ROW GROUP round-robin
    across ranks, so a worker's memory footprint is one row group plus
    one batch regardless of dataset size.

    Yields ``{column: np.ndarray}`` dicts of up to ``batch_size`` rows;
    the final partial batch is yielded unless ``drop_last``. ``shuffle``
    permutes row-group order and rows within each row group from
    ``seed`` (new permutation per epoch via :meth:`set_epoch`, the
    torch-sampler convention).
    """

    def __init__(self, path, columns, batch_size: int, rank: int = 0,
                 size: int = 1, fs=None, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        import pyarrow.parquet as pq

        self.path, self.columns = path, list(columns)
        self.batch_size, self.rank, self.size = int(batch_size), rank, size
        self.fs, self.shuffle, self.seed = fs, shuffle, int(seed)
        self.drop_last = drop_last
        self._epoch = 0
        self._files = _list_parquet_files(path, fs)
        # Row-group counts from the footers ONCE (read_metadata touches
        # only the footer); epochs then open just the files whose groups
        # this rank owns, and close them when consumed.
        self._rg_counts = []
        for f in self._files:
            if fs is None:
                self._rg_counts.append(pq.read_metadata(f).num_row_groups)
            else:
                with fs.open(f, "rb") as fh:
                    self._rg_counts.append(
                        pq.read_metadata(fh).num_row_groups)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _open(self, f):
        """Returns (ParquetFile, closer)."""
        import pyarrow.parquet as pq
        if self.fs is None:
            pf = pq.ParquetFile(f)
            return pf, pf.close
        fh = self.fs.open(f, "rb")
        pf = pq.ParquetFile(fh)

        def close():
            pf.close()
            fh.close()
        return pf, close

    def __iter__(self):
        import numpy as np

        # global row-group list (file idx, rg idx), sharded round-robin
        groups = [(fi, g) for fi, cnt in enumerate(self._rg_counts)
                  for g in range(cnt)]
        mine = [g for i, g in enumerate(groups)
                if i % self.size == self.rank]
        rng = np.random.RandomState(self.seed + self._epoch) \
            if self.shuffle else None
        if rng is not None:
            rng.shuffle(mine)

        readers = {}   # fi -> (ParquetFile, closer), opened on demand
        remaining = {}  # fi -> groups of mine not yet consumed
        for fi, _gi in mine:
            remaining[fi] = remaining.get(fi, 0) + 1
        try:
            # chunk-list buffering: row-group arrays accumulate in a
            # list and concatenate ONCE per drain, so filling a batch
            # from k small row groups copies each row O(1) times, not
            # O(k)
            parts = []      # list of dict col -> ndarray
            buffered = 0

            def drain(final: bool):
                nonlocal parts, buffered
                merged = parts[0] if len(parts) == 1 else {
                    c: np.concatenate([p[c] for p in parts])
                    for c in self.columns}
                off = 0
                while buffered - off >= self.batch_size:
                    yield {c: v[off:off + self.batch_size]
                           for c, v in merged.items()}
                    off += self.batch_size
                if final and buffered - off and not self.drop_last:
                    yield {c: v[off:] for c, v in merged.items()}
                    off = buffered
                parts = [{c: v[off:] for c, v in merged.items()}] \
                    if buffered - off else []
                buffered -= off

            for fi, gi in mine:
                if fi not in readers:
                    readers[fi] = self._open(self._files[fi])
                tbl = readers[fi][0].read_row_group(
                    gi, columns=self.columns)
                remaining[fi] -= 1
                if remaining[fi] == 0:
                    readers.pop(fi)[1]()
                cols = {c: _column_to_numpy(tbl.column(c))
                        for c in self.columns}
                n = len(next(iter(cols.values())))
                if rng is not None:
                    perm = rng.permutation(n)
                    cols = {c: v[perm] for c, v in cols.items()}
                parts.append(cols)
                buffered += n
                if buffered >= self.batch_size:
                    yield from drain(final=False)
            if buffered:
                yield from drain(final=True)
        finally:
            for _pf, close in readers.values():
                close()
