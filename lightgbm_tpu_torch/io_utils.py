"""Text dataset files: CSV/TSV/LibSVM detection, the label column and the
side files (counterpart of ``lightgbm_tpu/io_utils.py``).

reference: src/io/parser.cpp (Parser::CreateParser format detection),
src/io/metadata.cpp (the ``.weight``/``.query``/``.init`` side files).
Host-side.  CSV/TSV go through pandas' C parser where pandas is
installed, as the JAX package reads them; without pandas a plain parser
reads them (each field through Python's ``float``; empty, ``nan``,
``NA`` and ``na`` are missing).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from .compat import PANDAS_INSTALLED
from .utils.file_io import exists as fs_exists, open_file

_NA = ("nan", "NA", "na", "")


def detect_format(path: str, num_probe_lines: int = 32) -> Tuple[str, bool]:
    """(format, has_header); format is 'csv', 'tsv' or 'libsvm'."""
    lines = []
    with open_file(path, "r") as fh:
        for _ in range(num_probe_lines):
            ln = fh.readline()
            if not ln:
                break
            if ln.strip():
                lines.append(ln.rstrip("\n"))
    if not lines:
        raise ValueError(f"empty data file: {path}")
    probe = lines[min(1, len(lines) - 1)]
    tokens = probe.replace("\t", " ").replace(",", " ").split()
    if any(":" in t for t in tokens[1:]):
        return "libsvm", False
    fmt = "tsv" if "\t" in probe else "csv"
    first = lines[0].split("\t" if fmt == "tsv" else ",")

    def is_num(s: str) -> bool:
        try:
            float(s)
            return True
        except ValueError:
            return s.strip().lower() in ("nan", "na", "")
    return fmt, not all(is_num(t) for t in first)


def _param_bool(params: dict, key: str, default: bool = False) -> bool:
    """A bool parameter given as a bool or as 'true'/'false'."""
    v = params.get(key, default)
    if isinstance(v, str):
        return v.strip().lower() not in ("false", "0", "no", "")
    return bool(v)


def _resolve_column(spec, names, default=None):
    if spec is None:
        return default
    s = str(spec)
    if s.startswith("name:"):
        nm = s[5:]
        if names and nm in names:
            return names.index(nm)
        raise ValueError(f"unknown column {nm!r}")
    return int(s)


def _resolve_label_and_columns(params, names, n_cols, dataset=None):
    """(label column, kept feature columns) of a text file; sets the
    dataset's feature names from the header."""
    label_spec = params.get("label_column", params.get("label", 0))
    label_idx = _resolve_column(label_spec, names, default=0)
    keep = [i for i in range(n_cols) if i != label_idx]
    ignore = params.get("ignore_column", params.get("ignore_feature"))
    if ignore:
        ignored = {_resolve_column(c, names) for c in str(ignore).split(",")}
        keep = [i for i in keep if i not in ignored]
    if dataset is not None:
        fn_param = getattr(dataset, "_feature_name_param", "auto")
        if fn_param not in ("auto", None):
            dataset.feature_names = list(fn_param)
        elif names:
            dataset.feature_names = [names[i] for i in keep]
    return label_idx, keep


def _parse_lines(lines: List[str], sep: str) -> np.ndarray:
    rows = [[np.nan if t.strip() in _NA else float(t)
             for t in ln.rstrip("\r\n").split(sep)] for ln in lines]
    return np.asarray(rows, np.float64).reshape(len(rows), -1)


def read_table_chunks(path: str, sep: str, has_header: bool,
                      chunk_rows: Optional[int] = None
                      ) -> Iterator[Tuple[Optional[List[str]], np.ndarray]]:
    """(column names or None, float64 block) a chunk of ``chunk_rows``
    rows (the whole file when None)."""
    if PANDAS_INSTALLED:
        import pandas as pd
        with open_file(path, "r") as fh:
            kw = dict(sep=sep, header=0 if has_header else None,
                      na_values=list(_NA))
            parts = (pd.read_csv(fh, chunksize=chunk_rows, **kw)
                     if chunk_rows else [pd.read_csv(fh, **kw)])
            for df in parts:
                names = [str(c) for c in df.columns] if has_header else None
                yield names, df.to_numpy(dtype=np.float64)
        return
    with open_file(path, "r") as fh:
        names = None
        if has_header:
            names = [t.strip() for t in fh.readline().rstrip("\r\n")
                     .split(sep)]
        block: List[str] = []
        for ln in fh:
            if not ln.strip():
                continue
            block.append(ln)
            if chunk_rows and len(block) == chunk_rows:
                yield names, _parse_lines(block, sep)
                block = []
        if block or not chunk_rows:
            yield names, _parse_lines(block, sep)


def _side_files(path: str, metadata) -> None:
    """``.weight``, ``.query`` and ``.init`` beside the data file, where
    the caller gave none."""
    for suffix, attr in ((".weight", "weight"), (".init", "init_score")):
        f = path + suffix
        if fs_exists(f) and getattr(metadata, attr) is None:
            with open_file(f) as fh:
                v = np.loadtxt(fh, dtype=np.float64)
            setattr(metadata, attr, v.reshape(-1).astype(np.float32)
                    if attr == "weight" else v)
    qfile = path + ".query"
    if fs_exists(qfile) and metadata.query_boundaries is None:
        with open_file(qfile) as fh:
            metadata.set_group(np.loadtxt(fh, dtype=np.int64).reshape(-1))


def load_text_dataset(path: str, dataset) -> np.ndarray:
    """A text file's features as a float64 matrix; sets the label, weight,
    group and init score of ``dataset`` from the label column and the
    side files."""
    params = dataset.params
    fmt, has_header = detect_format(path)
    if params.get("header", None) is not None:
        has_header = _param_bool(params, "header")
    if fmt == "libsvm":
        data, labels = _load_libsvm(path)
    else:
        names, mat = next(read_table_chunks(
            path, "\t" if fmt == "tsv" else ",", has_header))
        label_idx, keep = _resolve_label_and_columns(
            params, names, mat.shape[1], dataset)
        labels = mat[:, label_idx].astype(np.float32)
        data = mat[:, keep]
    if dataset.metadata.label is None:
        dataset.metadata.label = labels
    _side_files(path, dataset.metadata)
    return data


def load_prediction_file(path: str, n_model_features: int,
                         params: dict) -> np.ndarray:
    """A text file's features for prediction: a file as wide as the
    model's features has no label column; a wider one has its label
    column dropped; LibSVM files carry the label first.  reference:
    src/application/predictor.hpp (the parser takes the model's feature
    count)."""
    from .dataset import _BINARY_MAGIC
    from .utils.log import LightGBMError
    try:
        with open_file(path, "rb") as fh:
            is_bin = fh.read(len(_BINARY_MAGIC)) == _BINARY_MAGIC
    except OSError:
        is_bin = False
    if is_bin:
        raise LightGBMError("Unknown format of training data")
    fmt, has_header = detect_format(path)
    if params.get("header", None) is not None:
        has_header = _param_bool(params, "header")
    if fmt == "libsvm":
        X, _ = _load_libsvm(path)
        if X.shape[1] < n_model_features:
            X = np.pad(X, ((0, 0), (0, n_model_features - X.shape[1])))
        return X
    names, mat = next(read_table_chunks(
        path, "\t" if fmt == "tsv" else ",", has_header))
    if mat.shape[1] == n_model_features:
        return mat
    _, keep = _resolve_label_and_columns(params, names, mat.shape[1])
    return mat[:, keep]


def _load_libsvm(path: str) -> Tuple[np.ndarray, np.ndarray]:
    labels, rows, max_feat = [], [], -1
    with open_file(path) as fh:
        for ln in fh:
            parts = ln.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            row = {}
            for tok in parts[1:]:
                if ":" not in tok:
                    continue
                k, v = tok.split(":", 1)
                row[int(k)] = float(v)
                max_feat = max(max_feat, int(k))
            rows.append(row)
    X = np.zeros((len(rows), max_feat + 1), dtype=np.float64)
    for i, row in enumerate(rows):
        for k, v in row.items():
            X[i, k] = v
    return X, np.asarray(labels, dtype=np.float32)


def load_text_dataset_two_round(path: str, dataset,
                                chunk_rows: int = 200_000) -> None:
    """Two passes over a CSV/TSV file, never the whole float matrix in
    memory: pass 1 counts the rows, keeps the labels and a reservoir
    sample (Vitter's R, vectorised, as the JAX package draws it); pass 2
    bins each chunk into the dataset's [G, n] matrix.  A validation set
    (``reference=``) takes the reference's bins and skips the sample.
    LibSVM files take the one-pass load.  reference: ``two_round``,
    dataset_loader.cpp:775,1101."""
    import torch

    params = dataset.params
    fmt, has_header = detect_format(path)
    if params.get("header", None) is not None:
        has_header = _param_bool(params, "header")
    if fmt == "libsvm":
        dataset.raw_data = load_text_dataset(path, dataset)
        dataset._construct_inner()
        return
    sep = "\t" if fmt == "tsv" else ","
    sample_cnt = int(params.get("bin_construct_sample_cnt", 200000))
    rng = np.random.RandomState(int(params.get("data_random_seed", 1)))
    use_reference = dataset.reference is not None
    labels, reservoir, n_seen = [], None, 0
    label_idx = keep = None
    for names, mat in read_table_chunks(path, sep, has_header, chunk_rows):
        if label_idx is None:
            label_idx, keep = _resolve_label_and_columns(
                params, names, mat.shape[1], dataset)
        labels.append(mat[:, label_idx].astype(np.float32))
        feats = mat[:, keep]
        if not use_reference:
            if reservoir is None:
                reservoir = np.empty((sample_cnt, feats.shape[1]),
                                     np.float64)
            k = len(feats)
            if n_seen < sample_cnt:
                take = min(sample_cnt - n_seen, k)
                reservoir[n_seen:n_seen + take] = feats[:take]
                rest = np.arange(take, k)
            else:
                rest = np.arange(k)
            if len(rest):
                j = n_seen + rest
                r = (rng.random_sample(len(rest)) * (j + 1)).astype(np.int64)
                acc = r < sample_cnt
                reservoir[r[acc]] = feats[rest[acc]]
        n_seen += len(feats)
    n = n_seen
    if n == 0 or (reservoir is None and not use_reference):
        raise ValueError(f"no data rows found in {path!r}")
    dataset.num_data = n
    if use_reference:
        dataset._align_with(dataset.reference.construct())
    else:
        sample = reservoir[:min(sample_cnt, n)]
        dataset.num_total_features = sample.shape[1]
        if not dataset.feature_names:
            dataset.feature_names = [
                f"Column_{i}" for i in range(dataset.num_total_features)]
        dataset._fit_bin_mappers(sample, np.arange(len(sample)),
                                 dataset._resolve_categorical())
    dt = torch.uint8 if dataset.max_group_bin <= 256 else torch.int32
    binned = torch.zeros((dataset.num_groups, n), dtype=dt,
                         device=dataset.device)
    lo = 0
    for _, mat in read_table_chunks(path, sep, has_header, chunk_rows):
        feats = mat[:, keep]
        binned[:, lo:lo + len(feats)] = dataset._bin_rows(feats)
        lo += len(feats)
    dataset.binned_t = binned
    if dataset.metadata.label is None:
        dataset.metadata.label = np.concatenate(labels)
    _side_files(path, dataset.metadata)
    dataset._finish_construct()
