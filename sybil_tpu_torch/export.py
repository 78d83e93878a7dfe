"""TSV export of block data.

The reference's `query -export` dumps every scanned block's records to
`db/T/export/<block>.tsv.gz` (table_block_io.go:356-398, gated at
cmd_query.go:346,371).  Here the export is vectorized: columns decode
host-side once and rows assemble by numpy fancy-indexing into object
arrays rather than per-record loops.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from . import blocks as blockio
from .constants import INT_VAL, SET_VAL, STR_VAL
from .debug import debug, warn


def export_table(table, flags=None) -> list[str]:
    """Write one TSV per block under `db/T/export/`; returns the paths."""
    export_dir = os.path.join(table.dir, "export")
    os.makedirs(export_dir, exist_ok=True)
    schema = table.schema
    # header order: int columns then str columns (toTSVRow walks Ints
    # before Strs, printer.go:312-328); set columns are not exported,
    # matching the reference
    int_cols = schema.cols_of_type(INT_VAL)
    str_cols = schema.cols_of_type(STR_VAL)
    header = "\t".join(int_cols + str_cols)

    paths = []
    for bdir in table.list_block_dirs():
        info = blockio.load_block_info(bdir)
        if info is None or info.num_records == 0:
            continue
        n = info.num_records
        data = blockio.load_block_columns(bdir, schema, int_cols + str_cols)
        cells = []
        for name in int_cols:
            cd = data.get(name)
            col = np.full(n, "", dtype=object)
            if isinstance(cd, blockio.IntColumnData):
                vals = cd.values[:n].astype(str).astype(object)
                col[: len(vals)] = np.where(cd.valid[:n], vals, "")
            cells.append(col)
        for name in str_cols:
            cd = data.get(name)
            col = np.full(n, "", dtype=object)
            if isinstance(cd, blockio.StrColumnData):
                strings = np.asarray(table.dicts.get(name).strings,
                                     dtype=object)
                if len(strings):
                    ids = np.clip(cd.ids[:n], 0, len(strings) - 1)
                    col[: len(ids)] = np.where(cd.valid[:n], strings[ids], "")
            cells.append(col)
        if not cells:
            continue
        mat = np.stack(cells, axis=1)
        body = "\n".join("\t".join(row) for row in mat)
        out_path = os.path.join(export_dir,
                                os.path.basename(bdir) + ".tsv.gz")
        tmp = out_path + f".tmp{os.getpid()}"
        try:
            with gzip.open(tmp, "wt") as f:
                f.write(header + "\n" + body)
            os.rename(tmp, out_path)
            paths.append(out_path)
        except OSError as e:
            warn("could not save TSV for", out_path, e)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        debug("exported", n, "records to", out_path)
    return paths
