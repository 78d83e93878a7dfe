"""Table metadata recovery and re-indexing.

- rebuild_table_info: reconstruct a lost/corrupt info.json from block
  consensus — scan every block's info + column files, vote on column
  types, merge stats (reference: DeduceTableInfoFromBlocks,
  src/lib/table_recover_info.go:92, cmd_rebuild.go).
- update_table_info: re-derive the table-level int min/max indexes from
  block stats (`index -update-info` / `query -update-info`,
  cmd_index.go:7).
"""

from __future__ import annotations

import os
from collections import Counter

from . import blocks as blockio, codec, constants
from .debug import debug, print_, warn
from .schema import IntInfo, Schema, StrInfo
from .table import Table


def _scan_block_columns(bdir: str) -> dict[str, int]:
    """column name -> type tag, from the column files present."""
    out = {}
    prefixes = {"int_": constants.INT_VAL, "str_": constants.STR_VAL,
                "set_": constants.SET_VAL}
    for fn in os.listdir(bdir):
        base = fn[:-3] if fn.endswith(".sy") else (
            fn[:-6] if fn.endswith(".sy.gz") else None)
        if base is None:
            continue
        for pfx, typ in prefixes.items():
            if base.startswith(pfx):
                out[base[len(pfx):]] = typ
    return out


def deduce_schema_from_blocks(table: Table) -> Schema:
    votes: dict[str, Counter] = {}
    int_stats: dict[str, IntInfo] = {}
    for bdir in table.list_block_dirs():
        info = blockio.load_block_info(bdir)
        cols = _scan_block_columns(bdir)
        for name, typ in cols.items():
            votes.setdefault(name, Counter())[typ] += 1
        if info is None:
            continue

    schema = Schema()
    for name in sorted(votes):
        kid = schema.get_key_id(name)
        typ = votes[name].most_common(1)[0][0]
        schema.key_types[kid] = typ

    # merge block-level stats into table-level (min/max exact; avg/m2
    # merged by size — the sequential ingest stats are unrecoverable)
    for bdir in table.list_block_dirs():
        cols = _scan_block_columns(bdir)
        data = blockio.load_block_columns(
            bdir, schema, [n for n, t in cols.items()
                           if t == constants.INT_VAL])
        for name, cd in data.items():
            kid = schema.key_table[name]
            tgt = schema.int_info.setdefault(kid, IntInfo())
            present = cd.values[cd.valid]
            if len(present):
                tgt.update_many(present)
    return schema


def rebuild_table_info(table: Table, replace: bool = False,
                       force: bool = False) -> None:
    has_info = os.path.exists(table.info_path)
    if has_info and not (replace or force):
        print_("table info already exists; use -replace to overwrite")
        return
    schema = deduce_schema_from_blocks(table)
    if not schema.key_table and not force:
        warn("no blocks found to rebuild from; use -force to write anyway")
        return
    table.schema = schema
    table.save_info()
    print_("rebuilt info for table", table.name,
           "with", len(schema.key_table), "columns")


def update_table_info(table: Table) -> None:
    """Recompute table-level int stats from the actual block data."""
    schema = table.schema
    for kid in list(schema.int_info):
        schema.int_info[kid] = IntInfo()
    for bdir in table.list_block_dirs():
        names = [n for n, k in schema.key_table.items()
                 if schema.key_types.get(k) == constants.INT_VAL]
        data = blockio.load_block_columns(bdir, schema, names)
        for name, cd in data.items():
            kid = schema.key_table[name]
            tgt = schema.int_info.setdefault(kid, IntInfo())
            present = cd.values[cd.valid]
            if len(present):
                tgt.update_many(present)
        # refresh per-block stats too (min/max skip indexes)
        info = blockio.load_block_info(bdir)
        if info is not None:
            new_info = blockio.compute_block_info(
                blockio.load_block_columns(bdir, schema,
                                           list(schema.key_table)),
                schema, table.flags.skip_outliers)
            new_info.size = info.size
            codec.write_json_atomic(os.path.join(bdir, "info.json"),
                                    new_info.to_json())
    table.save_info()
    # block stats changed on disk: the batched block-info cache is stale
    from . import blockcache
    blockcache.clear(table.dir)
    debug("updated table info for", table.name)
