"""Retention trimming (reference: src/lib/table_trim.go, cmd_trim.go).

Blocks are ranked newest-first by their time column's max; blocks that
push the table past the size budget, or whose newest record predates the
cutoff, are flagged for deletion.  The CLI prints (or with
-delete -really, removes) the flagged block dirs.
"""

from __future__ import annotations

from . import blocks as blockio
from .table import Table


def trim_table(table: Table, mb_limit: int = 0, delete_before: int = 0) -> list[str]:
    """-> block dirs to trim, oldest last (TrimTable, table_trim.go:10-58)."""
    time_kid = table.schema.key_table.get(table.flags.time_col)
    infos = table.block_infos()

    def max_time(info: blockio.BlockInfo) -> int:
        ii = info.int_info.get(time_kid) if time_kid is not None else None
        return ii.max if ii else 0

    ranked = sorted(infos.items(), key=lambda kv: max_time(kv[1]),
                    reverse=True)
    byte_limit = mb_limit * 1024 * 1024
    cum_size = 0
    to_trim = []
    for bdir, info in ranked:
        cum_size += info.size
        too_big = byte_limit > 0 and cum_size > byte_limit
        too_old = delete_before > 0 and max_time(info) < delete_before
        if too_big or too_old:
            to_trim.append(bdir)
    return to_trim
