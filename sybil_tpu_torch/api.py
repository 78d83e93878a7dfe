"""Client API: the L6 layer of the reference (src/api, ~940 LoC Go).

The Go client buffers records, pipes them into a `sybil ingest` subprocess,
and builds queries with a fluent interface that shells out to `sybil query
--json` (api/cmd_query.go:37-217, api/cmd_ingest.go:23-147).  Here the same
surface is provided in Python with two execution modes:

- in-process (default): calls the engine directly — no serialization, no
  process spawn, and the kernels built and the columns resident on the
  device stay across queries.
- subprocess: spawns `python -m sybil_tpu_torch …` exactly like the Go
  client spawns the sybil binary (process isolation; useful when embedding
  in a long-lived server that must bound query memory).

Method names are snake_case ports of the Go builder (api/cmd_query.go:55-137:
TimeSeries, Samples, Aggregate, Hist, LogHist, GroupBy, WeightCol, Limit,
IntFilterEq/Gt/Lt/Neq…).  Unlike the reference — whose StrFilterEq/
StrFilterRegex are unimplemented stubs (api/cmd_query.go:132-137) — str and
set filters work here.

`SybilConfig.device` is the CLI's `-device`: "cuda" (the default) runs the
scan's kernels and fails without a card; "cpu" runs their plain PyTorch
versions, and only when asked for.
"""

from __future__ import annotations

import json
import subprocess
import sys
from dataclasses import dataclass, field

from .config import Flags

# The Go client joins multi-value flags with ASCII 30/31 so values may
# contain commas/colons (api/cmd_query.go:15-16).
FIELD_SEPARATOR = chr(30)
FILTER_SEPARATOR = chr(31)


@dataclass
class SybilConfig:
    dir: str = "./db/"
    table: str = ""
    device: str = "cuda"


class SybilResult(dict):
    """Result row with typed getters (api/types.go:30-45)."""

    def int(self, field: str):
        v = self.get(field)
        return (int(v), True) if isinstance(v, (int, float)) else (0, False)

    def str(self, field: str):
        v = self.get(field)
        return (v, True) if isinstance(v, str) else ("", False)

    def set(self, field: str):
        v = self.get(field)
        return (v, True) if isinstance(v, (list, dict)) else (None, False)


@dataclass
class SybilRecord:
    """Explicit record builder (api/types.go:22-27, api/types.go:60-80)."""
    ints: dict = field(default_factory=dict)
    strs: dict = field(default_factory=dict)
    sets: dict = field(default_factory=dict)

    def add_int(self, name: str, value: int) -> "SybilRecord":
        self.ints[name] = int(value)
        return self

    def add_str(self, name: str, value: str) -> "SybilRecord":
        self.strs[name] = str(value)
        return self

    def add_set(self, name: str, values) -> "SybilRecord":
        self.sets[name] = [str(v) for v in values]
        return self

    def to_dict(self) -> dict:
        out: dict = {}
        out.update(self.ints)
        out.update(self.strs)
        out.update(self.sets)
        return out


class SybilTable:
    """Record buffer + query factory (api/types.go:11-14, cmd_ingest.go)."""

    def __init__(self, config: SybilConfig, subprocess_mode: bool = False):
        self.config = config
        self.subprocess_mode = subprocess_mode
        self.new_records: list[dict] = []

    # -- ingestion (api/cmd_ingest.go:23-91) --------------------------------
    def add_records(self, records) -> None:
        for r in records:
            if isinstance(r, SybilRecord):
                self.new_records.append(r.to_dict())
            elif isinstance(r, (bytes, str)):
                try:
                    self.new_records.append(json.loads(r))
                except json.JSONDecodeError as e:
                    print("ERROR UNPACKING JSON RECORD", e, file=sys.stderr)
            elif isinstance(r, dict):
                self.new_records.append(r)
            else:
                raise TypeError(f"can't ingest records of type {type(r)}")

    def flush_records(self) -> None:
        """Write buffered records to the row store (cmd_ingest.go:91-147)."""
        if not self.new_records:
            return
        if self.subprocess_mode:
            payload = "\n".join(json.dumps(r) for r in self.new_records)
            _run_cli(["ingest", "-dir", self.config.dir,
                      "-table", self.config.table, "-skip-compact"],
                     stdin=payload)
        else:
            from .ingest import flatten_record
            from .table import Table
            t = Table(self.config.table, self._flags())
            t.ingest_records([flatten_record(r) for r in self.new_records])
        self.new_records = []

    def digest(self) -> None:
        """Row store -> column blocks (api/cmd_digest.go:6)."""
        if self.subprocess_mode:
            _run_cli(["digest", "-dir", self.config.dir,
                      "-table", self.config.table])
        else:
            from .digest import digest_records
            from .table import Table
            t = Table(self.config.table, self._flags())
            t.load_info()
            digest_records(t)

    # -- metadata (api/cmd_table_info.go, api/cmd_list_tables.go) -----------
    def table_info(self) -> dict:
        if self.subprocess_mode:
            out = _run_cli(["query", "-dir", self.config.dir, "-table",
                            self.config.table, "-info", "-json"])
            return json.loads(out)
        from .table import Table
        t = Table(self.config.table, self._flags())
        t.load_info()
        return t.table_info()

    def list_tables(self) -> list[str]:
        if self.subprocess_mode:
            out = _run_cli(["query", "-dir", self.config.dir,
                            "-tables", "-json"])
            return json.loads(out)
        from .table import list_tables
        return list_tables(self._flags())

    # -- queries ------------------------------------------------------------
    def query(self) -> "SybilQuery":
        return SybilQuery(self)

    def _flags(self) -> Flags:
        return Flags(dir=self.config.dir, table=self.config.table,
                     device=self.config.device)


class SybilQuery:
    """Fluent query builder (api/cmd_query.go:19-153)."""

    def __init__(self, table: SybilTable):
        self.table = table
        self.config = table.config
        self._flags: list[str] = []
        self._int_filters: list[tuple[str, str, str]] = []
        self._str_filters: list[tuple[str, str, str]] = []
        self._set_filters: list[tuple[str, str, str]] = []
        self._strs: list[str] = []
        self._ints: list[str] = []
        self._sets: list[str] = []
        self._read_log = True

    # query type
    def time_series(self, time_col: str, bucket: int) -> "SybilQuery":
        self._flags += ["-time", "-time-bucket", str(bucket),
                        "-time-col", time_col]
        return self

    def read_row_log(self, v: bool) -> "SybilQuery":
        self._read_log = v
        return self

    def samples(self) -> "SybilQuery":
        self._flags.append("-samples")
        return self

    # columns
    def aggregate(self, field: str) -> "SybilQuery":
        self._ints.append(field)
        return self

    def hist(self) -> "SybilQuery":
        self._flags += ["-op", "hist"]
        return self

    def log_hist(self) -> "SybilQuery":
        self._flags += ["-op", "hist", "-loghist"]
        return self

    def group_by(self, field: str) -> "SybilQuery":
        self._strs.append(field)
        return self

    def distinct(self, field: str) -> "SybilQuery":
        self._flags += ["-distinct", field]
        return self

    def weight_col(self, field: str) -> "SybilQuery":
        self._flags += ["-weight-col", field]
        return self

    def limit(self, limit: int) -> "SybilQuery":
        self._flags += ["-limit", str(limit)]
        return self

    def sort_by(self, col: str) -> "SybilQuery":
        self._flags += ["-sort", col]
        return self

    # filters
    def int_filter_eq(self, field: str, value: int) -> "SybilQuery":
        self._int_filters.append((field, "eq", str(value)))
        return self

    def int_filter_gt(self, field: str, value: int) -> "SybilQuery":
        self._int_filters.append((field, "gt", str(value)))
        return self

    def int_filter_lt(self, field: str, value: int) -> "SybilQuery":
        self._int_filters.append((field, "lt", str(value)))
        return self

    def int_filter_neq(self, field: str, value: int) -> "SybilQuery":
        self._int_filters.append((field, "neq", str(value)))
        return self

    def str_filter_eq(self, field: str, value: str) -> "SybilQuery":
        self._str_filters.append((field, "eq", value))
        return self

    def str_filter_neq(self, field: str, value: str) -> "SybilQuery":
        self._str_filters.append((field, "neq", value))
        return self

    def str_filter_regex(self, field: str, pattern: str) -> "SybilQuery":
        self._str_filters.append((field, "re", pattern))
        return self

    def set_filter_in(self, field: str, value: str) -> "SybilQuery":
        self._set_filters.append((field, "in", value))
        return self

    def set_filter_nin(self, field: str, value: str) -> "SybilQuery":
        self._set_filters.append((field, "nin", value))
        return self

    # execution (api/cmd_query.go:155-217)
    def argv(self) -> list[str]:
        argv = ["query", "-dir", self.config.dir, "-table", self.config.table,
                "-json", "-device", self.config.device]
        if self._read_log:
            argv.append("-read-log")
        argv += self._flags
        argv += ["-field-separator", FIELD_SEPARATOR,
                 "-filter-separator", FILTER_SEPARATOR]
        for flag, filters in [("-str-filter", self._str_filters),
                              ("-int-filter", self._int_filters),
                              ("-set-filter", self._set_filters)]:
            if filters:
                joined = FIELD_SEPARATOR.join(
                    FILTER_SEPARATOR.join(f) for f in filters)
                argv += [flag, joined]
        if self._strs:
            argv += ["-group", FIELD_SEPARATOR.join(self._strs)]
        if self._ints:
            argv += ["-int", FIELD_SEPARATOR.join(self._ints)]
        if self._sets:
            argv += ["-set", FIELD_SEPARATOR.join(self._sets)]
        return argv

    def execute(self):
        """-> list[SybilResult] (dict of bucket->rows for time series)."""
        if self.table.subprocess_mode:
            out = _run_cli(self.argv())
        else:
            out = _run_inprocess(self.argv())
        data = json.loads(out)
        if isinstance(data, dict):        # time-series shape
            return {k: [SybilResult(r) for r in v] for k, v in data.items()}
        return [SybilResult(r) for r in data]


def _run_cli(argv: list[str], stdin: str = "") -> str:
    proc = subprocess.run(
        [sys.executable, "-m", "sybil_tpu_torch", *argv],
        input=stdin.encode(), capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"sybil_tpu_torch {argv[0]} failed: "
            f"{proc.stderr.decode()[-2000:]}")
    return proc.stdout.decode()


def _run_inprocess(argv: list[str]) -> str:
    """The port's CLI in this process: the kernels it built and the
    columns it keeps resident on the device serve the next query too.  A
    non-zero exit (a missing card among them) raises; nothing falls back
    to the CPU."""
    import contextlib
    import io

    from . import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc not in (0, None):
        raise RuntimeError(f"query failed with exit code {rc}")
    return buf.getvalue()
