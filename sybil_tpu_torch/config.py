"""Query/engine configuration.

The reference keeps one global gob-encodable FlagDefs struct that doubles as
the distributed-query wire format (src/lib/config.go:30-100,178-192).  Here
the equivalent is a dataclass serialized as JSON for the `encode-flags` /
`decode-flags` node protocol; there is no global — a Flags instance threads
through the engine explicitly.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class Flags:
    # storage
    dir: str = "./db/"
    table: str = ""

    # query shape
    op: str = "avg"                  # avg | hist | distinct
    ints: str = ""                   # comma lists (FIELD_SEPARATOR)
    strs: str = ""
    sets: str = ""
    groups: str = ""
    distinct: str = ""
    int_filters: str = ""            # col:op:val , ...
    str_filters: str = ""
    set_filters: str = ""
    str_replace: str = ""            # col:find:replace
    sort: str = "$COUNT"
    sort_asc: bool = False
    prune_by: str = "$COUNT"
    limit: int = 100
    num_distinct: int = -1

    # time series
    time: bool = False
    time_col: str = "time"
    time_bucket: int = 60 * 60

    # histograms
    log_hist: bool = False
    tdigest: bool = False            # -op hist via t-digest (hist_tdigest.go)
    hist_bucket: int = 0             # -int-bucket override

    weight_col: str = ""

    # output
    json: bool = False
    print_: bool = True
    print_info: bool = False
    list_tables: bool = False
    samples: bool = False
    sample_cols: str = ""
    export: bool = False
    encode_results: bool = False
    encode_flags: bool = False
    decode_flags: bool = False

    # engine behavior
    read_log: bool = False
    skip_compact: bool = False
    cache_queries: bool = False
    cache_block_infos: bool = True   # batched block-info cache (table_io.go:242)
    skip_outliers: bool = True
    update_table_info: bool = False
    debug: bool = False
    profile: bool = False            # torch.profiler trace capture
    profile_dir: str = "./profile"

    field_separator: str = ","
    filter_separator: str = ":"

    # TPU execution knobs (no reference equivalent)
    device_batch: int = 16           # blocks scanned per device dispatch
    max_groups: int = 0              # 0 -> INTERNAL_RESULT_LIMIT
    platform: str = ""               # force jax platform ("cpu" for tests)
    data_shards: int = 0             # >1: shard the scan over a device mesh
    force_sorted: bool = False       # disable the dense MXU group-by path
    # multi-process runtime (parallel/multihost.py): join N processes
    # into one mesh via torch.distributed; 0/-1/"" = single process
    dist_coordinator: str = ""       # "host:port" of process 0
    dist_process_id: int = -1
    dist_num_processes: int = 0
    # torch device the scan runs on: "cuda" (the kernels) or "cpu" (their
    # plain PyTorch versions); never chosen automatically
    device: str = "cuda"

    def encode(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def decode(cls, payload: str) -> "Flags":
        data = json.loads(payload)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def merge_decoded(self, payload: str) -> "Flags":
        """Overlay serialized flags onto this instance, skipping zero
        values.  Mirrors the reference's gob decode-into-FLAGS
        (config.go:185-192): gob omits zero fields, so command-line flags
        like -encode-results survive an incoming query broadcast."""
        data = json.loads(payload)
        known = {f.name for f in dataclasses.fields(self)}
        # per-process runtime identity never travels with a query
        skip = {"dist_coordinator", "dist_process_id", "dist_num_processes"}
        merged = dataclasses.replace(self)
        for k, v in data.items():
            if k in known and k not in skip and v not in (False, 0, 0.0, ""):
                setattr(merged, k, v)
        return merged

    def split_list(self, value: str) -> list[str]:
        if not value:
            return []
        return value.split(self.field_separator)
