"""`inspect`: try-decode any on-disk artifact and dump it
(reference: src/cmd/cmd_inspect.go:9-99 tries table info / block info /
SRB / column gobs in turn)."""

from __future__ import annotations

import gzip
import json
import os

import numpy as np

from . import codec
from .rowstore import read_log


def inspect_file(path: str) -> None:
    name = os.path.basename(path)
    # 1. JSON (table info / block info)
    try:
        data = codec.read_json(path)
        print(f"# {name}: json")
        print(json.dumps(data, indent=2, sort_keys=True)[:4000])
        return
    except (ValueError, FileNotFoundError, UnicodeDecodeError):
        pass
    # 2. WAL log
    if ".wal" in name:
        try:
            records = read_log(path)
            print(f"# {name}: row-store log, {len(records)} records")
            for rec in records[:10]:
                print(json.dumps(rec, sort_keys=True))
            return
        except (OSError, ValueError):
            pass
    # 3. container (column / dict)
    try:
        c = codec.read_container(path)
        print(f"# {name}: container meta={json.dumps(c.meta, sort_keys=True)}")
        for sec in c.section_names():
            arr = c.read(sec)
            head = np.array2string(arr.reshape(-1)[:16])
            print(f"  section {sec}: dtype={arr.dtype} shape={arr.shape} "
                  f"head={head}")
        return
    except (ValueError, FileNotFoundError):
        pass
    print(f"# {name}: unrecognized format")
