"""CLI of the port (reference: sybil_tpu/cli.py, main.go:14-24).

    python -m sybil_tpu_torch <ingest|digest|query|trim|index|rebuild|
                               inspect|aggregate|version> [flags]

`ingest` appends records to the row store (the WAL) and, without
`-skip-compact`, digests them into blocks; `digest` collates the WAL
into blocks.  `query` takes the reference's flags plus `-device` (cuda
by default, cpu for the plain PyTorch versions of the kernels); with
`-read-log` it also scans the undigested WAL, `-update-info` re-derives
the table's int stats, `-export` writes every block to TSV before the
query.  `trim` lists (or deletes) the blocks past a size or age limit,
`index` re-derives the table's and the blocks' stats, `rebuild`
reconstructs a lost table info from the blocks, `inspect` dumps any
file of a table.  `aggregate` merges per-node `query -encode-results`
outputs on the host.  Only `query` reads the device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from . import constants, debug as dbg
from .config import Flags
from .table import Table, list_tables


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("-dir", "--dir", default="./db/")
    p.add_argument("-table", "--table", default="")
    p.add_argument("-debug", "--debug", action="store_true")
    # -profile captures a torch.profiler device/host trace
    p.add_argument("-profile", "--profile", action="store_true")
    p.add_argument("-profile-dir", "--profile-dir", default="./profile")


def _base_flags(args) -> Flags:
    flags = Flags(dir=args.dir, table=args.table, debug=args.debug,
                  profile=getattr(args, "profile", False),
                  profile_dir=getattr(args, "profile_dir", "./profile"))
    if args.debug:
        dbg.DEBUG_FLAG = True
    return flags


# ---------------------------------------------------------------------------
def cmd_ingest(argv):
    p = argparse.ArgumentParser(prog="ingest")
    _add_common(p)
    p.add_argument("-ints", "--ints", default="",
                   help="columns to treat as ints (comma delimited)")
    p.add_argument("-csv", "--csv", action="store_true")
    p.add_argument("-exclude", "--exclude", default="")
    p.add_argument("-path", "--path", default="$",
                   help="path to JSON record, ex: $.foo.bar")
    p.add_argument("-skip-compact", "--skip-compact", action="store_true")
    p.add_argument("-infile", "--infile", default="")
    p.add_argument("-timestamps", "--timestamps", default="")
    p.add_argument("-timestamp-format", "--timestamp-format", default="")
    # reference-CLI compatibility no-ops: the row store always uses the
    # single WAL format here (cmd_ingest.go save-srb), and time-col only
    # affects digestion ordering which reads the table flag
    p.add_argument("-save-srb", "--save-srb", action="store_true")
    p.add_argument("-time-col", "--time-col", default="time")
    args = p.parse_args(argv)
    flags = _base_flags(args)
    flags.skip_compact = args.skip_compact
    if not flags.table:
        p.print_help()
        return 1

    from .ingest import parse_csv, parse_json_lines

    stream = open(args.infile) if args.infile else sys.stdin
    t = Table(flags.table, flags)
    if args.csv:
        parsed = parse_csv(stream, flags)
    else:
        parsed = parse_json_lines(
            stream, flags,
            excludes=frozenset(x for x in args.exclude.split(",") if x),
            int_casts=frozenset(x for x in args.ints.split(",") if x),
            timestamps=frozenset(x for x in args.timestamps.split(",") if x),
            timestamp_format=args.timestamp_format,
            json_path=args.path)
    # stream in CHUNK_SIZE batches: constant memory on arbitrarily large
    # pipes (the reference flushes every CHUNK_SIZE records too,
    # cmd_ingest.go:188-226 -> ChunkAndSave table_io.go:376)
    total, chunk = 0, []
    for rec in parsed:
        chunk.append(rec)
        if len(chunk) >= constants.CHUNK_SIZE:
            t.ingest_records(chunk)
            total += len(chunk)
            chunk = []
    if chunk:
        t.ingest_records(chunk)
        total += len(chunk)
    dbg.debug("ingested", total, "records into", flags.table)
    return 0


def cmd_digest(argv):
    p = argparse.ArgumentParser(prog="digest")
    _add_common(p)
    args = p.parse_args(argv)
    flags = _base_flags(args)
    if not flags.table:
        p.print_help()
        return 1
    from .digest import digest_records
    from .profiler import device_trace
    t = Table(flags.table, flags)
    with device_trace(flags.profile_dir if flags.profile else None):
        digest_records(t)
    return 0


# ---------------------------------------------------------------------------
def _query_parser():
    p = argparse.ArgumentParser(prog="query")
    _add_common(p)
    p.add_argument("-op", "--op", default="avg")
    p.add_argument("-tables", "--tables", action="store_true")
    p.add_argument("-info", "--info", action="store_true")
    p.add_argument("-limit", "--limit", type=int, default=100)
    p.add_argument("-print", "--print", dest="print_", action="store_true",
                   default=True)
    p.add_argument("-samples", "--samples", action="store_true")
    p.add_argument("-export", "--export", action="store_true",
                   help="export scanned data to db/TABLE/export/*.tsv.gz")
    p.add_argument("-json", "--json", action="store_true")
    p.add_argument("-sort", "--sort", default="$COUNT")
    p.add_argument("-sort-asc", "--sort-asc", action="store_true")
    p.add_argument("-prune-sort", "--prune-sort", default="$COUNT")
    p.add_argument("-time", "--time", action="store_true")
    p.add_argument("-time-col", "--time-col", default="time")
    p.add_argument("-time-bucket", "--time-bucket", type=int, default=3600)
    p.add_argument("-weight-col", "--weight-col", default="")
    p.add_argument("-loghist", "--loghist", action="store_true")
    p.add_argument("-tdigest", "--tdigest", action="store_true")
    p.add_argument("-encode-results", "--encode-results", action="store_true")
    p.add_argument("-encode-flags", "--encode-flags", action="store_true")
    p.add_argument("-decode-flags", "--decode-flags", action="store_true")
    p.add_argument("-int-filter", "--int-filter", default="")
    p.add_argument("-int-bucket", "--int-bucket", type=int, default=0)
    p.add_argument("-str-replace", "--str-replace", default="")
    p.add_argument("-str-filter", "--str-filter", default="")
    p.add_argument("-set-filter", "--set-filter", default="")
    p.add_argument("-update-info", "--update-info", action="store_true")
    p.add_argument("-int", "--int", dest="ints", default="")
    p.add_argument("-str", "--str", dest="strs", default="")
    p.add_argument("-set", "--set", dest="sets", default="")
    p.add_argument("-sample-cols", "--sample-cols", default="")
    p.add_argument("-group", "--group", default="")
    p.add_argument("-distinct", "--distinct", default="")
    p.add_argument("-distinct-limit", "--distinct-limit", type=int, default=-1)
    p.add_argument("-read-log", "--read-log", action="store_true")
    p.add_argument("-cache-queries", "--cache-queries", action="store_true")
    # accepted for reference-CLI compatibility; no-ops here: slab
    # recycling and key-table shortening are obviated by the HBM
    # residency cache and columnar loads (cmd_query.go:62,99,102)
    p.add_argument("-recycle-mem", "--recycle-mem", action="store_true",
                   default=True)
    p.add_argument("-fast-recycle", "--fast-recycle", action="store_true")
    p.add_argument("-shorten-key-table", "--shorten-key-table",
                   action="store_true")
    p.add_argument("-device-batch", "--device-batch", type=int, default=16)
    p.add_argument("-data-shards", "--data-shards", type=int, default=0,
                   help="shard the scan over an N-device mesh")
    # multi-process: join N processes into one mesh (parallel/
    # multihost.py); the alternative to shipping encode-flags/
    # encode-results blobs between independent binaries
    p.add_argument("-dist-coordinator", "--dist-coordinator", default="",
                   help="host:port of process 0 (joins a torch.distributed "
                   "process group)")
    p.add_argument("-dist-pid", "--dist-pid", type=int, default=-1)
    p.add_argument("-dist-nproc", "--dist-nproc", type=int, default=0)
    # multi-value flag separators, overridable so values may contain
    # commas/colons (the Go client API passes ASCII 30/31,
    # api/cmd_query.go:15-16,163-164)
    p.add_argument("-field-separator", "--field-separator", default=",")
    p.add_argument("-filter-separator", "--filter-separator", default=":")
    # the port's counterpart of JAX_PLATFORMS: "cuda" runs the kernels,
    # "cpu" their plain PyTorch versions
    p.add_argument("-device", "--device", default="cuda",
                   help="torch device of the scan: cuda (default) or cpu")
    return p


def _flags_from_query_args(args) -> Flags:
    flags = _base_flags(args)
    flags.op = args.op
    flags.list_tables = args.tables
    flags.print_info = args.info
    flags.limit = args.limit
    flags.samples = args.samples
    flags.export = args.export
    flags.json = args.json
    flags.sort = args.sort
    flags.sort_asc = args.sort_asc
    flags.prune_by = args.prune_sort
    flags.time = args.time
    flags.time_col = args.time_col
    flags.time_bucket = args.time_bucket
    flags.weight_col = args.weight_col
    flags.log_hist = args.loghist
    flags.tdigest = args.tdigest
    flags.encode_results = args.encode_results
    flags.encode_flags = args.encode_flags
    flags.decode_flags = args.decode_flags
    flags.int_filters = args.int_filter
    flags.hist_bucket = args.int_bucket
    flags.str_replace = args.str_replace
    flags.str_filters = args.str_filter
    flags.set_filters = args.set_filter
    flags.update_table_info = args.update_info
    flags.ints = args.ints
    flags.strs = args.strs
    flags.sets = args.sets
    flags.sample_cols = args.sample_cols
    flags.groups = args.group
    flags.distinct = args.distinct
    flags.num_distinct = args.distinct_limit
    flags.read_log = args.read_log
    flags.cache_queries = args.cache_queries
    flags.device_batch = args.device_batch
    flags.data_shards = args.data_shards
    flags.dist_coordinator = args.dist_coordinator
    flags.dist_process_id = args.dist_pid
    flags.dist_num_processes = args.dist_nproc
    flags.field_separator = args.field_separator
    flags.filter_separator = args.filter_separator
    flags.device = args.device
    return flags


def cmd_query(argv):
    args = _query_parser().parse_args(argv)
    flags = _flags_from_query_args(args)
    return run_query_flags(flags)


def run_query_flags(flags: Flags) -> int:
    from . import printer
    from .query.spec import QueryParams

    if flags.decode_flags:
        # query arrives serialized on stdin (node protocol, config.go:185);
        # non-zero fields overlay the command line, like gob decode-into
        flags = flags.merge_decoded(sys.stdin.read())
        flags.decode_flags = False

    if flags.encode_flags:
        f = Flags(**{**vars(flags)})
        f.encode_flags = False
        print(f.encode())
        return 0

    if flags.list_tables:
        printer.print_tables(list_tables(flags), flags)
        return 0

    if not flags.table:
        _query_parser().print_help()
        return 1

    t = Table(flags.table, flags)
    if not t.exists():
        dbg.error(flags.table, "table can not be loaded or does not exist in",
                  flags.dir)

    if flags.print_info:
        t.load_info()
        printer.print_table_info(t.table_info(), flags)
        return 0

    if flags.update_table_info:
        from .recover import update_table_info
        # the table's info first, as `index` loads it: without it the
        # stats are rewritten from an empty schema
        t.load_info()
        update_table_info(t)
        return 0

    if flags.export:
        # query -export dumps block data to TSV (cmd_query.go:346,371)
        from .export import export_table
        t.load_info()
        export_table(t, flags)
        print("EXPORTED RECORDS TO", os.path.join(t.dir, "export"))

    from .profiler import device_trace
    from .query.engine import run_query
    params = QueryParams.from_flags(flags)
    with device_trace(flags.profile_dir if flags.profile else None):
        qr = run_query(t, params, flags)

    from .parallel import multihost
    # every process of a multi-process mesh holds the same merged result;
    # only process 0 talks to stdout
    if multihost.is_printer():
        if flags.samples:
            printer.print_samples(qr.samples, params, flags)
        else:
            printer.print_results(qr, params, flags)
    multihost.shutdown()
    return 0


# ---------------------------------------------------------------------------
def cmd_trim(argv):
    p = argparse.ArgumentParser(prog="trim")
    _add_common(p)
    p.add_argument("-mb", "--mb", type=int, default=0,
                   help="size limit in MB")
    p.add_argument("-before", "--before", type=int, default=0,
                   help="delete blocks older than this timestamp")
    p.add_argument("-delete", "--delete", action="store_true")
    p.add_argument("-really", "--really", action="store_true")
    p.add_argument("-time-col", "--time-col", default="time")
    args = p.parse_args(argv)
    flags = _base_flags(args)
    flags.time_col = args.time_col
    from .trim import trim_table
    t = Table(flags.table, flags)
    t.load_info()
    to_trim = trim_table(t, mb_limit=args.mb, delete_before=args.before)
    for bdir in to_trim:
        if args.delete and args.really:
            shutil.rmtree(bdir, ignore_errors=True)
            print("deleted", bdir)
        else:
            print(bdir)
    return 0


def cmd_index(argv):
    p = argparse.ArgumentParser(prog="index")
    _add_common(p)
    args = p.parse_args(argv)
    flags = _base_flags(args)
    from .recover import update_table_info
    t = Table(flags.table, flags)
    t.load_info()
    update_table_info(t)
    return 0


def cmd_rebuild(argv):
    p = argparse.ArgumentParser(prog="rebuild")
    _add_common(p)
    p.add_argument("-replace", "--replace", action="store_true")
    p.add_argument("-force", "--force", action="store_true")
    args = p.parse_args(argv)
    flags = _base_flags(args)
    from .recover import rebuild_table_info
    t = Table(flags.table, flags)
    rebuild_table_info(t, replace=args.replace, force=args.force)
    return 0


def cmd_inspect(argv):
    p = argparse.ArgumentParser(prog="inspect")
    p.add_argument("-file", "--file", default="")
    p.add_argument("files", nargs="*")
    args = p.parse_args(argv)
    from .inspect_cmd import inspect_file
    for fname in ([args.file] if args.file else []) + args.files:
        inspect_file(fname)
    return 0


def cmd_version(argv):
    p = argparse.ArgumentParser(prog="version")
    p.add_argument("-json", "--json", action="store_true")
    args = p.parse_args(argv)
    info = {
        "version": constants.VERSION,
        "engine": "torch-cuda",
        "features": {"dense-group-by": True, "device-decode-bucket2": True},
    }
    if args.json:
        print(json.dumps(info, sort_keys=True))
    else:
        for k, v in info.items():
            print(k, ":", v)
    return 0


def cmd_aggregate(argv):
    """Merge per-node -encode-results files from directories (the node
    protocol's master side, node_aggregator.go).  Host work only: no
    device is read or needed."""
    p = _query_parser()
    p.add_argument("dirs", nargs="*")
    args = p.parse_args(argv)
    flags = _flags_from_query_args(args)
    stdin_flags = sys.stdin.read().strip() if not sys.stdin.isatty() else ""
    if stdin_flags:
        flags = Flags.decode(stdin_flags)
        flags.encode_flags = False
    from .parallel.aggregator import stitch_results
    from .query.spec import QueryParams
    params = QueryParams.from_flags(flags)
    stitch_results(args.dirs, params, flags)
    return 0


COMMANDS = {
    "ingest": cmd_ingest,
    "digest": cmd_digest,
    "query": cmd_query,
    "trim": cmd_trim,
    "index": cmd_index,
    "rebuild": cmd_rebuild,
    "inspect": cmd_inspect,
    "aggregate": cmd_aggregate,
    "version": cmd_version,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: sybil_tpu_torch <%s>" % "|".join(sorted(COMMANDS)),
              file=sys.stderr)
        return 1
    from .ops.kernels import DeviceUnavailable
    try:
        return COMMANDS[argv[0]](argv[1:]) or 0
    except dbg.SybilError:
        # already logged by dbg.error; die with a clean one-line fatal
        # like the reference's Error = log.Fatalln (debug.go:26-27)
        return 1
    except DeviceUnavailable as e:
        print("ERROR:", e, file=sys.stderr)
        return 1
    except NotImplementedError as e:
        print("ERROR:", e, file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
