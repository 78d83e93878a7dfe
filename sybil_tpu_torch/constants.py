"""Engine-wide constants.

These mirror the design constants that bound the reference engine's
behavior (see SURVEY.md §6):

- CHUNK_SIZE:          records per column block  (reference: src/lib/table.go:44)
- CARDINALITY_THRESHOLD: bucket-encode a column when it has fewer distinct
                       values than this            (src/lib/column_store_io.go:18)
- INTERNAL_RESULT_LIMIT: max group-by results per scan (src/lib/aggregate.go:15)
- NUM_BUCKETS:         histogram buckets            (src/lib/hist.go:3)
- GROUP_DELIMITER:     display group-key joiner     (src/lib/aggregate.go:30)
- MISSING_VALUE:       null sentinel in group keys  (src/lib/aggregate.go:31)
"""

CHUNK_SIZE = 65536
CARDINALITY_THRESHOLD = 5000
INTERNAL_RESULT_LIMIT = 100000
NUM_BUCKETS = 1000
GROUP_DELIMITER = "\t"
MISSING_VALUE = 2**64 - 1  # uint64 max

# column type tags (reference: src/lib/record.go:14-19)
NO_VAL = 0
INT_VAL = 1
STR_VAL = 2
SET_VAL = 3

TYPE_NAMES = {NO_VAL: "none", INT_VAL: "int", STR_VAL: "str", SET_VAL: "set"}

# table-level online stats (reference: src/lib/table_column_info.go:72-73)
STD_CUTOFF = 1000.0
MIN_CUTOFF = 5
TOP_STRING_COUNT = 20

# ingestion auto-digest thresholds (reference: src/lib/table_ingest.go:77-79)
FILE_DIGEST_THRESHOLD = 256
SIZE_DIGEST_THRESHOLD = 1024 * 1024 * 2

# histogram outlier discard rule (reference: src/lib/hist_basic.go:104)
HIST_OUTLIER_FACTOR = 10

# sort column sentinel (reference: src/lib/aggregate.go:21)
SORT_COUNT = "$COUNT"

# on-disk names
INGEST_DIR = "ingest"
TEMP_INGEST_DIR = ".ingest.temp"
STOMACHE_DIR = "stomache"
CACHE_DIR = "cache"
BLOCK_PREFIX = "block"
DICT_DIR = "dicts"

VERSION = "0.1.0"
BLOCK_VERSION = 1
