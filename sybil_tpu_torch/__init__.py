"""sybil_tpu_torch: the columnar analytics engine on PyTorch and CUDA.

The same storage format, query model and results as `sybil_tpu`, with
the scan's device work in CUDA kernels written by hand for Hopper
(`csrc/`).  The package imports neither `jax` nor `sybil_tpu`: the
device-free modules it needs are its own copies.  Entry points run on
`cuda` unless the caller passes `device="cpu"` (Flags.device), where
every kernel takes its plain PyTorch version instead.
"""

from .config import Flags
from .constants import VERSION
from .table import Table, list_tables

__version__ = VERSION
__all__ = ["Flags", "Table", "list_tables", "VERSION"]
