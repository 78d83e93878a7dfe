"""Logging helpers (reference: src/lib/debug.go).

`debug()` is gated on the config DEBUG flag or the DEBUG env var;
`error()` raises instead of os.Exit so library users can catch it.
"""

import os
import sys
import time

_DEBUG_ENV = bool(os.environ.get("DEBUG"))
DEBUG_FLAG = False


class SybilError(RuntimeError):
    pass


def _emit(*args):
    print(time.strftime("%Y/%m/%d %H:%M:%S"), *args, file=sys.stderr)


def debug(*args):
    if DEBUG_FLAG or _DEBUG_ENV:
        _emit(*args)


def print_(*args):
    _emit(*args)


def warn(*args):
    _emit("WARNING:", *args)


def error(*args):
    _emit("ERROR:", *args)
    raise SybilError(" ".join(str(a) for a in args))
