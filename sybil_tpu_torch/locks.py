"""Advisory pidfile locks with dead-owner recovery.

Mirrors the reference's lock manager (src/lib/table_lock.go): each shared
resource (table info, digestion, per-block, cache) is guarded by a
`<name>.lock` file holding the owner PID.  Grabbing polls with retries;
if the recorded PID is dead, a per-resource `recover()` strategy runs and
the lock is broken (table_lock.go:193-253 liveness probe, :51-143 recovery
strategies).
"""

from __future__ import annotations

import os
import shutil
import time

from . import constants
from .debug import debug, warn

LOCK_TRIES = 50
LOCK_SLEEP_S = 0.003


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)  # signal 0 liveness probe (table_lock.go:229)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class Lock:
    """Base pidfile lock. Subclasses override recover()."""

    def __init__(self, table_dir: str, name: str):
        self.table_dir = table_dir
        self.name = name
        self.path = os.path.join(table_dir, name + ".lock")
        self.broken = False

    def recover(self) -> bool:
        """Called when the owning process is dead.  Returning True means
        the resource was repaired and the lock may be broken."""
        warn("no recovery strategy for lock", self.path)
        return False

    def grab(self) -> bool:
        os.makedirs(self.table_dir, exist_ok=True)
        # The lock file must appear with its PID content atomically: an
        # O_CREAT|O_EXCL create followed by a write leaves a window where
        # a contender reads an empty pidfile, concludes the owner is dead
        # and "recovers" a perfectly healthy lock.  Write the PID to a
        # private temp file and link(2) it into place instead.
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(str(os.getpid()))
        try:
            for _ in range(LOCK_TRIES):
                try:
                    os.link(tmp, self.path)
                    return True
                except FileExistsError:
                    if self._try_break():
                        continue
                    time.sleep(LOCK_SLEEP_S)
            return False
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass

    def _try_break(self) -> bool:
        try:
            with open(self.path) as f:
                raw = f.read().strip()
        except FileNotFoundError:
            # owner released between our link() attempt and this read:
            # nothing to recover, retry the grab immediately
            return True
        except OSError:
            return False
        try:
            # grab() links the pidfile into place with its content already
            # written, so empty/garbage content means real corruption
            pid = int(raw) if raw else 0
        except ValueError:
            pid = 0
        if pid == os.getpid():
            return False
        if not _pid_alive(pid):
            debug("lock owner", pid, "is dead; recovering", self.path)
            if self.recover():
                self.broken = True
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass
                return True
        return False

    def release(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def __enter__(self):
        if not self.grab():
            from .debug import error
            error("could not grab lock", self.path)
        return self

    def __exit__(self, *exc):
        self.release()


class InfoLock(Lock):
    """Guards info.json; recovery restores from the .bak checkpoint
    (table_lock.go:51-76)."""

    def __init__(self, table_dir: str):
        super().__init__(table_dir, "info")

    def recover(self) -> bool:
        info = os.path.join(self.table_dir, "info.json")
        bak = info + ".bak"
        if os.path.exists(bak):
            # restore atomically: a plain copy truncates info.json under
            # concurrent readers
            tmp = f"{info}.{os.getpid()}.restore"
            shutil.copy(bak, tmp)
            os.rename(tmp, info)
            return True
        # nothing to restore; breaking the lock is still safe because the
        # writer publishes atomically (temp+rename)
        return True


class DigestLock(Lock):
    """Guards digestion; recovery moves orphaned stomache logs back into
    ingest/ so no ingested record is lost (table_lock.go:78-91)."""

    def __init__(self, table_dir: str):
        super().__init__(table_dir, "digest")

    def recover(self) -> bool:
        ingest = os.path.join(self.table_dir, constants.INGEST_DIR)
        os.makedirs(ingest, exist_ok=True)
        for entry in os.listdir(self.table_dir):
            if entry.startswith(constants.STOMACHE_DIR):
                stomache = os.path.join(self.table_dir, entry)
                for fn in os.listdir(stomache):
                    try:
                        os.rename(os.path.join(stomache, fn),
                                  os.path.join(ingest, fn))
                    except OSError:
                        pass
                try:
                    os.rmdir(stomache)
                except OSError:
                    pass
        return True


class BlockLock(Lock):
    """Guards one block dir; recovery demotes a half-written block
    (`.partial` cleanup, table_lock.go:93-109)."""

    def __init__(self, table_dir: str, block_name: str):
        super().__init__(table_dir, block_name)
        self.block_name = block_name

    def recover(self) -> bool:
        block_dir = os.path.join(self.table_dir, self.block_name)
        partial = block_dir + ".partial"
        if os.path.exists(partial):
            shutil.rmtree(partial, ignore_errors=True)
        if os.path.exists(block_dir) and not os.path.exists(
                os.path.join(block_dir, "info.json")):
            os.rename(block_dir, block_dir + ".broke")
        return True


class CacheLock(Lock):
    """Guards the block-info cache; recovery deletes corrupt cache files
    (table_lock.go:111-143)."""

    def __init__(self, table_dir: str):
        super().__init__(table_dir, "cache")

    def recover(self) -> bool:
        cache_dir = os.path.join(self.table_dir, constants.CACHE_DIR)
        if os.path.exists(cache_dir):
            shutil.rmtree(cache_dir, ignore_errors=True)
        return True
