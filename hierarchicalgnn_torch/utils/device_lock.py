"""Single-tenant device lock: serialize the processes that use the card.

Counterpart of ``hierarchicalgnn_tpu/utils/device_lock.py``, plain
``fcntl`` as there.  Two training runs that share one card slow each other
down in ways that look like a slow card; ``acquire()`` takes an exclusive
``flock`` on a per-user path before a process uses the device, and the
kernel releases it when the process exits, so a crashed holder leaves no
stale lock.  The lock file records the holder's pid and argv, so a blocked
process can name what it waits for.

Two differences from the JAX module: the lock lives in the temporary
directory Python resolves (``TMPDIR`` first), and a process that already
holds the lock at a path gets it again at once (``run.main`` may run
several commands in one process; a second ``flock`` on a new descriptor
would wait on the first).  ``run.py`` takes it for a ``cuda`` device;
tests on the CPU never do.
"""

from __future__ import annotations

import fcntl
import json
import os
import sys
import tempfile
import time


def _default_path() -> str:
    return os.path.join(tempfile.gettempdir(), f"hgnn_device.{os.getuid()}.lock")


DEFAULT_PATH = _default_path()

# path -> descriptor: each must stay open for its flock's lifetime
_held: dict[str, int] = {}


def holder_info(path: str = DEFAULT_PATH) -> dict | None:
    """The current holder's record (None if free or unreadable)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def acquire(path: str = DEFAULT_PATH, wait_s: float = 600.0, on_timeout: str = "raise",
            status=None) -> bool:
    """Take the exclusive device lock, waiting up to ``wait_s``.

    Returns True when the lock is held.  On timeout ``on_timeout="raise"``
    raises RuntimeError naming the holder; ``"proceed"`` returns False.
    """
    if path in _held:
        return True
    # O_NOFOLLOW: refuse a planted symlink; 0o600: per-user state
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_NOFOLLOW, 0o600)
    deadline = time.monotonic() + wait_s
    warned = False
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            break
        except OSError:
            if not warned:
                warned = True
                if status:
                    status(f"device lock held by {holder_info(path)}; waiting up to "
                           f"{wait_s:.0f}s")
            if time.monotonic() >= deadline:
                msg = (f"single-tenant device lock {path} still held after {wait_s:.0f}s "
                       f"by {holder_info(path)} -- two processes must not share the card")
                os.close(fd)
                if on_timeout == "proceed":
                    if status:
                        status("WARNING: " + msg + "; proceeding anyway")
                    return False
                raise RuntimeError(msg)
            time.sleep(1.0)
    os.ftruncate(fd, 0)
    os.write(fd, json.dumps({"pid": os.getpid(), "argv": sys.argv[:6],
                             "acquired_unix": int(time.time())}).encode())
    os.fsync(fd)
    _held[path] = fd  # released by the kernel at process exit
    if status:
        status("device lock acquired")
    return True
