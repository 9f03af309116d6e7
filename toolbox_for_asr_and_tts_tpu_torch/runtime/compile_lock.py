"""Process-wide serialization of program builds.

Own copy of the reference's `runtime/compile_lock.py`. There it serializes
XLA compiles, which were not robust under thread concurrency. In the port a
build is a CUDA graph capture (`runtime/graphs.py`): the eager warm-up runs
on a side stream, the capture, and the graph's memory pool. Two captures at
once would interleave two threads' allocations in one capture window, so
every capture takes this single re-entrant lock. Builds are rare (once per
new shape bucket) and happen at start-up, so the lock costs nothing in
steady state.

Use::

    from ..runtime.compile_lock import COMPILE_LOCK
    with COMPILE_LOCK:
        ...   # capture the program
"""
import threading

COMPILE_LOCK = threading.RLock()
