"""Runtime thread-confinement guard for the port's expert cache.

`InstrumentedCache` is a drop-in `MultidimensionalCache` that records the
thread calling every metadata *mutator* (the methods annotated
``# owner: main-thread`` in core/cache.py) and raises
`ThreadConfinementError` the moment one runs off the owner thread: the
staging engine's copy threads may stage bytes, never touch the cache's
metadata.  The port's engine tests patch
``repro_torch.core.engine.MultidimensionalCache`` to this class, so every
engine they build runs under the guard.  Overhead is one
`threading.current_thread()` per metadata mutation.

The *owner* is the thread that constructed the cache (the engine builds its
cache on the serving thread).  `mutation_log` keeps the most recent
mutations (bounded) so a failure's context is inspectable.
"""

from __future__ import annotations

import collections
import functools
import threading

from repro_torch.core.cache import MultidimensionalCache

# the cache-metadata mutators confined to the owner thread: keep in sync
# with the `# owner: main-thread` annotations in core/cache.py
GUARDED_METHODS = (
    "new_sequence", "advance_token", "pin", "begin_inflight", "end_inflight",
    "cancel_inflight", "probe", "admit",
)

_LOG_BOUND = 256


class ThreadConfinementError(AssertionError):
    """A cache-metadata mutator ran on a thread other than the owner."""


class InstrumentedCache(MultidimensionalCache):
    """`MultidimensionalCache` that asserts mutator thread confinement."""

    def __init__(self, *args, **kwargs):
        # set before super().__init__ so guarded calls during construction
        # already check
        self._owner_thread = threading.current_thread()
        self.mutation_log = collections.deque(maxlen=_LOG_BOUND)
        super().__init__(*args, **kwargs)

    def _assert_owner(self, method: str):
        t = threading.current_thread()
        self.mutation_log.append((method, t.name))
        if t is not self._owner_thread:
            raise ThreadConfinementError(
                f"MultidimensionalCache.{method}() called on thread "
                f"{t.name!r} but cache metadata is owned by "
                f"{self._owner_thread.name!r} (see the ownership "
                "rule of core/loader.StagingEngine)")


def _guard(name):
    orig = getattr(MultidimensionalCache, name)

    @functools.wraps(orig)
    def wrapper(self, *args, **kwargs):
        self._assert_owner(name)
        return orig(self, *args, **kwargs)

    return wrapper


for _name in GUARDED_METHODS:
    setattr(InstrumentedCache, _name, _guard(_name))
del _name
