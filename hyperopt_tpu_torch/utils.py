"""General utilities (counterpart of ``hyperopt_tpu/utils.py``): the
bounded cache the suggesters keep their per-space proposal steps in,
and the reference's timestamp helper."""

from __future__ import annotations

import datetime
import threading

__all__ = ["LRUCache", "coarse_utcnow"]

_LRU_MISS = object()


def coarse_utcnow():
    """Timestamp truncated to ms (hyperopt/utils.py sym: coarse_utcnow)."""
    now = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
    return now.replace(microsecond=(now.microsecond // 1000) * 1000)


class LRUCache:
    """Bounded most-recently-used mapping; thread-safe.  ``hits`` and
    ``misses`` count :meth:`get` outcomes."""

    def __init__(self, maxsize):
        self.maxsize = int(maxsize)
        if self.maxsize < 1:
            raise ValueError(f"LRUCache maxsize must be >= 1, got {maxsize}")
        self._d = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        with self._lock:
            v = self._d.pop(key, _LRU_MISS)
            if v is _LRU_MISS:
                self.misses += 1
                return default
            self.hits += 1
            self._d[key] = v  # re-insert: most recently used at the end
            return v

    def put(self, key, value):
        with self._lock:
            self._d.pop(key, None)
            while len(self._d) >= self.maxsize:
                self._d.pop(next(iter(self._d)))
            self._d[key] = value

    def contains(self, key):
        """Membership without counting a hit or a miss or touching recency."""
        with self._lock:
            return key in self._d

    def stats(self):
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "size": len(self._d), "maxsize": self.maxsize}
