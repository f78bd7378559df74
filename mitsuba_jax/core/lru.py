"""Bounded LRU cache (reference include/mitsuba/core/lrucache.h).

The reference uses it to keep a working set of volume bricks resident
(volcache.cpp); here the render-path analog is host-side asset caching —
io.bitmap.read_image_cached keeps decoded textures for scenes that
reference the same file from many materials. Device-side caching is n/a
on the device (tables live in device memory for the render's lifetime)."""
from __future__ import annotations

from collections import OrderedDict


class LRUCache:
    """capacity-bounded key->value map with least-recently-used eviction.

    get/put are O(1). An optional `loader` turns the cache into a
    read-through cache (reference lrucache.h's generator functor), and
    an optional `on_evict` hook mirrors its cleanup callback."""

    def __init__(self, capacity: int, loader=None, on_evict=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._loader = loader
        self._on_evict = on_evict
        self._map: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._map)

    def __contains__(self, key):
        return key in self._map

    def get(self, key, default=None):
        if key in self._map:
            self._map.move_to_end(key)
            self.hits += 1
            return self._map[key]
        self.misses += 1
        if self._loader is not None:
            value = self._loader(key)
            self.put(key, value)
            return value
        return default

    def put(self, key, value) -> None:
        if key in self._map:
            self._map.move_to_end(key)
        self._map[key] = value
        while len(self._map) > self.capacity:
            k, v = self._map.popitem(last=False)
            if self._on_evict is not None:
                self._on_evict(k, v)

    def clear(self) -> None:
        self._map.clear()
        self.hits = self.misses = 0
