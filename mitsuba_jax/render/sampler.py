"""Counter-based sample generation.

Replaces the reference's stateful per-core sampler clones
(include/mitsuba/render/sampler.h:70 clone(), "manifold resources"
sched.h:375) with pure counter-based streams: every random number is
`uniform(fold_in(fold_in(seed, lane_id), dim))`.  Results are bitwise
identical for any device count or sharding layout — the property the
reference could not offer across its farm.

The wavefront `Sampler` carries a per-lane key array and a *Python-side*
dimension counter, so each `next_*` call during tracing derives a fresh,
deterministic dimension — the analog of the reference samplers' sequential
dimension consumption.

Sample *patterns* (independent / stratified / low-discrepancy 0,2-sequence /
halton / hammersley — reference src/samplers/) are implemented as pixel-
sample position generators in `sample_position`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mitsuba_jax.core.registry import register_plugin


class Sampler:
    """Per-lane deterministic random stream. Not a pytree — create inside jit."""

    def __init__(self, seed, lane_ids, sample_ids, offset: int = 0):
        """lane_ids: (N,) pixel/lane index; sample_ids: (N,) spp index."""
        base = jax.random.key(seed) if jnp.isscalar(seed) or jnp.ndim(seed) == 0 else seed
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, lane_ids)
        self._keys = jax.vmap(jax.random.fold_in)(keys, sample_ids)
        self._dim = offset

    def _next_key(self):
        self._dim += 1
        return jax.vmap(jax.random.fold_in, (0, None))(self._keys, self._dim)

    def next_1d(self):
        return jax.vmap(lambda k: jax.random.uniform(k, ()))(self._next_key())

    def next_2d(self):
        return jax.vmap(lambda k: jax.random.uniform(k, (2,)))(self._next_key())

    def next_stacked_1d(self, d: int):
        """(d, N) uniforms consuming d dimensions — one fused draw, so scan
        bodies stay small (op-count matters: see integrators/path.py)."""
        dims = jnp.arange(self._dim + 1, self._dim + 1 + d)
        self._dim += d
        keys = jax.vmap(
            lambda dim: jax.vmap(jax.random.fold_in, (0, None))(self._keys, dim)
        )(dims)
        return jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, ())))(keys)

    def next_stacked_2d(self, d: int):
        dims = jnp.arange(self._dim + 1, self._dim + 1 + d)
        self._dim += d
        keys = jax.vmap(
            lambda dim: jax.vmap(jax.random.fold_in, (0, None))(self._keys, dim)
        )(dims)
        return jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (2,))))(keys)


from mitsuba_jax.core.streams import Serializable as _Serializable


class ReplayableSampler(Sampler, _Serializable):
    """Rewindable sample stream for MLT-style seeding (reference
    bidir/rsampler.h ReplayableSampler): query the current sample index,
    later rewind to it and REPLAY the exact same numbers — the
    reference regenerates the whole MT19937 sequence to rewind
    (rsampler.h:30 "naive"); counter-based streams rewind in O(1) by
    resetting the dimension counter."""

    @property
    def sample_index(self) -> int:
        """Current position in the stream (rsampler.h getSampleIndex)."""
        return self._dim

    def set_sample_index(self, index: int) -> None:
        """Rewind (or fast-forward) to an absolute stream position
        (rsampler.h setSampleIndex). O(1): every dimension is derived
        independently from (seed, lane, sample, dim)."""
        self._dim = int(index)

    def clone(self, seed) -> "ReplayableSampler":
        """Statistically independent sampler with identical structure
        (reference Sampler::clone semantics: new seed, same params)."""
        out = ReplayableSampler.__new__(ReplayableSampler)
        base = jax.random.key(seed)
        import jax.numpy as _jnp

        # re-derive per-lane keys from the new seed with the same fold
        # structure; lane/sample ids are recoverable only through the
        # original constructor, so keep a reference to ours
        out._lane_ids = self._lane_ids
        out._sample_ids = self._sample_ids
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, self._lane_ids)
        out._keys = jax.vmap(jax.random.fold_in)(keys, self._sample_ids)
        out._seed = seed
        out._dim = self._dim
        return out

    def __init__(self, seed, lane_ids, sample_ids, offset: int = 0):
        super().__init__(seed, lane_ids, sample_ids, offset)
        self._seed = seed
        self._lane_ids = lane_ids
        self._sample_ids = sample_ids

    # --- serialization (reference rsampler.h Stream constructor) ---------
    def serialize(self, stream, manager) -> None:
        import numpy as np

        stream.write_i64(int(self._seed))
        stream.write_i64(self._dim)
        stream.write_array(np.asarray(self._lane_ids))
        stream.write_array(np.asarray(self._sample_ids))

    def unserialize_fill(self, stream, manager) -> None:
        import jax.numpy as _jnp

        seed = stream.read_i64()
        dim = stream.read_i64()
        lane_ids = _jnp.asarray(stream.read_array())
        sample_ids = _jnp.asarray(stream.read_array())
        self.__init__(seed, lane_ids, sample_ids, offset=dim)


def _register_replayable():
    from mitsuba_jax.core.streams import register_serializable

    register_serializable(ReplayableSampler)


_register_replayable()


# ---------------------------------------------------------------------------
# Pixel-sample position patterns (the reference's sampler plugins)
# ---------------------------------------------------------------------------

def _radical_inverse(base: int, idx):
    """Van der Corput radical inverse in the given base (vectorized)."""
    inv_base = 1.0 / base
    result = jnp.zeros_like(idx, jnp.float32)
    frac = jnp.float32(inv_base)
    i = idx
    # 32 digits cover idx < base^32; loop is static
    for _ in range(32 if base == 2 else 20):
        digit = i % base
        result = result + digit.astype(jnp.float32) * frac
        i = i // base
        frac = frac * inv_base
    return result


def _sobol_2d(idx):
    """First two dims of the Sobol (0,2)-sequence (reference ldsampler)."""
    x = _radical_inverse(2, idx)
    # Sobol' second dimension via direction numbers (bit magic)
    v = jnp.uint32(1 << 31)
    result = jnp.zeros_like(idx, jnp.uint32)
    i = idx.astype(jnp.uint32)
    for bit in range(32):
        mask = (i >> bit) & 1
        result = result ^ (mask * _SOBOL_DIR[bit])
        _ = v
    y = result.astype(jnp.float32) * (1.0 / 4294967296.0)
    return jnp.stack([x, y], -1)


def _make_sobol_dirs():
    dirs = []
    v = 1 << 31
    for _ in range(32):
        dirs.append(v)
        v ^= v >> 1
    return jnp.asarray(dirs, jnp.uint32)


_SOBOL_DIR = _make_sobol_dirs()


def sample_position(pattern: str, sample_ids, spp: int, rnd_2d):
    """Sub-pixel sample offset in [0,1)^2 for each lane.

    pattern: 'independent' | 'stratified' | 'ldsampler' | 'halton' | 'hammersley'
    sample_ids: (N,) index of the sample within its pixel; rnd_2d: (N,2)
    uniform randoms used for jitter / scrambling (Cranley-Patterson rotation).
    """
    if pattern == "independent":
        return rnd_2d
    if pattern == "stratified":
        res = int(jnp.ceil(jnp.sqrt(spp)))
        sx = (sample_ids % res).astype(jnp.float32)
        sy = ((sample_ids // res) % res).astype(jnp.float32)
        return (jnp.stack([sx, sy], -1) + rnd_2d) / res
    if pattern == "ldsampler":
        p = _sobol_2d(sample_ids)
    elif pattern == "halton":
        p = jnp.stack(
            [_radical_inverse(2, sample_ids), _radical_inverse(3, sample_ids)], -1
        )
    elif pattern == "hammersley":
        p = jnp.stack(
            [
                sample_ids.astype(jnp.float32) / max(spp, 1),
                _radical_inverse(2, sample_ids),
            ],
            -1,
        )
    else:
        raise ValueError(f"unknown sample pattern '{pattern}'")
    # Cranley-Patterson rotation per pixel keeps pixels decorrelated
    return jnp.mod(p + rnd_2d, 1.0)


for _name in ("independent", "stratified", "ldsampler", "halton", "hammersley"):
    register_plugin("sampler", _name)(
        lambda props, _n=_name: {"pattern": _n, "spp": int(props.get("sampleCount", 4))}
    )
