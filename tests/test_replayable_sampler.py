"""ReplayableSampler (reference bidir/rsampler.h): rewind + exact replay,
clone independence, stream serialization."""
import jax.numpy as jnp
import numpy as np

from mitsuba_jax.core.streams import InstanceManager, MemoryStream
from mitsuba_jax.render.sampler import ReplayableSampler


def _mk(seed=3, n=64, offset=0):
    return ReplayableSampler(seed, jnp.arange(n), jnp.zeros(n, jnp.int32),
                             offset=offset)


def test_rewind_replays_exactly():
    s = _mk()
    a1 = np.asarray(s.next_1d())
    mark = s.sample_index
    b1 = np.asarray(s.next_2d())
    c1 = np.asarray(s.next_1d())
    s.set_sample_index(mark)        # rewind
    b2 = np.asarray(s.next_2d())
    c2 = np.asarray(s.next_1d())
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(c1, c2)
    # and a full reset replays from the start
    s.set_sample_index(0)
    np.testing.assert_array_equal(np.asarray(s.next_1d()), a1)


def test_clone_is_independent_but_alignable():
    s = _mk(seed=3)
    c = s.clone(seed=99)
    a = np.asarray(s.next_1d())
    b = np.asarray(c.next_1d())
    assert not np.allclose(a, b)            # different seed, new stream
    # same seed clone reproduces the original exactly
    c2 = s.clone(seed=3)
    c2.set_sample_index(0)
    s.set_sample_index(0)
    np.testing.assert_array_equal(np.asarray(s.next_2d()),
                                  np.asarray(c2.next_2d()))


def test_stream_roundtrip_resumes_midstream():
    s = _mk(seed=7)
    _ = s.next_2d()
    _ = s.next_1d()
    ms = MemoryStream()
    InstanceManager().put(ms, s)
    expected = np.asarray(s.next_2d())      # next draw after the snapshot
    ms.seek(0)
    s2 = InstanceManager().get(ms)
    assert isinstance(s2, ReplayableSampler)
    assert s2.sample_index == 2     # two draws = two dimensions
    np.testing.assert_array_equal(np.asarray(s2.next_2d()), expected)
