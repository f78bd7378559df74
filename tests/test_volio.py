"""VOL grid format + XML medium parsing."""
import numpy as np
import jax.numpy as jnp

from mitsuba_jax.io.volio import (
    grid_world_to_index_transform, load_vol, save_vol,
)
from mitsuba_jax.io.xml import load_scene_string
from mitsuba_jax.media.medium import lookup_density


def test_vol_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.uniform(size=(4, 5, 6, 1)).astype(np.float32)
    p = str(tmp_path / "d.vol")
    save_vol(p, data, [-1, -1, -1], [1, 1, 1])
    back, bmin, bmax = load_vol(p)
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(bmin, [-1, -1, -1])


def test_grid_transform_and_lookup(tmp_path):
    # density = x-coordinate ramp over bbox [0,2]^3
    x = np.linspace(0, 1, 8, dtype=np.float32)
    data = np.broadcast_to(x[None, None, :], (8, 8, 8)).copy()
    p = str(tmp_path / "ramp.vol")
    save_vol(p, data[..., None], [0, 0, 0], [2, 2, 2])
    from mitsuba_jax.io.volio import load_heterogeneous_from_vol

    med = load_heterogeneous_from_vol(p, (1.0,) * 3, (0.0,) * 3)
    pts = jnp.asarray([[0.0, 1.0, 1.0], [1.0, 1.0, 1.0], [2.0, 1.0, 1.0]])
    rho = np.asarray(lookup_density(med, pts))
    np.testing.assert_allclose(rho, [0.0, 0.5, 1.0], atol=0.03)


def test_xml_medium(tmp_path):
    scene, cfg = load_scene_string("""
<scene>
 <medium type="homogeneous">
   <rgb name="sigmaS" value="0.5 0.6 0.7"/>
   <rgb name="sigmaA" value="0.1 0.1 0.1"/>
   <phase type="hg"><float name="g" value="0.4"/></phase>
 </medium>
 <shape type="sphere"><bsdf type="lambertian"/></shape>
</scene>""")
    med = cfg["medium"]
    np.testing.assert_allclose(np.asarray(med.sigma_s), [0.5, 0.6, 0.7])
    assert abs(float(med.phase_g) - 0.4) < 1e-6
    assert med.enabled
