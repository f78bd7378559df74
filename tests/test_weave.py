"""Weave-pattern file parsing (reference irawan.h grammar) + bit-packed
pattern-grid cloth dispatch."""
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_jax.io.weave import (
    EWARP, EWEFT, WeaveParseError, load_weave_string,
)

# a 3x2 basket-style weave authored for the tests (grammar-compatible with
# the reference's file format, see irawan.h:325)
SAMPLE = """
/* test weave */
weave {
    name = "TestBasket",
    tileWidth = 3,
    tileHeight = 2,
    alpha = $alpha,          // from props
    beta = 4.0,
    ss = 0.5,
    hWidth = 0.6,
    warpArea = 2.0, weftArea = 1.0,
    fineness = 150.0, period = 100.0,
    dWarpUmaxOverDWarp = 90, dWarpUmaxOverDWeft = 0,
    dWeftUmaxOverDWarp = 0,  dWeftUmaxOverDWeft = 90,
    pattern { 1, 2, 1,
              2, 1, 2 },
    yarn {
        type = warp, psi = 30, umax = 35, kappa = 2.0,
        width = 2, length = 3, centerU = 0.5, centerV = 0.5,
        kd = {0.2, 0.8, 0.3}, ks = {0.4, 0.4, 0.4}
    },
    yarn {
        type = weft, umax = 25,
        width = 2, length = 3, centerU = 0.5, centerV = 0.5,
        kd = {0.7, 0.1, 0.1}, ks = {0.1, 0.1, 0.1}
    }
}
"""


def test_parse_sample():
    w = load_weave_string(SAMPLE, props={"alpha": 0.33})
    assert w.name == "TestBasket"
    assert (w.tileWidth, w.tileHeight) == (3, 2)
    assert w.alpha == pytest.approx(0.33)          # $var substitution
    assert w.beta == pytest.approx(4.0)
    assert w.dWarpUmaxOverDWarp == pytest.approx(np.pi / 2)  # deg -> rad
    assert len(w.yarns) == 2
    assert w.yarns[0].type == EWARP
    assert w.yarns[0].psi == pytest.approx(30 * np.pi / 180)
    assert w.yarns[0].umax == pytest.approx(35 * np.pi / 180)
    assert w.yarns[1].type == EWEFT
    assert w.yarns[0].kd == pytest.approx((0.2, 0.8, 0.3))
    g = w.warp_grid()
    assert g.shape == (2, 3)
    np.testing.assert_array_equal(
        g, [[True, False, True], [False, True, False]]
    )


def test_parse_errors():
    with pytest.raises(WeaveParseError):
        load_weave_string("weave { tileWidth = 2, tileHeight = 2, "
                          "pattern { 1, 1, 1 }, yarn { type = warp } }")
    with pytest.raises(WeaveParseError):
        load_weave_string("weave { tileWidth = 1, tileHeight = 1, "
                          "pattern { 5 }, yarn { type = warp } }")
    with pytest.raises(WeaveParseError):
        load_weave_string("weave { alpha = $missing }")


def test_pattern_grid_dispatch(tmp_path):
    """The packed pattern tables reproduce the file's warp/weft layout
    through the material gather and cloth dispatch (irawan.cpp:109-119:
    uv.y flips, repeat scales, per-cell yarn lookup)."""
    from mitsuba_jax.bsdfs import bsdf_eval
    from mitsuba_jax.bsdfs.irawan import irawan_diffuse_reflectance
    from mitsuba_jax.bsdfs.table import MaterialBuilder

    f = tmp_path / "basket.wift"
    f.write_text(SAMPLE.replace("$alpha", "0.33"))
    b = MaterialBuilder()
    mid = b.irawan_file(str(f), repeat_u=1.0, repeat_v=1.0)
    table = b.build()
    # at repeat 1, uv spans exactly one tile: cell (x, y) of the pattern
    # grid sits at uv.x = (x+0.5)/tileWidth and (v flipped, irawan.cpp:112)
    # uv.y = 1 - (y+0.5)/tileHeight
    uvs, expect = [], []
    w = load_weave_string(SAMPLE, props={"alpha": 0.33})
    g = w.warp_grid()
    for y in range(2):
        for x in range(3):
            uvs.append([(x + 0.5) / 3.0, 1.0 - (y + 0.5) / 2.0])
            expect.append(g[y, x])
    uv = jnp.asarray(uvs, jnp.float32)
    n = uv.shape[0]
    p = table.gather(jnp.full((n,), mid, jnp.int32))
    p = dict(p, _uv=uv)
    # per-cell diffuse reflectance picks the cell's yarn kd
    kd = np.asarray(irawan_diffuse_reflectance(p))
    exp_kd = np.where(np.asarray(expect)[:, None],
                      np.asarray(w.yarns[0].kd), np.asarray(w.yarns[1].kd))
    np.testing.assert_allclose(kd, exp_kd, rtol=1e-6)
    # end-to-end eval: warp cells shade with warp kd (greenish), weft red
    wi = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    wo = jnp.broadcast_to(jnp.asarray([0.0, 0.3, 0.954]), (n, 3))
    val = np.asarray(bsdf_eval(table, jnp.full((n,), mid, jnp.int32),
                               wi, wo, uv=uv))
    warp_cells = val[np.asarray(expect)]
    weft_cells = val[~np.asarray(expect)]
    assert (warp_cells[:, 1] > warp_cells[:, 0]).all()   # green-dominant
    assert (weft_cells[:, 0] > weft_cells[:, 1]).all()   # red-dominant


def test_irawan_filename_via_xml(tmp_path):
    """<bsdf type="irawan"><string name="filename" .../></bsdf> loads the
    weave file through the scene XML path (reference irawan.cpp:64)."""
    from mitsuba_jax.io.xml import load_scene_string

    (tmp_path / "basket.wift").write_text(
        SAMPLE.replace("$alpha", "0.33"))
    xml = """<scene>
      <camera type="perspective">
        <transform name="toWorld">
          <lookAt ox="0" oy="0" oz="3" tx="0" ty="0" tz="0" ux="0" uy="1" uz="0"/>
        </transform>
        <film type="exrfilm">
          <integer name="width" value="4"/><integer name="height" value="4"/>
        </film>
      </camera>
      <shape type="sphere">
        <point name="center" x="0" y="0" z="0"/>
        <float name="radius" value="1"/>
        <bsdf type="irawan">
          <string name="filename" value="basket.wift"/>
          <float name="repeatU" value="5"/>
          <float name="repeatV" value="5"/>
        </bsdf>
      </shape>
    </scene>"""
    scene, cfg = load_scene_string(xml, base_dir=str(tmp_path))
    from mitsuba_jax.bsdfs.table import CLOTH

    kinds = np.asarray(scene.materials.kind)
    assert (kinds == CLOTH).any()
    row = int(np.argmax(kinds == CLOTH))
    assert scene.materials.cloth is not None
    assert int(np.asarray(scene.materials.cloth_slot)[row]) >= 0
    # warp kd from the file (greenish)
    kd = np.asarray(scene.materials.reflectance)[row]
    assert kd[1] > kd[0]
