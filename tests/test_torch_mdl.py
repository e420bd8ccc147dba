"""The port's MDL front end against the JAX package's, on the CPU.

`gatling_tpu_torch/render/mdl.py` is carried over from
`gatling_tpu/render/mdl.py` and resolves the bundled modules in the port's
own copies (`gatling_tpu_torch/mdl/`). Held here, in one process:

1. `load_mdl_material` + `lower_material` give equal parameter sets,
   texture requests and traits for every bundled module and for the
   core_definitions materials (the corpus of
   tests/test_material_frontends.py:363), with the overrides of :210;
2. the same for the inline bodies of :120, :148 and :175, the Omni-style
   parameter module of :36 and the core_definitions instantiations of
   :262 and :324;
3. `resolve_mdl_path` ends in the port's directory, and the port's
   modules are byte copies of the JAX package's;
4. a .usda binding MDL materials through `info:mdl:sourceAsset` gives the
   same material table through both `stage` modules, bit for bit;
5. a material with a `backface:` field raises, naming its ROADMAP item; a
   missing module falls back to the default material, as in JAX.
"""

import os

import numpy as np
import pytest

import gatling_tpu.render.material as jmat
import gatling_tpu.render.mdl as jmdl
from gatling_tpu.scene.stage import load_scene as jload_scene

import gatling_tpu_torch.render.material as tmat
import gatling_tpu_torch.render.mdl as tmdl
from gatling_tpu_torch.scene import examples as ex
from gatling_tpu_torch.scene.stage import load_scene as tload_scene

CD = os.path.join("nvidia", "core_definitions.mdl")
CORPUS = [("OmniPBR.mdl", "OmniPBR"), ("OmniGlass.mdl", "OmniGlass"),
          ("OmniSurface.mdl", "OmniSurface"), ("OmniHair.mdl", "OmniHair")] + [
    (CD, m) for m in ("diffuse", "metal", "scratched_metal", "plastic", "flex_material",
                      "flex_material_v2", "thin_glass", "thick_glass", "thin_translucent",
                      "retroreflective", "add_emission", "apply_clearcoat")]
OVERRIDES = {  # tests/test_material_frontends.py:210-237
    "OmniPBR": {"diffuse_color_constant": (0.1, 0.5, 0.9), "metallic_constant": 1.0,
                "reflection_roughness_constant": 0.3},
    "OmniGlass": {"glass_color": (0.8, 0.9, 1.0)},
    "OmniSurface": {"emission_weight": 1.0},
    "OmniHair": {"base_color": (0.4, 0.25, 0.1), "melanin_concentration": 0.8},
}

INLINE = {  # tests/test_material_frontends.py:36, :120, :148, :175, :262, :324
    "omni_style": ("MyMat", """mdl 1.6;
import ::OmniPBR::OmniPBR;

export material MyMat(
    uniform color diffuse_color_constant = color(0.2, 0.5, 0.8),
    uniform float reflection_roughness_constant = 0.35,
    uniform float metallic_constant = 0.0,
    uniform bool enable_emission = true,
    uniform color emissive_color = color(1.0, 0.5, 0.0),
    uniform float emissive_intensity = 2.0,
    uniform texture_2d diffuse_texture = texture_2d("./albedo.png", ::tex::gamma_srgb)
) = ::OmniPBR::OmniPBR(
    diffuse_color_constant: diffuse_color_constant,
    reflection_roughness_constant: reflection_roughness_constant,
    enable_emission: enable_emission,
    emissive_color: emissive_color,
    emissive_intensity: emissive_intensity
);
"""),
    "body_diffuse": ("my_mat", """
mdl 1.6;
import ::df::*;
export material my_mat(color tint = color(0.2, 0.4, 0.6), float bright = 0.5)
 = material(
    thin_walled: true,
    surface: material_surface(
        scattering: df::diffuse_reflection_bsdf(tint: tint * bright)
    ),
    geometry: material_geometry(cutout_opacity: 0.7)
);
"""),
    "body_layered_glossy": ("glossy_mat", """
mdl 1.6;
import ::df::*;
export material glossy_mat(float rough = 0.09)
 = let {
     bsdf diff = df::diffuse_reflection_bsdf(tint: color(0.8, 0.1, 0.1));
     bsdf spec = df::microfacet_ggx_smith_bsdf(roughness_u: rough);
 } in material(
    surface: material_surface(
        scattering: df::fresnel_layer(ior: 1.33, layer: spec, base: diff)
    )
);
"""),
    "body_emission_and_volume": ("lamp", """
mdl 1.6;
import ::df::*;
export material lamp()
 = material(
    surface: material_surface(
        scattering: df::diffuse_reflection_bsdf(tint: color(0.0)),
        emission: material_emission(
            emission: df::diffuse_edf(),
            intensity: color(2.0, 1.5, 1.0)
        )
    ),
    volume: material_volume(
        absorption_coefficient: color(0.3, 0.2, 0.1),
        scattering_coefficient: color(0.05)
    ),
    ior: color(1.45)
);
"""),
    "core_flex": ("Fabric_Red", """
mdl 1.6;
import ::nvidia::core_definitions::*;

export material Fabric_Red(*)
 = nvidia::core_definitions::flex_material(
    base_color: color(0.8, 0.1, 0.1),
    reflection_roughness: 0.36,
    reflectivity: 0.4,
    ior: 1.3
);
"""),
    "core_metal": ("Steel", """
mdl 1.6;
import ::nvidia::core_definitions::*;
export material Steel(*)
 = nvidia::core_definitions::flex_material(
    base_color: color(0.7, 0.7, 0.75),
    is_metal: true,
    reflection_roughness: 0.2
);
"""),
    "core_thin_glass": ("Window", """
mdl 1.6;
export material Window(*)
 = ::nvidia::core_definitions::thin_glass(
    glass_color: color(0.9, 0.95, 1.0),
    ior: 1.52
);
"""),
    "core_add_emission": ("LampShade", """
mdl 1.6;
import ::nvidia::core_definitions::*;
export material LampShade(*)
 = nvidia::core_definitions::add_emission(
    base: nvidia::core_definitions::diffuse(
        diffuse_color: color(0.2, 0.4, 0.6)),
    tint: color(1.0, 0.9, 0.8),
    intensity: 100.0
);
"""),
    "fog": ("Fog", ex.FOG_MDL),
}

BACKFACE_MDL = """
mdl 1.6;
import ::df::*;
export material TwoSided()
 = material(
    surface: material_surface(
        scattering: df::diffuse_reflection_bsdf(tint: color(0.8, 0.2, 0.2))
    ),
    backface: material_surface(
        scattering: df::diffuse_reflection_bsdf(tint: color(0.1, 0.1, 0.9))
    )
);
"""


def _same_lowering(jrow, trow, label):
    """Equal parameters (bit for bit as floats), texture requests and the
    traits both packages carry."""
    assert set(trow.params) == set(jrow.params), label
    for k, v in trow.params.items():
        assert np.array_equal(np.asarray(v, np.float64), np.asarray(jrow.params[k], np.float64)), (
            label, k, v, jrow.params[k])
    assert set(trow.textures) == set(jrow.textures), label
    for k, t in trow.textures.items():
        for f in ("file_path", "is_srgb", "wrap_s", "wrap_t", "scale", "bias", "channel"):
            assert getattr(t, f) == getattr(jrow.textures[k], f), (label, k, f)
    assert trow.traits.has_cutout == jrow.traits.has_cutout, label
    assert trow.traits.has_backface_edf == jrow.traits.has_backface_edf, label
    jt, tt = jmat.build_material_table([jrow]), tmat.build_material_table([trow])
    np.testing.assert_array_equal(tt.packed_f.view(np.int32),
                                  np.asarray(jt.packed_f).view(np.int32))


@pytest.mark.parametrize("rel,name", CORPUS)
def test_bundled_modules_lower_as_jax(rel, name):
    over = OVERRIDES.get(name, {})
    for overrides in ({}, over) if over else ({},):
        jrow = jmat.lower_material(jmdl.load_mdl_material(rel, name, dict(overrides)))
        trow = tmat.lower_material(tmdl.load_mdl_material(rel, name, dict(overrides)))
        _same_lowering(jrow, trow, f"{name} {overrides}")


@pytest.mark.parametrize("case", sorted(INLINE))
def test_inline_bodies_lower_as_jax(tmp_path, case):
    name, text = INLINE[case]
    p = tmp_path / f"{case}.mdl"
    p.write_text(text)
    jrow = jmat.lower_material(jmdl.load_mdl_material(p, name))
    trow = tmat.lower_material(tmdl.load_mdl_material(p, name))
    _same_lowering(jrow, trow, case)
    if case == "omni_style":
        over = {"diffuse_color_constant": (1.0, 0.0, 0.0)}  # :96-101
        _same_lowering(jmat.lower_material(jmdl.load_mdl_material(p, name, dict(over))),
                       tmat.lower_material(tmdl.load_mdl_material(p, name, dict(over))),
                       f"{case} override")


def test_modules_resolve_in_the_port():
    assert tmdl.resolve_mdl_path("OmniPBR.mdl").endswith("gatling_tpu_torch/mdl/OmniPBR.mdl")
    assert tmdl.BUNDLED_MDL_DIR.endswith(os.path.join("gatling_tpu_torch", "mdl"))
    for rel, _name in CORPUS[:4] + [(CD, "")]:
        with open(os.path.join(tmdl.BUNDLED_MDL_DIR, rel), "rb") as a, \
                open(os.path.join(jmdl.BUNDLED_MDL_DIR, rel), "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("make", ["glass_tinted", "cornell_fog"])
def test_usda_source_asset_tables_match_jax(tmp_path, make):
    """The MDL-bound Cornell boxes through both stage modules and lowerings:
    packed_f and packed_i bit for bit."""
    path = getattr(ex, make)(str(tmp_path))
    jdesc, tdesc = jload_scene(path), tload_scene(path)
    assert sorted(jdesc.materials) == sorted(tdesc.materials)
    bound = next(m.material for m in tdesc.meshes if m.path.endswith("/TallBlock"))
    assert tdesc.materials[bound].mdl_source.endswith(
        ("gatling_tpu_torch/mdl/OmniGlass.mdl", "fog.mdl"))
    jrows = [jmat.lower_material(jdesc.materials[p]) for p in sorted(jdesc.materials)]
    trows = [tmat.lower_material(tdesc.materials[p]) for p in sorted(tdesc.materials)]
    jt, tt = jmat.build_material_table(jrows), tmat.build_material_table(trows)
    np.testing.assert_array_equal(tt.packed_f.view(np.int32),
                                  np.asarray(jt.packed_f).view(np.int32))
    np.testing.assert_array_equal(tt.packed_i, np.asarray(jt.packed_i))
    vol = tt.packed_f[:, tmat.MF_VOL_A:tmat.MF_VOL_S + 3]
    assert (vol > 0).any()  # the medium reached the table


def test_backface_material_raises(tmp_path):
    """A `backface:` surface, which raised until the backface rows were
    ported, lowers as in the JAX package: the front parameters and the
    backface dict equal, bit for bit as floats, the backface traits and
    the packed rows (the appended backface row and MI_BACKFACE_ID)."""
    p = tmp_path / "two_sided.mdl"
    p.write_text(BACKFACE_MDL)
    jrow = jmat.lower_material(jmdl.load_mdl_material(p, "TwoSided"))
    trow = tmat.lower_material(tmdl.load_mdl_material(p, "TwoSided"))
    assert jrow.backface and set(trow.backface) == set(jrow.backface)
    for k, v in trow.backface.items():
        assert np.array_equal(np.asarray(v, np.float64), np.asarray(jrow.backface[k], np.float64)), k
    _same_lowering(jrow, trow, "TwoSided")
    jt, tt = jmat.build_material_table([jrow]), tmat.build_material_table([trow])
    np.testing.assert_array_equal(tt.packed_i, np.asarray(jt.packed_i))
    assert trow.traits.has_backface_bsdf == jrow.traits.has_backface_bsdf
    assert trow.traits.has_backface_edf == jrow.traits.has_backface_edf


def test_missing_module_falls_back():
    """The reference's semantics (test_mdl_missing_file_falls_back): the
    default material."""
    for mdl, mat in ((jmdl, jmat), (tmdl, tmat)):
        lowered = mat.lower_material(mdl.load_mdl_material("/nonexistent/foo.mdl", "X"))
        assert lowered.params["base_color"] == (0.18, 0.18, 0.18)
