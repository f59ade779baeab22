"""Material pipeline tests — the reference's test_materialmanager coverage
(mtlx codegen + MDL module compile, tests/materialmanager/
test_materialmanager.cpp:14-161) re-targeted at the dense parameter tables."""

import numpy as np
import pytest

from strelka_tpu.loaders.mdl import parse_mdl_materials
from strelka_tpu.loaders.mtlx import parse_mtlx
from strelka_tpu.materials import BsdfType, MaterialManager
from strelka_tpu.scene.scene import MaterialDescription

# Equivalent of the inline UsdPreviewSurface doc in the reference test (:14-117)
MTLX_DOC = """<?xml version="1.0"?>
<materialx version="1.38" colorspace="lin_rec709">
  <UsdPreviewSurface name="SR_beige" type="surfaceshader">
    <input name="diffuseColor" type="color3" value="0.8, 0.62, 0.45" />
    <input name="metallic" type="float" value="0.25" />
    <input name="roughness" type="float" value="0.35" />
    <input name="ior" type="float" value="1.52" />
    <input name="opacity" type="float" value="1.0" />
  </UsdPreviewSurface>
  <surfacematerial name="USD_beige" type="material">
    <input name="surfaceshader" type="surfaceshader" nodename="SR_beige" />
  </surfacematerial>
</materialx>
"""

MTLX_STANDARD_SURFACE = """<?xml version="1.0"?>
<materialx version="1.38">
  <nodegraph name="NG">
    <image name="diff_tex" type="color3">
      <input name="file" type="filename" value="textures/wood.png" />
    </image>
  </nodegraph>
  <standard_surface name="wood" type="surfaceshader">
    <input name="base_color" type="color3" nodename="diff_tex" />
    <input name="specular_roughness" type="float" value="0.6" />
    <input name="metalness" type="float" value="0.0" />
  </standard_surface>
</materialx>
"""


def test_mtlx_usdpreviewsurface_translate():
    """mtlx -> param table ('mtlx to hlsl code gen test' analog)."""
    desc = parse_mtlx(MTLX_DOC)
    assert desc.name == "SR_beige"
    np.testing.assert_allclose(desc.params["diffuse_color_constant"], [0.8, 0.62, 0.45])
    assert desc.params["metallic_constant"] == pytest.approx(0.25)
    assert desc.params["reflection_roughness_constant"] == pytest.approx(0.35)
    assert desc.params["ior"] == pytest.approx(1.52)

    mm = MaterialManager()
    module = mm.create_mtlx_module(MTLX_DOC)
    inst = mm.create_material_instance(module, "SR_beige")
    mat = mm.compile_material(inst)
    assert mat.bsdf_type == BsdfType.OMNI_PBR
    assert mat.metallic == pytest.approx(0.25)
    np.testing.assert_allclose(mat.diffuse_color, [0.8, 0.62, 0.45], rtol=1e-6)


def test_mtlx_standard_surface_with_texture():
    desc = parse_mtlx(MTLX_STANDARD_SURFACE)
    assert desc.params["reflection_roughness_constant"] == pytest.approx(0.6)
    assert desc.params["diffuse_texture"] == "textures/wood.png"


def test_mdl_module_parse_and_compile():
    """'MDL OmniPBR' analog (:118-161): load module, compile, check params."""
    mm = MaterialManager()
    module = mm.create_module("OmniPBR.mdl")
    from strelka_tpu.loaders.mdl import MdlModule

    assert isinstance(module, MdlModule), "builtin OmniPBR.mdl should resolve"
    assert "OmniPBR" in module.materials
    defaults = module.materials["OmniPBR"]
    assert defaults["reflection_roughness_constant"] == pytest.approx(0.5)
    assert defaults["metallic_constant"] == pytest.approx(0.0)
    assert defaults["diffuse_color_constant"] == [0.2, 0.2, 0.2]

    inst = mm.create_material_instance(module, "OmniPBR")
    mat = mm.compile_material(inst)
    assert mat.bsdf_type == BsdfType.OMNI_PBR
    assert mat.roughness == pytest.approx(0.5)
    np.testing.assert_allclose(mat.diffuse_color, [0.2, 0.2, 0.2])

    # instance params override defaults (setParam arg-block write analog)
    desc = MaterialDescription(type="mdl", file="OmniPBR.mdl", name="OmniPBR")
    desc.params = {"reflection_roughness_constant": 0.1, "metallic_constant": 1.0}
    mat2 = mm.compile_material(inst, desc)
    assert mat2.roughness == pytest.approx(0.1)
    assert mat2.metallic == pytest.approx(1.0)


def test_mdl_glass_module():
    mm = MaterialManager()
    module = mm.create_module("OmniGlass.mdl")
    inst = mm.create_material_instance(module, "OmniGlass")
    mat = mm.compile_material(inst)
    assert mat.bsdf_type == BsdfType.OMNI_GLASS
    assert mat.ior == pytest.approx(1.491)


def test_mdl_parser_robustness():
    src = """
    mdl 1.6;
    import ::df::*;
    // a comment with material keyword
    export material Funky(
        color tint = color(1.0f), /* inline */
        uniform float x = 2.5f [[ anno::hard_range(0.0, 5.0) ]],
        uniform bool flag = true,
        uniform texture_2d tex = texture_2d("maps/a.png")
    ) = material(surface: material_surface(scattering: df::diffuse_reflection_bsdf(tint: tint)));
    """
    mats = parse_mdl_materials(src)
    assert "Funky" in mats
    p = mats["Funky"]
    assert p["tint"] == [1.0, 1.0, 1.0]
    assert p["x"] == pytest.approx(2.5)
    assert p["flag"] is True
    assert p["tex"] == "maps/a.png"


def test_scene_material_pipeline_uses_modules():
    """End-to-end: scene descs compile through module resolution."""
    mm = MaterialManager()
    descs = [
        MaterialDescription(type="mdl", file="default.mdl", name="default"),
        MaterialDescription(type="mdl", file="OmniPBR.mdl", name="OmniPBR"),
        MaterialDescription(type="mtlx", code=MTLX_DOC, name="beige"),
    ]
    compiled = mm.compile_scene_materials(descs)
    assert compiled[0].bsdf_type == BsdfType.DIFFUSE
    np.testing.assert_allclose(compiled[0].diffuse_color, [0.7, 0.7, 0.7])  # default.mdl default
    assert compiled[1].bsdf_type == BsdfType.OMNI_PBR
    assert compiled[2].metallic == pytest.approx(0.25)
    table = mm.generate_target_code(compiled)
    assert table.bsdf_type.shape == (3,)


def test_material_dedup():
    """Identical compiled materials collapse to one table row
    (materialmanager.cpp:524-609 parity)."""
    import numpy as np
    from strelka_tpu.materials import CompiledMaterial, MaterialManager

    mm = MaterialManager()
    a = CompiledMaterial(name="a", roughness=0.25)
    b = CompiledMaterial(name="b", roughness=0.25)  # same content, other name
    c = CompiledMaterial(name="c", roughness=0.75)
    table, remap = mm.generate_target_code_deduped([a, b, c, a])
    assert table.roughness.shape[0] == 2
    np.testing.assert_array_equal(remap, [0, 0, 1, 0])
    np.testing.assert_allclose(table.roughness, [0.25, 0.75])


# ---- df-body folding (layered/weighted MDL -> uber params; replaces the
# module-NAME guess with body semantics, mdlPtxCodeGen.cpp compile analog)

LAYERED_MDL = """
mdl 1.6;
import ::df::*;
export material ClearcoatWood(
    color wood_color = color(0.2f, 0.4f, 0.6f),
    uniform float coat_rough = 0.09f
) = material(
    surface: material_surface(
        scattering: df::weighted_layer(
            weight: 0.3,
            layer: df::simple_glossy_bsdf(roughness_u: coat_rough),
            base: df::diffuse_reflection_bsdf(tint: wood_color)
        )
    )
);

export material BrushedMetal(
    color metal_tint = color(0.9f, 0.6f, 0.3f),
    uniform float rough = 0.04f
) = material(
    surface: material_surface(
        scattering: df::weighted_layer(
            weight: 1.0,
            layer: df::microfacet_ggx_smith_bsdf(roughness_u: rough, tint: metal_tint),
            base: df::diffuse_reflection_bsdf(tint: color(0.1f))
        )
    )
);

export material TintedGlass(
    color tint = color(0.8f, 0.9f, 1.0f)
) = material(
    ior: color(1.6f),
    surface: material_surface(
        scattering: df::specular_bsdf(
            tint: tint,
            mode: df::scatter_reflect_transmit
        )
    )
);
"""


def _fold(name):
    from strelka_tpu.loaders.mdl import fold_material_body, parse_mdl_materials

    bodies = {}
    mats = parse_mdl_materials(LAYERED_MDL, bodies)
    return fold_material_body(bodies[name], mats[name])


def test_fold_weighted_glossy_over_diffuse():
    out = _fold("ClearcoatWood")
    assert out["bsdf_kind"] == "pbr"
    np.testing.assert_allclose(out["diffuse_color_constant"], [0.2, 0.4, 0.6], atol=1e-6)
    # roughness_u is alpha: perceptual roughness = sqrt(0.09) = 0.3
    assert out["reflection_roughness_constant"] == pytest.approx(0.3, abs=1e-6)
    # white glossy layer -> dielectric, not metal
    assert out["metallic_constant"] == pytest.approx(0.0, abs=1e-6)


def test_fold_metal_layer():
    out = _fold("BrushedMetal")
    assert out["bsdf_kind"] == "pbr"
    assert out["metallic_constant"] == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(out["diffuse_color_constant"], [0.9, 0.6, 0.3], atol=1e-6)
    assert out["reflection_roughness_constant"] == pytest.approx(0.2, abs=1e-6)


def test_fold_transmission_to_glass():
    out = _fold("TintedGlass")
    assert out["bsdf_kind"] == "glass"
    np.testing.assert_allclose(out["glass_color"], [0.8, 0.9, 1.0], atol=1e-6)
    assert out["ior"] == pytest.approx(1.6, abs=1e-6)


def test_fold_shipped_omnipbr_matches_name_guess():
    """The shipped OmniPBR body folds to the same defaults the name-based
    path produced (custom_curve_layer + weighted metal layer)."""
    import os

    from strelka_tpu.loaders.mdl import load_mdl_module

    root = os.path.join(os.path.dirname(__file__), "..", "data", "materials", "mdl")
    mod = load_mdl_module("OmniPBR.mdl", [root])
    out = mod.folded("OmniPBR")
    assert out["bsdf_kind"] == "pbr"
    np.testing.assert_allclose(out["diffuse_color_constant"], [0.2] * 3, atol=1e-6)
    assert out["reflection_roughness_constant"] == pytest.approx(0.5, abs=1e-5)
    assert out["metallic_constant"] == pytest.approx(0.0, abs=1e-6)
    assert out["specular_level"] == pytest.approx(0.5, abs=1e-6)
    glass = load_mdl_module("OmniGlass.mdl", [root]).folded("OmniGlass")
    assert glass["bsdf_kind"] == "glass"
    assert glass["ior"] == pytest.approx(1.491, abs=1e-6)
    hair = load_mdl_module("OmniHair.mdl", [root]).folded("OmniHair")
    assert hair.get("bsdf_kind") == "hair"


def test_layered_module_compiles_via_manager(tmp_path):
    """End-to-end: an unknown-named layered module maps onto sensible table
    rows through MaterialManager (no name heuristics apply to 'ClearcoatWood')."""
    p = tmp_path / "Exotic.mdl"
    p.write_text(LAYERED_MDL)
    mm = MaterialManager()
    mm.add_mdl_search_path(str(tmp_path))
    module = mm.create_module("Exotic.mdl")
    inst = mm.create_material_instance(module, "BrushedMetal")
    mat = mm.compile_material(inst)
    assert mat.bsdf_type == BsdfType.OMNI_PBR
    assert mat.metallic == pytest.approx(1.0)
    np.testing.assert_allclose(mat.diffuse_color, [0.9, 0.6, 0.3], atol=1e-6)
    inst2 = mm.create_material_instance(module, "TintedGlass")
    mat2 = mm.compile_material(inst2)
    assert mat2.bsdf_type == BsdfType.OMNI_GLASS
    assert mat2.ior == pytest.approx(1.6)
