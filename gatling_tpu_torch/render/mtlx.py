"""MaterialX document front end: the port of the JAX package's
render/mtlx.py.

The reference feeds MaterialX through MDL codegen
(reference: src/mc/impl/MtlxMdlCodeGen.cpp translate:217-287 — MaterialX doc
-> MDL source -> compiled material). Here .mtlx XML lowers directly into the
same shader-network representation the USD path produces (scene.stage
MaterialDesc/ShaderNode), which the uber-BSDF lowering in render/material.py
consumes. The bundled nodedefs are the port's own copy under gatling_tpu_torch/mtlx/.
Supported: standard_surface / open_pbr_surface / gltf_pbr /
UsdPreviewSurface surface shaders, image/tiledimage texture nodes, constant
nodes, nodegraph outputs, surfacematerial bindings.

Document patching chores the reference does in McMtlxDocumentPatcher
(MtlxDocumentPatcher.cpp: bool-as-int literals, color3/vector3 conversion)
are handled during value parsing.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from gatling_tpu_torch.scene.stage import MaterialDesc, ShaderNode
from gatling_tpu_torch.utils.log import get_logger

_SURFACE_CATEGORIES = (
    "standard_surface", "open_pbr_surface", "gltf_pbr", "UsdPreviewSurface",
    "disney_brdf", "lama_surface",
)

_TEXTURE_CATEGORIES = ("image", "tiledimage")


def _parse_value(val: str, type_name: str):
    """MaterialX value string -> python value (bool-as-int patching like
    MtlxDocumentPatcher.cpp:118-139)."""
    val = val.strip()
    if type_name == "boolean":
        return val in ("true", "1")
    if type_name in ("float", "integer", "int"):
        try:
            f = float(val)
            return int(f) if type_name in ("integer", "int") else f
        except ValueError:
            return 0.0
    if type_name in ("color3", "color4", "vector2", "vector3", "vector4"):
        try:
            return tuple(float(x) for x in val.split(","))
        except ValueError:
            return (0.0, 0.0, 0.0)
    if type_name == "filename":
        # OS-path sanitizing (MtlxDocumentPatcher.cpp:41-54): Windows
        # backslash-separated asset paths become forward-slash paths so
        # downstream resolution is platform-uniform
        return val.replace("\\", "/")
    if type_name == "string":
        return val
    return val


_BUNDLED_MTLX_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mtlx")
_bundled_nodedefs: dict[str, dict] | None = None


def _scan_nodedefs(root: ET.Element) -> tuple[dict, dict]:
    """Collect <nodedef> interfaces (category -> {input: default}) and
    functional <nodegraph nodedef=...> implementations (category -> elem).
    The registration analog of the reference's bundled open_pbr nodedef
    install (rendererPlugin.cpp; src/gi/mtlx/open_pbr_surface*.mtlx)."""
    defs: dict[str, dict] = {}
    node_of_def: dict[str, str] = {}
    impls: dict[str, ET.Element] = {}
    for nd in root.findall("nodedef"):
        cat = nd.get("node", "")
        if not cat:
            continue
        node_of_def[nd.get("name", "")] = cat
        defaults = {}
        for inp in nd.findall("input"):
            if inp.get("value") is not None:
                defaults[inp.get("name", "")] = _parse_value(
                    inp.get("value"), inp.get("type", ""))
        defs[cat] = defaults
    for ng in root.findall("nodegraph"):
        ref = ng.get("nodedef", "")
        if ref and ref in node_of_def:
            impls[node_of_def[ref]] = ng
    return defs, impls


def _bundled_defs() -> dict[str, dict]:
    """Nodedef interfaces shipped with the package (open_pbr_surface for
    pre-1.39 MaterialX documents), loaded once."""
    global _bundled_nodedefs
    if _bundled_nodedefs is None:
        _bundled_nodedefs = {}
        try:
            for fn in sorted(os.listdir(_BUNDLED_MTLX_DIR)):
                if fn.endswith(".mtlx"):
                    with open(os.path.join(_BUNDLED_MTLX_DIR, fn)) as f:
                        defs, _ = _scan_nodedefs(ET.fromstring(f.read()))
                    _bundled_nodedefs.update(defs)
        except OSError:
            pass
    return _bundled_nodedefs


def parse_mtlx(text: str, name: str = "mtlx", base_dir: str = "") -> MaterialDesc:
    """Parse a MaterialX XML document into a MaterialDesc network.

    Custom nodes defined by an in-document <nodedef> + functional
    <nodegraph> pair are INLINE-EXPANDED at their instantiation sites
    (interface inputs bind through `interfacename` references); nodedef
    interfaces — in-document or bundled (open_pbr_surface) — fill unbound
    instance inputs with their spec defaults."""
    root = ET.fromstring(text)
    nodes: dict[str, ShaderNode] = {}
    surface_node: str | None = None
    material_surface_ref: str | None = None
    doc_defs, doc_impls = _scan_nodedefs(root)
    all_defs = dict(_bundled_defs())
    all_defs.update(doc_defs)

    def expand_instance(path: str, impl: ET.Element, inputs: dict,
                        conns: dict) -> None:
        """Inline a functional nodegraph at instance `path`: template nodes
        copy under path/exp with interfacename inputs bound to the
        instance's inputs/connections; the instance aliases the template's
        output node."""
        out_node = None
        for child in impl:
            if child.tag == "output":
                if child.get("nodename"):
                    out_node = child.get("nodename")
                continue
            n_name = child.get("name", "")
            n_path = f"{path}/exp/{n_name}"
            n_inputs: dict = {}
            n_conns: dict = {}
            for inp in child.findall("input"):
                iname = inp.get("name", "")
                iface = inp.get("interfacename")
                if iface:
                    if iface in conns:
                        n_conns[iname] = conns[iface]
                    elif iface in inputs:
                        n_inputs[iname] = inputs[iface]
                elif inp.get("value") is not None:
                    n_inputs[iname] = _parse_value(inp.get("value"),
                                                   inp.get("type", ""))
                elif inp.get("nodename"):
                    n_conns[iname] = (f"{path}/exp/{inp.get('nodename')}",
                                      inp.get("output", "out"))
            nodes[n_path] = ShaderNode(path=n_path, shader_id=child.tag,
                                       inputs=n_inputs, input_connections=n_conns)
        if out_node is not None:
            nodes[path] = ShaderNode(
                path=path, shader_id="__output", inputs={},
                input_connections={"in": (f"{path}/exp/{out_node}", "out")})

    def walk(elem: ET.Element, prefix: str) -> None:
        nonlocal surface_node, material_surface_ref
        for child in elem:
            tag = child.tag
            node_name = child.get("name", "")
            path = f"{prefix}/{node_name}"
            if tag == "nodegraph":
                if child.get("nodedef"):
                    continue  # functional template, expanded at instances
                walk(child, path)
                continue
            if tag in ("nodedef", "implementation", "typedef", "output", "input"):
                if tag == "output" and prefix != f"/{name}":
                    # nodegraph output: alias to its connected node
                    src = child.get("nodename")
                    if src:
                        nodes[path] = ShaderNode(
                            path=path, shader_id="__output",
                            inputs={}, input_connections={"in": (f"{prefix}/{src}", "out")})
                continue
            inputs: dict = {}
            conns: dict = {}
            for inp in child.findall("input"):
                iname = inp.get("name", "")
                itype = inp.get("type", "")
                if inp.get("value") is not None:
                    inputs[iname] = _parse_value(inp.get("value"), itype)
                elif inp.get("nodename"):
                    conns[iname] = (f"{prefix}/{inp.get('nodename')}", inp.get("output", "out"))
                elif inp.get("nodegraph"):
                    out = inp.get("output", "out")
                    conns[iname] = (f"{prefix}/{inp.get('nodegraph')}/{out}", "out")
            if tag == "surfacematerial":
                conn = conns.get("surfaceshader")
                if conn:
                    material_surface_ref = conn[0]
                continue
            if tag in all_defs:
                # registered nodedef interface: unbound inputs get the
                # definition's defaults
                for iname, dval in all_defs[tag].items():
                    if iname not in inputs and iname not in conns:
                        inputs[iname] = dval
            if tag in doc_impls and tag not in _SURFACE_CATEGORIES:
                expand_instance(path, doc_impls[tag], inputs, conns)
                continue
            nodes[path] = ShaderNode(path=path, shader_id=tag, inputs=inputs,
                                     input_connections=conns)
            if tag in _SURFACE_CATEGORIES and surface_node is None:
                surface_node = path

    walk(root, f"/{name}")

    if material_surface_ref and material_surface_ref in nodes:
        surface_node = material_surface_ref
    if surface_node is None and nodes:
        get_logger().warning("mtlx %s: no recognized surface shader", name)

    # resolve __output aliases transparently: rewrite connections that target
    # an output node to its source
    def resolve(target: tuple[str, str]) -> tuple[str, str]:
        seen = 0
        while seen < 8:
            node = nodes.get(target[0])
            if node is None or node.shader_id != "__output":
                return target
            target = node.input_connections.get("in", target)
            seen += 1
        return target

    for node in nodes.values():
        for k, tgt in list(node.input_connections.items()):
            node.input_connections[k] = resolve(tgt)

    return MaterialDesc(path=f"/{name}", surface_node=surface_node, nodes=nodes,
                        base_dir=base_dir)


def load_mtlx(path: str | os.PathLike) -> MaterialDesc:
    with open(path, "r", encoding="utf-8") as f:
        return parse_mtlx(f.read(), name=os.path.splitext(os.path.basename(str(path)))[0],
                          base_dir=os.path.dirname(os.path.abspath(str(path))))
