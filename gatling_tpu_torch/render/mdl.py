"""MDL material front end (text subset).

The JAX package's render/mdl.py, carried over unchanged in what it
computes; the bundled modules it resolves are this package's own copies
in gatling_tpu_torch/mdl/.

The reference compiles .mdl files through the dlopen'd NVIDIA MDL SDK
(reference: src/mc/impl/MdlMaterialCompiler.cpp compileFromFile:153,
MdlNeurayLoader.cpp). This package loads no MDL SDK, so this module
implements the part that matters for the bundled Omni* materials and
TurboSquid-style assets (reference ships OmniPBR/OmniSurface/OmniGlass in
src/gi/mdl for exactly this compatibility, rendererPlugin.cpp:54-55): a
textual parser that extracts a material definition's parameter defaults,
applies user parameter overrides (GiMaterialParameters analog), and maps the
well-known Omni/MDL parameter names onto the uber-BSDF parameter set.

This is NOT a general MDL compiler, but it goes beyond parameter names:
recognizable material BODIES (df graphs of diffuse/microfacet/specular
bsdfs, fresnel/weighted layers, mixes, emission, volume coefficients,
cutout_opacity, thin_walled, ior, including `let` bindings and parameter
references) are lowered onto the uber-BSDF. Unrecognized constructs fall
back to the parameter-name mapping with sensible defaults.
"""

from __future__ import annotations

import os
import re
from typing import Any

from gatling_tpu_torch.scene.stage import MaterialDesc, ShaderNode
from gatling_tpu_torch.utils.log import get_logger

# well-known parameter name -> (uber param, kind)
# kinds: f=float, c=color, b=bool, t=texture
_PARAM_MAP = {
    # OmniPBR / generic
    "diffuse_color_constant": ("base_color", "c"),
    "diffuse_tint": ("base_color", "c"),
    "base_color": ("base_color", "c"),
    "diffuse_color": ("base_color", "c"),
    "albedo": ("base_color", "c"),
    "diffuse_texture": ("base_color_texture", "t"),
    "reflection_roughness_constant": ("roughness", "f"),
    "reflectionroughness_texture": ("roughness_texture", "t"),
    "roughness": ("roughness", "f"),
    "specular_roughness": ("roughness", "f"),
    "frosting_roughness": ("roughness", "f"),
    "metallic_constant": ("metallic", "f"),
    "metallic": ("metallic", "f"),
    "metallic_texture": ("metallic_texture", "t"),
    "emissive_color": ("emissive_color", "c"),
    "emissive_intensity": ("emissive_intensity", "f"),
    "enable_emission": ("enable_emission", "b"),
    "emissive_mask_texture": ("emissive_texture", "t"),
    "opacity_constant": ("opacity", "f"),
    "opacity": ("opacity", "f"),
    "enable_opacity": ("enable_opacity", "b"),
    "opacity_threshold": ("opacity_threshold", "f"),
    "ior_constant": ("ior", "f"),
    "ior": ("ior", "f"),
    "normalmap_texture": ("normal_texture", "t"),
    # OmniGlass
    "glass_color": ("transmission_color", "c"),
    "glass_ior": ("ior", "f"),
    "thin_walled": ("thin_walled", "b"),
    # OmniSurface-ish
    "specular_reflection_roughness": ("roughness", "f"),
    "specular_reflection_ior": ("ior", "f"),
    "transmission_weight": ("transmission", "f"),
    "enable_specular_transmission": ("enable_transmission", "b"),
    "coat_weight": ("clearcoat", "f"),
    "coat_roughness": ("clearcoat_roughness", "f"),
    "clearcoat_weight": ("clearcoat", "f"),
    "clearcoat_roughness": ("clearcoat_roughness", "f"),
    "anisotropy": ("anisotropy", "f"),
    "anisotropy_rotation": ("anisotropy_rotation", "f"),
}

_VALUE_RE = re.compile(
    r"""(?:uniform\s+|varying\s+)?(?P<type>[\w:]+)\s+(?P<name>\w+)\s*=\s*(?P<value>[^,]+(?:\([^)]*\))?[^,]*)""",
)

# conformance diagnostics: when set (lowering_diagnostics()), every df
# construct the lowering does NOT recognize and every df argument whose
# value expression fails to evaluate is recorded here instead of being
# silently approximated — the MDL-SDK-parity audit hook
# (MdlMaterialCompiler.cpp:193-266 compiles everything; the test suite
# asserts the bundled corpus triggers none of these).
_DIAG: list[str] | None = None


class lowering_diagnostics:
    """Context manager capturing unrecognized-construct reports."""

    def __init__(self) -> None:
        self.records: list[str] = []

    def __enter__(self) -> "lowering_diagnostics":
        global _DIAG
        self._prev = _DIAG
        _DIAG = self.records
        return self

    def __exit__(self, *exc) -> None:
        global _DIAG
        _DIAG = self._prev


def _diag(msg: str) -> None:
    if _DIAG is not None:
        _DIAG.append(msg)


def _parse_mdl_value(text: str) -> Any:
    text = text.strip().rstrip(",").strip()
    m = re.match(r"color\s*\(([^)]*)\)$", text)
    if m and not re.search(r"[A-Za-z_]", m.group(1)):
        # literal components only; expressions (identifiers, nested
        # calls) go through the _BodyEval color branch instead
        parts = [float(x) for x in re.findall(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?", m.group(1))]
        if len(parts) == 1:
            parts = parts * 3
        return tuple((parts + [0.0, 0.0, 0.0])[:3])
    m = re.match(r'texture_2d\s*\(\s*"([^"]*)"', text)
    if m:
        return ("__texture__", m.group(1))
    if text in ("true", "false"):
        return text == "true"
    m = re.match(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?f?$", text)
    if m:
        return float(text.rstrip("f"))
    m = re.match(r"float\s*\(([^)]*)\)", text)
    if m:
        try:
            return float(m.group(1))
        except ValueError:
            return 0.0
    return None




# ---------------------------------------------------------------------------
# procedural body lowering (subset)
# ---------------------------------------------------------------------------

def _balanced(text: str, start: int) -> int:
    """Index just past the paren block opening at text[start] == '('."""
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "(":
            depth += 1
        elif text[i] == ")":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def _split_args(text: str) -> list[str]:
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _parse_call(text: str):
    """'ns::fn(a: x, b: y(...))' -> (fn, {a: 'x', b: 'y(...)'}, [positional]).
    Returns None for non-call expressions."""
    text = text.strip()
    m = re.match(r"([\w:]+)\s*\(", text)
    if not m:
        return None
    name = m.group(1).split("::")[-1]
    end = _balanced(text, m.end() - 1)
    inner = text[m.end():end - 1]
    named: dict[str, str] = {}
    positional: list[str] = []
    for arg in _split_args(inner):
        # named-arg detection must not trip over qualified calls
        # (math::min(...) is positional, not named "math")
        am = re.match(r"(\w+)\s*:(?!:)\s*(.+)$", arg, re.DOTALL)
        if am:
            named[am.group(1)] = am.group(2).strip()
        else:
            positional.append(arg)
    return name, named, positional


class _BodyEval:
    """Evaluates MDL body value expressions against the parameter defaults
    and `let` bindings. Anything unresolvable evaluates to None."""

    def __init__(self, params: dict, lets: dict[str, str]):
        self.params = params
        self.lets = lets

    def value(self, expr: str | None, depth: int = 0):
        if expr is None or depth > 8:
            return None
        expr = expr.strip()
        v = _parse_mdl_value(expr)
        if v is not None:
            return v
        if expr in self.params:
            return self.params[expr]
        if expr in self.lets:
            return self.value(self.lets[expr], depth + 1)
        # top-level sums then products (common: tint * brightness,
        # 0.30 + 0.35 * redness)
        sparts = ([] if re.search(r"[eE]\+", expr)
                  else _split_top(expr, "+"))
        if len(sparts) > 1:
            vals = [self.value(p, depth + 1) for p in sparts]
            if all(v is not None for v in vals):
                out = 0.0
                for v in vals:
                    if isinstance(v, tuple) and isinstance(out, tuple):
                        out = tuple(a + b for a, b in zip(out, v))
                    elif isinstance(v, tuple):
                        out = tuple(out + c for c in v)
                    elif isinstance(out, tuple):
                        out = tuple(c + v for c in out)
                    else:
                        out = out + v
                return out
        parts = _split_top(expr, "*")
        if len(parts) > 1:
            vals = [self.value(p, depth + 1) for p in parts]
            if all(v is not None for v in vals):
                out = 1.0
                for v in vals:
                    if isinstance(v, tuple) and isinstance(out, tuple):
                        out = tuple(a * b for a, b in zip(out, v))
                    elif isinstance(v, tuple):
                        out = tuple(out * c for c in v)
                    elif isinstance(out, tuple):
                        out = tuple(c * v for c in out)
                    else:
                        out = out * v
                return out
        c = _parse_call(expr)
        if c and c[0] == "color":
            args = [self.value(a, depth + 1) for a in c[2]]
            if len(args) == 1 and isinstance(args[0], (int, float)):
                return (float(args[0]),) * 3
            if len(args) == 3 and all(
                    isinstance(a, (int, float)) for a in args):
                return tuple(float(a) for a in args)
        if c and c[0] in ("lerp", "min", "max", "clamp", "saturate",
                          "pow", "sqrt", "abs", "float"):
            # the ::math:: subset the bundled corpus uses in let bindings
            args = [self.value(a, depth + 1) for a in c[2]] + [
                self.value(a, depth + 1) for a in c[1].values()]
            if any(a is None for a in args):
                return None

            def _zip(f, *vs):
                if any(isinstance(v, tuple) for v in vs):
                    vs = [v if isinstance(v, tuple) else (float(v),) * 3
                          for v in vs]
                    return tuple(f(*c_) for c_ in zip(*vs))
                return f(*vs)

            try:
                if c[0] == "lerp" and len(args) == 3:
                    return _zip(lambda a, b, t: a + (b - a) * t, *args)
                if c[0] == "min" and len(args) == 2:
                    return _zip(min, *args)
                if c[0] == "max" and len(args) == 2:
                    return _zip(max, *args)
                if c[0] == "clamp" and len(args) == 3:
                    return _zip(lambda x, lo, hi: min(max(x, lo), hi), *args)
                if c[0] == "saturate" and len(args) == 1:
                    return _zip(lambda x: min(max(x, 0.0), 1.0), *args)
                if c[0] == "pow" and len(args) == 2:
                    return _zip(lambda x, y: float(x) ** float(y), *args)
                if c[0] == "sqrt" and len(args) == 1:
                    return _zip(lambda x: float(x) ** 0.5, *args)
                if c[0] == "abs" and len(args) == 1:
                    return _zip(abs, *args)
                if c[0] == "float" and len(args) == 1:
                    a = args[0]
                    return float(a[0] if isinstance(a, tuple) else a)
            except (TypeError, ValueError):
                return None
        return None


def _split_top(text: str, sep: str) -> list[str]:
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _lower_bsdf(expr: str, ev: _BodyEval, out: dict, depth: int = 0) -> None:
    """Map an MDL df expression tree onto the uber-BSDF parameters
    (reference compiles these through the MDL SDK GLSL backend,
    Backend.cpp:276-287; this covers the common df zoo textually)."""
    if depth > 8:
        return
    expr = expr.strip()
    if expr in ev.lets:
        return _lower_bsdf(ev.lets[expr], ev, out, depth + 1)
    c = _parse_call(expr)
    if not c:
        if expr:
            _diag(f"df expression {expr[:60]!r} is not a recognized "
                  "construct")
        return
    name, named, _pos = c
    if name == "diffuse_reflection_bsdf":
        tint = ev.value(named.get("tint"))
        if tint is not None:
            out["base_color"] = tint if isinstance(tint, tuple) else (tint,) * 3
        elif "tint" in named:
            _diag(f"diffuse tint expression {named['tint']!r} did not "
                  "evaluate")
        out.setdefault("roughness", 1.0)
        out["metallic"] = 0.0
    elif name in ("microfacet_ggx_smith_bsdf", "microfacet_beckmann_smith_bsdf",
                  "simple_glossy_bsdf", "microfacet_ggx_vcavities_bsdf",
                  "backscattering_glossy_reflection_bsdf", "ward_geisler_moroder_bsdf"):
        r = ev.value(named.get("roughness_u"))
        rv = ev.value(named.get("roughness_v"))
        if isinstance(r, (int, float)):
            # MDL microfacet roughness_u is the squared slope (alpha^2-like);
            # the uber-BSDF squares its roughness once -> sqrt here
            au = float(r) ** 0.5
            if isinstance(rv, (int, float)) and rv != r:
                # distinct u/v slopes: invert the Disney aspect mapping
                # (ax = a/aspect, ay = a*aspect, aspect^2 = 1 - 0.9*aniso)
                av_ = float(rv) ** 0.5
                hi, lo = max(au, av_), max(min(au, av_), 1e-6)
                aspect2 = lo / hi
                out["roughness"] = (au * av_) ** 0.25 if au * av_ > 0 else 0.0
                out["anisotropy"] = min(max((1.0 - aspect2) / 0.9, 0.0), 1.0)
            else:
                out["roughness"] = au
        elif "roughness_u" in named:
            _diag(f"microfacet roughness_u expression "
                  f"{named['roughness_u']!r} did not evaluate")
        for mdl_name, uber in (("anisotropy", "anisotropy"),
                               ("anisotropy_rotation", "anisotropy_rotation")):
            av = ev.value(named.get(mdl_name))
            if isinstance(av, (int, float)) and av:
                out[uber] = float(av)
        tint = ev.value(named.get("tint"))
        if tint is None and "tint" in named:
            _diag(f"microfacet tint expression {named['tint']!r} "
                  "did not evaluate")
        mode = named.get("mode", "")
        if "transmit" in mode:
            out["transmission"] = 1.0
        elif tint is not None:
            # reflective tinted microfacet: metallic-workflow reflection color
            out["base_color"] = tint if isinstance(tint, tuple) else (tint,) * 3
            out["metallic"] = 1.0
    elif name == "specular_bsdf":
        mode = named.get("mode", "")
        if "transmit" in mode:
            out["transmission"] = 1.0
        out["roughness"] = 0.0
    elif name == "fresnel_layer":
        ior = ev.value(named.get("ior"))
        if isinstance(ior, tuple):
            ior = ior[0]
        if isinstance(ior, (int, float)):
            out["ior"] = float(ior)
        # dielectric coat: keep the base diffuse, take the layer's roughness
        if "base" in named:
            _lower_bsdf(named["base"], ev, out, depth + 1)
        if "layer" in named:
            layer: dict = {}
            _lower_bsdf(named["layer"], ev, layer, depth + 1)
            if "roughness" in layer:
                out["roughness"] = layer["roughness"]
            if layer.get("transmission"):
                out["transmission"] = layer["transmission"]
        out["metallic"] = out.get("metallic", 0.0) * 0.0  # dielectric
    elif name in ("weighted_layer", "custom_curve_layer"):
        if "base" in named:
            _lower_bsdf(named["base"], ev, out, depth + 1)
        if "layer" in named:
            layer = {}
            _lower_bsdf(named["layer"], ev, layer, depth + 1)
            w = ev.value(named.get("weight"))
            w = float(w) if isinstance(w, (int, float)) else 1.0
            if "roughness" in layer:
                # weight-lerp: a weight-0 layer must not stomp the base
                base_r = out.get("roughness")
                out["roughness"] = (layer["roughness"] if base_r is None
                                    else (1 - w) * base_r + w * layer["roughness"])
            if layer.get("transmission"):
                out["transmission"] = w * layer["transmission"]
            if layer.get("metallic") and w > 0.5:
                out["metallic"] = layer["metallic"]
                if "base_color" in layer:
                    out["base_color"] = layer["base_color"]
    elif name in ("normalized_mix", "clamped_mix", "unbounded_mix"):
        comps = named.get("components", "")
        cm = re.findall(r"bsdf_component\s*\(([^;]*?)\)\s*(?:,|\]|$)", comps)
        for comp in cm:
            sub = _parse_call("bsdf_component(" + comp + ")")
            if sub and "component" in sub[1]:
                _lower_bsdf(sub[1]["component"], ev, out, depth + 1)
    elif name == "tint":
        t = ev.value(named.get("color"))
        if t is not None:
            out["base_color"] = t if isinstance(t, tuple) else (t,) * 3
        elif "color" in named:
            _diag(f"tint color expression {named['color']!r} did not "
                  "evaluate")
        if "base" in named:
            _lower_bsdf(named["base"], ev, out, depth + 1)
    elif name == "diffuse_transmission_bsdf":
        # translucency: diffuse pass-through — carried as thin-walled
        # transmission with a rough interface (closest uber analog)
        t = ev.value(named.get("tint"))
        if t is not None:
            out["base_color"] = t if isinstance(t, tuple) else (t,) * 3
        out["transmission"] = 1.0
        out["thin_walled"] = 1
        out.setdefault("roughness", 1.0)
    elif name in ("bsdf", "edf", "vdf", "hair_bsdf"):
        pass  # empty default distributions: no scattering contribution
    elif name in ("directional_factor", "measured_curve_factor",
                  "thin_film"):
        # modifier wrappers: lower the wrapped base unchanged
        if "base" in named:
            _lower_bsdf(named["base"], ev, out, depth + 1)
        else:
            _diag(f"df modifier {name} without base")
    else:
        _diag(f"unrecognized df construct {name}")


def _resolve_module(qualifier: str, base_dir: str = "") -> str | None:
    """MDL module qualifier ('::nvidia::core_definitions') -> module file.
    Search order mirrors resolve_mdl_path: asset dir, GATLING_MDL_PATHS,
    bundled modules (the MdlEntityResolver analog, MdlEntityResolver.cpp)."""
    rel = os.path.join(*[p for p in qualifier.split("::") if p]) + ".mdl"
    candidates = []
    if base_dir:
        candidates.append(os.path.join(base_dir, rel))
    for d in os.environ.get("GATLING_MDL_PATHS", "").split(os.pathsep):
        if d:
            candidates.append(os.path.join(d, rel))
    candidates.append(os.path.join(BUNDLED_MDL_DIR, rel))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


_BUILTIN_MODULES = ("df", "state", "math", "base", "tex", "anno", "limits",
                    "scene", "debug", "std")


def _lower_instance_call(caller_src: str, expr: str, ev: "_BodyEval",
                         base_dir: str = "", depth: int = 0) -> dict:
    """Lower a material-INSTANCE body: `export material X(...) =
    some::module::base_material(args...)` — the dominant pattern in
    TurboSquid/Omniverse assets built on ::nvidia::core_definitions or the
    Omni* modules. Resolves the called material in the imported/bundled
    module set, binds the evaluated arguments over its parameter defaults,
    and recursively lowers the callee's own body. Material-valued arguments
    (wrapper materials like add_emission(base: ...)) lower recursively; on
    key conflicts the BASE material wins for scattering parameters and the
    wrapper wins for what it adds (emission).

    Reference: the MDL SDK resolves instantiations through
    MdlEntityResolver + instance compilation (MdlMaterialCompiler.cpp:
    193-266); the bundled module set is src/gi/mdl (rendererPlugin.cpp:
    54-55)."""
    if depth > 4:
        return {}
    expr = expr.strip()
    m = re.match(r"([\w:]+)\s*\(", expr)
    if not m:
        return {}
    parts = [p for p in m.group(1).split("::") if p]
    mat_name = parts[-1]
    if parts[0] in _BUILTIN_MODULES or mat_name in ("material", "color"):
        return {}
    mod_srcs: list[tuple[str, str]] = []

    def add_module(path: str | None) -> None:
        if path:
            try:
                with open(path, "r", encoding="utf-8", errors="replace") as f:
                    mod_srcs.append((f.read(), os.path.dirname(path)))
            except OSError:
                get_logger().error("cannot read MDL module %s", path)

    if len(parts) > 1:
        add_module(_resolve_module("::".join(parts[:-1]), base_dir))
    else:
        # unqualified: the caller's own module, then star imports
        mod_srcs.append((caller_src, base_dir))
        for im in re.finditer(r"^\s*import\s+(?:::)?([\w:]+)::\*\s*;",
                              caller_src, re.M):
            q = im.group(1)
            if q.split("::")[0] not in _BUILTIN_MODULES:
                add_module(_resolve_module(q, base_dir))
    call = _parse_call(expr)
    if not call:
        return {}
    _n, named, positional = call

    for src, mdir in mod_srcs:
        if not re.search(r"export\s+material\s+%s\s*\(" % re.escape(mat_name),
                         src):
            continue
        defaults = _extract_material_params(src, mat_name)
        bound = dict(defaults)
        keys = list(defaults.keys())
        nested: list[dict] = []

        def bind(key: str | None, argtext: str) -> None:
            v = ev.value(argtext)
            if v is None and re.match(r"[\w:]+\s*\(", argtext.strip()):
                sub = _lower_instance_call(caller_src, argtext, ev,
                                           base_dir, depth + 1)
                if sub:
                    nested.append(sub)
                    return
            if v is not None and key is not None:
                bound[key] = v

        for i, argtext in enumerate(positional):
            bind(keys[i] if i < len(keys) else None, argtext)
        for k, argtext in named.items():
            bind(k if k in defaults else None, argtext)

        out: dict = {}
        # the callee's (now-bound) parameters run through the well-known
        # name map so texture/scalar params surface even when its body's df
        # graph is only partially recognizable
        for mdl_name, value in bound.items():
            mapping = _PARAM_MAP.get(mdl_name)
            if mapping is None:
                continue
            uber, _kind = mapping
            if isinstance(value, tuple) and value and value[0] == "__texture__":
                tex_path = value[1]
                if tex_path and not os.path.isabs(tex_path):
                    tex_path = os.path.join(mdir, tex_path)
                if tex_path:
                    out[uber if uber.endswith("_texture")
                        else uber + "_texture"] = tex_path
            else:
                out[uber] = value
        out.update(_lower_mdl_body(src, mat_name, bound, base_dir=mdir))
        for sub in nested:
            emis = {k: v for k, v in out.items() if k.startswith("emissive")}
            out.update(sub)       # base material wins for scattering keys
            out.update(emis)      # wrapper wins for what it adds
        return out
    if depth == 0:
        get_logger().info(
            "MDL instance call %s:: %s not resolved; parameter-name mapping "
            "applies", "::".join(parts[:-1]), mat_name)
    return {}


def _lower_mdl_body(source: str, sub_identifier: str | None,
                    params: dict, base_dir: str = "") -> dict:
    """Extract the material body expression and lower its df graph to
    uber-BSDF inputs. Returns {} when no recognizable body exists (the
    parameter-name mapping then applies instead)."""
    pat = re.compile(r"export\s+material\s+(\w+)\s*\(")
    for m in pat.finditer(source):
        if sub_identifier and m.group(1) != sub_identifier:
            continue
        end_params = _balanced(source, source.index("(", m.start()))
        rest = source[end_params:]
        em = re.match(r"\s*(?:\[\[[^\]]*\]\]\s*)?=\s*", rest, re.DOTALL)
        if not em:
            return {}
        body = rest[em.end():]
        # bound the body expression at its terminating top-level ';' so a
        # later material in the same file can't bleed into the lowering
        depth0 = 0
        for i, ch in enumerate(body):
            if ch in "([{":
                depth0 += 1
            elif ch in ")]}":
                depth0 -= 1
            elif ch == ";" and depth0 == 0:
                body = body[:i]
                break
        # strip // and /* */ comments (preserving string literals) so let
        # bindings and df args with leading comment lines still parse
        body = re.sub(
            r'("(?:[^"\\]|\\.)*")|/\*.*?\*/|//[^\n]*',
            lambda m: m.group(1) or "", body, flags=re.DOTALL)
        lets: dict[str, str] = {}
        lm = re.match(r"\s*let\s*\{", body)
        if lm:
            close = body.index("}", lm.end() - 1)
            # crude but effective: let bindings are `type name = expr;`
            scan = body[lm.end():]
            depth = 0
            end_let = 0
            for i, ch in enumerate(scan):
                if ch == "{":
                    depth += 1
                elif ch == "}":
                    if depth == 0:
                        end_let = i
                        break
                    depth -= 1
            let_text = scan[:end_let]
            for stmt in let_text.split(";"):
                sm = re.match(r"\s*[\w:]+\s+(\w+)\s*=\s*(.+)$", stmt.strip(), re.DOTALL)
                if sm:
                    lets[sm.group(1)] = sm.group(2).strip()
            body = scan[end_let + 1:]
            im = re.search(r"\bin\b", body)
            if im:
                body = body[im.end():]
        mm = re.search(r"\bmaterial\s*\(", body)
        if not mm:
            # not a literal material(...) constructor: try a material
            # instantiation of an imported module's material
            return _lower_instance_call(
                source, body, _BodyEval(params, lets), base_dir)
        mat_expr = body[mm.start():_balanced(body, body.index("(", mm.start()))]
        call = _parse_call(mat_expr)
        if not call:
            return {}
        _name, named, _pos = call
        ev = _BodyEval(params, lets)
        out: dict = {}

        if "thin_walled" in named:
            tw = ev.value(named["thin_walled"])
            if tw is not None:
                out["thin_walled"] = int(bool(tw))
        if "ior" in named:
            v = ev.value(named["ior"])
            if isinstance(v, tuple):
                v = v[0]
            if isinstance(v, (int, float)):
                out["ior"] = float(v)

        def lower_surface(surf_expr: str, dst: dict) -> None:
            sc = (_parse_call(surf_expr.strip())
                  if "material_surface" in surf_expr else None)
            if not sc:
                return
            if "scattering" in sc[1]:
                _lower_bsdf(sc[1]["scattering"], ev, dst)
            emis = sc[1].get("emission")
            if emis and "material_emission" in emis:
                ec = _parse_call(emis.strip())
                if ec:
                    edf = _parse_call((ec[1].get("emission") or "").strip())
                    escale = (1.0,) * 3
                    if edf:
                        if edf[0] in ("diffuse_edf", "edf"):
                            pass  # lambertian emitter: the uber EDF
                        elif edf[0] == "tint" and "color" in edf[1]:
                            tv = ev.value(edf[1]["color"])
                            if isinstance(tv, tuple):
                                escale = tv
                        else:
                            _diag(f"unrecognized edf construct {edf[0]}")
                    inten = ev.value(ec[1].get("intensity"))
                    if inten is None and "intensity" in ec[1]:
                        _diag("emission intensity expression "
                              f"{ec[1]['intensity']!r} did not evaluate")
                    if inten is not None:
                        inten = (inten if isinstance(inten, tuple)
                                 else (float(inten),) * 3)
                        dst["emissive_color"] = tuple(
                            a * b for a, b in zip(inten, escale))
                        dst["emissive_intensity"] = 1.0

        surf = named.get("surface")
        if surf:
            lower_surface(surf, out)
        # distinct backface surface (MDL `backface:` field): lowered into
        # its own parameter dict; build_material_table appends a second
        # material row the integrator selects on back-facing hits
        # (reference: Backend.cpp DF_NAMES backface scattering/emission,
        # Frontend.cpp:104-121)
        bface = named.get("backface")
        if bface:
            bf_out: dict = {}
            lower_surface(bface, bf_out)
            if bf_out:
                out["__backface__"] = bf_out
        vol = named.get("volume")
        if vol and "material_volume" in vol:
            vc = _parse_call(vol.strip())
            if vc:
                a = ev.value(vc[1].get("absorption_coefficient"))
                s = ev.value(vc[1].get("scattering_coefficient"))
                if isinstance(a, tuple):
                    out["volume_absorption"] = a
                if isinstance(s, tuple):
                    out["volume_scattering"] = s
        geo = named.get("geometry")
        if geo and "material_geometry" in geo:
            gc = _parse_call(geo.strip())
            if gc:
                co = ev.value(gc[1].get("cutout_opacity"))
                if isinstance(co, (int, float)):
                    out["opacity"] = float(co)
        return out
    return {}


def _extract_material_params(source: str, sub_identifier: str | None) -> dict[str, Any]:
    """Find `export material <name>(<params>)` and parse parameter defaults."""
    pattern = re.compile(
        r"export\s+material\s+(\w+)\s*\(", re.MULTILINE)
    for m in pattern.finditer(source):
        name = m.group(1)
        if sub_identifier and name != sub_identifier:
            continue
        # balanced-paren scan for the parameter list
        depth = 1
        i = m.end()
        while i < len(source) and depth > 0:
            if source[i] == "(":
                depth += 1
            elif source[i] == ")":
                depth -= 1
            i += 1
        param_text = source[m.end():i - 1]
        params: dict[str, Any] = {}
        # split top-level commas
        parts, depth, start = [], 0, 0
        for j, ch in enumerate(param_text):
            if ch in "([":
                depth += 1
            elif ch in ")]":
                depth -= 1
            elif ch == "," and depth == 0:
                parts.append(param_text[start:j])
                start = j + 1
        parts.append(param_text[start:])
        for part in parts:
            pm = re.search(r"(\w+)\s*=\s*(.+)", part, re.DOTALL)
            if not pm:
                continue
            val = _parse_mdl_value(pm.group(2))
            if val is not None:
                params[pm.group(1)] = val
        return params
    return {}


BUNDLED_MDL_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mdl")


def resolve_mdl_path(file_path: str, base_dir: str = "") -> str:
    """MDL module resolution: the given path, then GATLING_MDL_PATHS
    entries, then the bundled Omni-compatible modules (the search-path
    analog of MdlRuntime's configured module paths + the reference's
    bundled src/gi/mdl, rendererPlugin.cpp:45-73)."""
    candidates = [file_path]
    if base_dir and not os.path.isabs(file_path):
        candidates.insert(0, os.path.join(base_dir, file_path))
    fname = os.path.basename(file_path)
    for d in os.environ.get("GATLING_MDL_PATHS", "").split(os.pathsep):
        if d:
            candidates.append(os.path.join(d, fname))
    candidates.append(os.path.join(BUNDLED_MDL_DIR, fname))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return file_path


def load_mdl_material(
    file_path: str | os.PathLike,
    sub_identifier: str | None = None,
    user_params: dict[str, Any] | None = None,
    name: str = "mdl",
    base_dir: str = "",
) -> MaterialDesc:
    """giCreateMaterialFromMdlFile analog: .mdl file + subIdentifier +
    typed parameter overrides -> material network."""
    file_path = resolve_mdl_path(str(file_path), base_dir)
    try:
        with open(file_path, "r", encoding="utf-8", errors="replace") as f:
            source = f.read()
        defaults = _extract_material_params(source, sub_identifier)
    except OSError:
        get_logger().error("cannot read MDL file %s", file_path)
        defaults = {}
        source = ""
    merged = dict(defaults)
    merged.update(user_params or {})

    # backface trait detection (reference: Frontend.cpp:104-121
    # _HasCompiledMaterialBackface{Bsdf,Edf}): a `backface:` field whose
    # expression names a scattering df / an emission edf
    has_backface_bsdf = False
    has_backface_edf = False
    bf = re.search(r"backface\s*:\s*material_surface\s*\(", source)
    if bf:
        depth, i = 1, bf.end()
        while i < len(source) and depth > 0:
            if source[i] == "(":
                depth += 1
            elif source[i] == ")":
                depth -= 1
            i += 1
        bf_text = source[bf.end():i - 1]
        has_backface_bsdf = "scattering" in bf_text or "bsdf" in bf_text
        has_backface_edf = "emission" in bf_text or "edf" in bf_text

    base_dir = os.path.dirname(os.path.abspath(file_path))
    inputs: dict[str, Any] = {}
    textures: dict[str, str] = {}
    for mdl_name, value in merged.items():
        mapping = _PARAM_MAP.get(mdl_name)
        if mapping is None:
            continue
        uber, kind = mapping
        if isinstance(value, tuple) and value and value[0] == "__texture__":
            tex_path = value[1]
            if not os.path.isabs(tex_path):
                tex_path = os.path.join(base_dir, tex_path)
            textures[uber if uber.endswith("_texture") else uber + "_texture"] = tex_path
        else:
            inputs[uber] = value

    # procedural body lowering: when the material body's df graph is
    # recognizable, its values override the parameter-NAME heuristics
    # (reference: MdlMaterialCompiler instance-compiles the body,
    # MdlMaterialCompiler.cpp:193-266)
    body = _lower_mdl_body(source, sub_identifier, merged, base_dir=base_dir)
    backface_body = body.pop("__backface__", None)
    for k, v in body.items():
        inputs[k] = v
    if backface_body is not None:
        # fold backface emission the same way as the front's post-process;
        # bsdf params stay in uber names (material.py merges them over the
        # front params for the appended backface row)
        bf = dict(backface_body)
        ec = bf.pop("emissive_color", None)
        ei = bf.pop("emissive_intensity", 1.0)
        if ec is not None:
            bf["emissive"] = tuple(float(c) * float(ei) for c in ec)
        inputs["backface_params"] = bf

    # post-process gates (OmniPBR semantics)
    if not inputs.pop("enable_emission", True):
        inputs.pop("emissive_color", None)
        inputs.pop("emissive_intensity", None)
    emissive_color = inputs.pop("emissive_color", None)
    emissive_intensity = inputs.pop("emissive_intensity", 1.0)
    if emissive_color is not None:
        inputs["emissive"] = tuple(float(c) * float(emissive_intensity) for c in emissive_color)
    if not inputs.pop("enable_opacity", True):
        inputs.pop("opacity", None)
    if "transmission_color" in inputs:  # OmniGlass: tinted transmission
        tint = inputs.pop("transmission_color")
        inputs["transmission"] = 1.0
        # tint via volume absorption: sigma_a = -ln(color)
        import math
        inputs["volume_absorption"] = tuple(
            -math.log(max(min(float(c), 0.999), 1e-3)) for c in tint)
    if not inputs.pop("enable_transmission", True):
        inputs.pop("transmission", None)

    if has_backface_bsdf:
        inputs["has_backface_bsdf"] = True
    if has_backface_edf:
        inputs["has_backface_edf"] = True
    node = ShaderNode(path=f"/{name}/shader", shader_id="gatling_uber",
                      inputs={**inputs, **{k: v for k, v in textures.items()}},
                      input_connections={})
    return MaterialDesc(path=f"/{name}", surface_node=node.path,
                        nodes={node.path: node}, base_dir=base_dir)
