"""Shader node graphs -> a constant, or an affine function of one texture.

The part of the JAX package's render/shadergraph.py that the fused kernels
consume: a material input folds to

    GraphValue = constant rgba                (no texture in the subtree)
               | s * T + b over one texture   (the pool's per-slot affine)

through UsdUVTexture / image / tiledimage leaves, constant, multiply,
divide, add, subtract, mix, clamp over constants, convert, swizzle /
extract and normalmap. Where the JAX package keeps an exact subtree (an
Expr) instead, the port raises: composites of two textures and non-affine
math over a texture, which the JAX package bakes into a texture, and
procedural or frame-dependent nodes (ROADMAP: 'USD content'); view-,
normal- and primvar-dependent leaves, which its wavefront integrator
evaluates per hit (ROADMAP: 'Wavefront integrator'). Unknown nodes fall
back to the input's default, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from gatling_tpu_torch.render.texture import TextureRef
from gatling_tpu_torch.utils.log import get_logger

_CH = {"r": 0, "g": 1, "b": 2, "a": 3}
_WRAP_MAP = {"periodic": "repeat", "clamp": "clamp", "mirror": "mirror", "constant": "black"}
# MaterialX nodedef-name type suffixes (ND_<node>_<outtype>[_<intype>])
_ND_TYPE_TOKENS = {
    "float", "color3", "color4", "vector2", "vector3", "vector4", "integer",
    "boolean", "string", "filename", "surfaceshader", "displacementshader",
    "matrix33", "matrix44", "color3FA", "color4FA", "vector2FA", "vector3FA",
    "vector4FA",
}
_BAKED = ("clamp", "dotproduct", "absval", "power", "frame", "time", "texcoord",
          "checkerboard", "ramplr", "ramptb", "ramp4", "noise2d", "noise3d", "fractal3d",
          "cellnoise2d", "cellnoise3d", "worleynoise2d", "worleynoise3d")
_DYNAMIC = ("viewdirection", "normal", "geompropvalue")


def _vec4(v: Any, default=(0.0, 0.0, 0.0, 1.0)) -> tuple[float, float, float, float]:
    if v is None:
        return tuple(default)
    if isinstance(v, (int, float, bool)):
        f = float(v)
        return (f, f, f, f)
    v = tuple(float(x) for x in v)
    return (v + (0.0, 0.0, 0.0, 1.0))[:4]


def _baked(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"shader graph: {what} needs a baked composite texture, which is not ported "
        "yet (ROADMAP: 'USD content')")


@dataclasses.dataclass(frozen=True)
class GraphValue:
    """A lowered subtree: an rgba constant, optionally over one texture via
    the pool's affine (value = sample * scale + bias; `constant` is the
    connection's fallback value)."""

    constant: tuple[float, float, float, float]
    texture: TextureRef | None = None

    def with_affine(self, scale=(1, 1, 1, 1), bias=(0, 0, 0, 0)) -> "GraphValue":
        """Compose value -> value * scale + bias."""
        s = _vec4(scale, (1, 1, 1, 1))
        b = _vec4(bias, (0, 0, 0, 0))
        const = tuple(c * sc + bc for c, sc, bc in zip(self.constant, s, b))
        if self.texture is None:
            return GraphValue(constant=const)
        ts = tuple(a * b2 for a, b2 in zip(self.texture.scale, s))
        tb = tuple(a * s2 + b2 for a, s2, b2 in zip(self.texture.bias, s, b))
        return GraphValue(constant=const,
                          texture=dataclasses.replace(self.texture, scale=ts, bias=tb))


def _binary(op: str, a: GraphValue, b: GraphValue, node_id: str) -> GraphValue:
    """Fold a binary node while it stays affine in one texture."""
    if (a.texture is not None and b.texture is not None) or (op == "divide"
                                                             and b.texture is not None):
        raise _baked(f"{node_id} (not affine in one texture)")
    if op == "multiply":
        if b.texture is not None:
            a, b = b, a
        return a.with_affine(scale=b.constant)
    if op == "divide":
        inv = tuple(1.0 / c if c != 0.0 else 0.0 for c in b.constant)
        return a.with_affine(scale=inv)
    if op == "add":
        if b.texture is not None:
            a, b = b, a
        return a.with_affine(bias=b.constant)
    if op == "subtract":
        if b.texture is not None:
            # a - (s*T + t_b) = -1*(s*T + t_b) + a
            return b.with_affine(scale=(-1, -1, -1, -1), bias=a.constant)
        return a.with_affine(bias=tuple(-c for c in b.constant))
    raise ValueError(op)


def _mix(fg: GraphValue, bg: GraphValue, mix: GraphValue, node_id: str) -> GraphValue:
    """MaterialX mix: out = fg*mix + bg*(1-mix), affine when at most one
    operand carries a texture and the factor is constant."""
    if sum(v.texture is not None for v in (fg, bg, mix)) > 1 or mix.texture is not None:
        raise _baked(f"{node_id} (not affine in one texture)")
    m = mix.constant
    one_m = tuple(1.0 - c for c in m)
    if bg.texture is not None:
        return bg.with_affine(scale=one_m, bias=tuple(f * c for f, c in zip(fg.constant, m)))
    return fg.with_affine(scale=m, bias=tuple(b * c for b, c in zip(bg.constant, one_m)))


def normalize_shader_id(sid: str) -> str:
    """`ND_multiply_color3` -> `multiply` (MaterialX nodedef names)."""
    if not sid.startswith("ND_"):
        return sid
    parts = sid[3:].split("_")
    while len(parts) > 1 and parts[-1] in _ND_TYPE_TOKENS:
        parts.pop()
    return "_".join(parts)


class GraphLowering:
    """Recursive evaluator over one material's node dict."""

    def __init__(self, desc) -> None:
        self.desc = desc
        self._stack: list[str] = []  # cycle guard

    def _resolve_path(self, path: str) -> str:
        if self.desc.base_dir and not os.path.isabs(path):
            return os.path.join(self.desc.base_dir, path)
        return path

    def eval_input(self, node, name: str, default, color_hint: bool) -> GraphValue:
        """One shader input: a constant, or the lowered subtree of its
        connected node."""
        if name in node.input_connections:
            target_path, out_name = node.input_connections[name]
            target = self.desc.nodes.get(target_path)
            if target is None:
                return GraphValue(constant=_vec4(default))
            return self.eval_node(target, out_name, default, color_hint)
        if name in node.inputs:
            return GraphValue(constant=_vec4(node.inputs[name]))
        return GraphValue(constant=_vec4(default))

    def eval_node(self, node, out_name: str, default, color_hint: bool) -> GraphValue:
        if node.path in self._stack:
            get_logger().warning("shader graph: cycle at %s", node.path)
            return GraphValue(constant=_vec4(default))
        self._stack.append(node.path)
        try:
            return self._eval_node(node, out_name, default, color_hint)
        finally:
            self._stack.pop()

    def _leaf_texture(self, node, out_name: str, default, color_hint: bool,
                      usd: bool) -> GraphValue:
        tex_file = node.inputs.get("file")
        if usd:
            fallback = node.inputs.get("fallback", default)
            cs = str(node.inputs.get("sourceColorSpace", "auto"))
            # 'auto': colour inputs default to sRGB, data inputs to raw
            is_srgb = cs == "sRGB" or (cs == "auto" and color_hint)
        else:
            fallback = node.inputs.get("default", default)
            cs = str(node.inputs.get("colorspace", ""))
            is_srgb = cs in ("srgb_texture", "sRGB") or (not cs and color_hint)
        if not tex_file:
            return GraphValue(constant=_vec4(fallback))
        channel = out_name if out_name in _CH else "rgb"
        if usd:
            ref = TextureRef(
                file_path=self._resolve_path(str(tex_file)), is_srgb=is_srgb,
                wrap_s=str(node.inputs.get("wrapS", "useMetadata")),
                wrap_t=str(node.inputs.get("wrapT", "useMetadata")),
                scale=_vec4(node.inputs.get("scale"), (1, 1, 1, 1)),
                bias=_vec4(node.inputs.get("bias"), (0, 0, 0, 0)), channel=channel)
        else:
            ref = TextureRef(
                file_path=self._resolve_path(str(tex_file)), is_srgb=is_srgb,
                wrap_s=_WRAP_MAP.get(str(node.inputs.get("uaddressmode", "periodic")), "repeat"),
                wrap_t=_WRAP_MAP.get(str(node.inputs.get("vaddressmode", "periodic")), "repeat"),
                channel=channel)
        return GraphValue(constant=_vec4(fallback), texture=ref)

    def _eval_node(self, node, out_name: str, default, color_hint: bool) -> GraphValue:
        sid = normalize_shader_id(node.shader_id)

        def ev(name, d=(0.0, 0.0, 0.0, 1.0), hint=False):
            return self.eval_input(node, name, d, hint)

        if sid == "UsdUVTexture":
            return self._leaf_texture(node, out_name, default, color_hint, usd=True)
        if sid in ("image", "tiledimage"):
            return self._leaf_texture(node, out_name, default, color_hint, usd=False)
        if sid == "constant":
            return GraphValue(constant=_vec4(node.inputs.get("value", default)))
        if sid in ("multiply", "divide", "add", "subtract"):
            a = ev("in1", hint=color_hint)
            b = ev("in2", (1.0, 1.0, 1.0, 1.0) if sid in ("multiply", "divide")
                   else (0.0, 0.0, 0.0, 0.0))
            return _binary(sid, a, b, f"{sid}@{node.path}")
        if sid == "mix":
            fg = ev("fg", hint=color_hint)
            bg = ev("bg", hint=color_hint)
            mx = ev("mix", (0.0, 0.0, 0.0, 0.0))
            return _mix(fg, bg, mx, f"mix@{node.path}")
        if sid == "clamp":
            v = ev("in", hint=color_hint)
            lo = ev("low", (0.0, 0.0, 0.0, 0.0)).constant
            hi = ev("high", (1.0, 1.0, 1.0, 1.0)).constant
            if v.texture is not None:
                raise _baked(f"clamp@{node.path} over a texture")
            return GraphValue(constant=tuple(min(max(c, l), h)
                                             for c, l, h in zip(v.constant, lo, hi)))
        if sid == "convert":
            return ev("in", default, color_hint)
        if sid in ("swizzle", "extract", "separate2", "separate3", "separate4"):
            v = ev("in", default, color_hint)
            ch = str(node.inputs.get("channels", out_name or "r")).lower()
            if len(ch) == 1 and ch in _CH:
                const = (v.constant[_CH[ch]],) * 4
                if v.texture is not None:
                    return GraphValue(constant=const,
                                      texture=dataclasses.replace(v.texture, channel=ch))
                return GraphValue(constant=const)
            return v
        if sid == "normalmap":
            v = ev("in", (0.5, 0.5, 1.0), False)
            # tangent-space decode [0, 1] -> [-1, 1] (previewSurfaceNetworkPatcher.cpp)
            return v.with_affine(scale=(2.0, 2.0, 2.0, 1.0), bias=(-1.0, -1.0, -1.0, 0.0))
        if sid in _DYNAMIC or sid.startswith("UsdPrimvarReader"):
            if sid == "normal" and node.input_connections:
                return GraphValue(constant=_vec4(default))  # the JAX package's fallback
            if sid not in ("normal", "viewdirection") and not str(
                    node.inputs.get("varname", node.inputs.get("geomprop", ""))):
                return GraphValue(constant=_vec4(node.inputs.get(
                    "fallback", node.inputs.get("default", default))))
            raise NotImplementedError(
                f"shader graph: {sid}@{node.path} is evaluated per hit by the wavefront "
                "integrator, which is not ported yet (ROADMAP: 'Wavefront integrator')")
        if sid in _BAKED:
            raise _baked(f"{sid}@{node.path}")
        get_logger().debug("shader graph: unhandled node %s (%s)", sid, node.path)
        return GraphValue(constant=_vec4(default))
