"""Shader node graphs -> a constant, an affine function of one texture, a
baked composite, or a per-hit expression.

The port of the JAX package's render/shadergraph.py. A material input
folds to

    GraphValue = constant rgba                (no texture in the subtree)
               | s * T + b over one texture   (the pool's per-slot affine)

through UsdUVTexture / image / tiledimage leaves, constant, multiply,
divide, add, subtract, mix, clamp, convert, swizzle / extract and
normalmap. Where a subtree is not affine in one texture, GraphValue.expr
carries it exactly (an `Expr`, with the affine form as its approximation),
as in the JAX package:

* a subtree with a view-, normal- or primvar-dependent leaf
  (`viewdirection`, `normal`, a named `geompropvalue` or
  `UsdPrimvarReader`; dotproduct, absval and power over it) is dynamic
  (`expr_is_dynamic`): the wavefront integrator evaluates it at every hit
  (`eval_dynamic_expr`, render/integrator.py);
* a static one (two textures in one node, non-affine math over a texture,
  a texcoord leaf, a procedural generator: checkerboard, ramps, noises,
  cell and Worley noise) is baked by the texture manager into a composite
  texture at pool-build time (render/texture.py TextureManager._eval_bake,
  render/procedural.py): one pool slot, tapped by K4 like any other.

Frame and time nodes fold to constants at the frame the material is
lowered at (`GraphLowering(desc, frame)`); gi re-lowers the materials
that hold them when the `frame` setting changes. Unknown nodes fall back
to the input's default, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

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
# procedural generator nodes: uv-space functions baked through the texture
# manager's composite path (_eval_bake), exact at texel centers, one pool
# slot at render time. 3D variants evaluate at position=(u, v, 0), the
# JAX package's documented approximation for a uv-indexed pool.
_PROC_GENERATORS = (
    "checkerboard", "ramplr", "ramptb", "ramp4", "noise2d", "noise3d",
    "fractal3d", "cellnoise2d", "cellnoise3d", "worleynoise2d",
    "worleynoise3d",
)


def _vec4(v: Any, default=(0.0, 0.0, 0.0, 1.0)) -> tuple[float, float, float, float]:
    if v is None:
        return tuple(default)
    if isinstance(v, (int, float, bool)):
        f = float(v)
        return (f, f, f, f)
    v = tuple(float(x) for x in v)
    return (v + (0.0, 0.0, 0.0, 1.0))[:4]


@dataclasses.dataclass(frozen=True)
class Expr:
    """An exact shader-graph subtree (gatling_tpu/render/shadergraph.py
    Expr). op: const | tex | multiply | divide | add | subtract | mix |
    clamp | extract | dot | abs | power, a bakeable leaf: texcoord, or a
    procedural generator (_PROC_GENERATORS: shape scalars in `const`,
    value inputs in `args`), or a dynamic leaf: viewdir (camera ->
    surface, MDL state::direction), normalvec (the shading normal),
    primvar (the primvar named by `channel`, `const` its fallback)."""

    op: str
    const: tuple[float, float, float, float] | None = None
    tex: TextureRef | None = None
    args: tuple["Expr", ...] = ()
    channel: str = ""


def _const_expr(c) -> Expr:
    return Expr(op="const", const=_vec4(c))


_DYNAMIC_LEAVES = ("viewdir", "normalvec", "primvar")


def expr_is_dynamic(e: Expr | None) -> bool:
    """The subtree reads per-hit state (a view, normal or primvar leaf)."""
    if e is None:
        return False
    return e.op in _DYNAMIC_LEAVES or any(expr_is_dynamic(a) for a in e.args)


def expr_reads_primvar(e: Expr | None) -> bool:
    """The subtree holds a primvar leaf."""
    if e is None:
        return False
    return e.op == "primvar" or any(expr_reads_primvar(a) for a in e.args)


def expr_primvar_channels(e: Expr | None) -> set:
    """The names of the subtree's primvar leaves."""
    if e is None:
        return set()
    out = {e.channel} if e.op == "primvar" else set()
    for a in e.args:
        out |= expr_primvar_channels(a)
    return out


def expr_dynamic_beyond(e: Expr | None, resolvable: set) -> bool:
    """The subtree needs per-hit evaluation: it reads the view or the
    normal, or a primvar of `resolvable` (gi's: displayColor and the
    scene's instance primvars). One whose only dynamic leaves are other
    primvars evaluates to their fallbacks and stays static."""
    if e is None:
        return False
    if e.op in ("viewdir", "normalvec"):
        return True
    if e.op == "primvar":
        return e.channel in resolvable
    return any(expr_dynamic_beyond(a, resolvable) for a in e.args)


def expr_has_texture(e: Expr | None) -> bool:
    if e is None:
        return False
    return e.op == "tex" or any(expr_has_texture(a) for a in e.args)


def eval_dynamic_expr(e: Expr, view_dir: torch.Tensor, normal: torch.Tensor,
                      primvars: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """A dynamic expression at every hit (gatling_tpu/render/shadergraph.py
    eval_dynamic_expr): view_dir (camera -> surface) and normal [N, 3];
    primvars {name: [N, 3]}. Returns [N, 4]. dot takes x, y, z and
    broadcasts to four; divide is 0 where the divisor is; power is
    pow(max(a, 0), b); the rest is elementwise. A primvar without a table
    is its fallback; a texture leaf (kept out at lowering) and an unknown
    op are (0, 0, 0, 1)."""
    n = view_dir.shape[0]
    dev = view_dir.device

    def const(c):
        return torch.tensor(c, dtype=torch.float32, device=dev).expand(n, 4)

    def pad4(v3):
        return torch.cat([v3, torch.zeros((n, 1), dtype=v3.dtype, device=dev)], dim=1)

    def ev(x: Expr) -> torch.Tensor:
        if x.op == "const":
            return const(x.const)
        if x.op == "viewdir":
            return pad4(view_dir)
        if x.op == "normalvec":
            return pad4(normal)
        if x.op == "primvar":
            if primvars and x.channel in primvars:
                return pad4(primvars[x.channel])
            return const(_vec4(x.const))
        if x.op == "dot":
            a, b = ev(x.args[0]), ev(x.args[1])
            return (a[:, :3] * b[:, :3]).sum(dim=1, keepdim=True).expand(n, 4)
        if x.op == "multiply":
            return ev(x.args[0]) * ev(x.args[1])
        if x.op == "divide":
            b = ev(x.args[1])
            return torch.where(b != 0.0, ev(x.args[0]) / torch.where(b == 0.0, 1.0, b), 0.0)
        if x.op == "add":
            return ev(x.args[0]) + ev(x.args[1])
        if x.op == "subtract":
            return ev(x.args[0]) - ev(x.args[1])
        if x.op == "mix":
            fg, bg, m = ev(x.args[0]), ev(x.args[1]), ev(x.args[2])
            return fg * m + bg * (1.0 - m)
        if x.op == "clamp":
            return torch.minimum(torch.maximum(ev(x.args[0]), ev(x.args[1])), ev(x.args[2]))
        if x.op == "abs":
            return torch.abs(ev(x.args[0]))
        if x.op == "power":
            a, b = ev(x.args[0]), ev(x.args[1])
            return torch.pow(torch.clamp(a, min=0.0), b)
        if x.op == "extract":
            i = _CH.get(x.channel, 0)
            return ev(x.args[0])[:, i:i + 1].expand(n, 4)
        return const(_vec4(None))

    return ev(e)


@dataclasses.dataclass(frozen=True)
class GraphValue:
    """A lowered subtree: an rgba constant, optionally over one texture via
    the pool's affine (value = sample * scale + bias; `constant` is the
    connection's fallback value). Where the subtree is not affine in one
    texture, `expr` is it exactly (dynamic: render/integrator.py evaluates
    it per hit, or baked into a composite texture) and constant and texture
    its affine approximation."""

    constant: tuple[float, float, float, float]
    texture: TextureRef | None = None
    expr: Expr | None = None

    @property
    def exact(self) -> Expr:
        """The exact subtree as an Expr."""
        if self.expr is not None:
            return self.expr
        if self.texture is not None:
            return Expr(op="tex", tex=self.texture)
        return _const_expr(self.constant)

    def with_affine(self, scale=(1, 1, 1, 1), bias=(0, 0, 0, 0)) -> "GraphValue":
        """Compose value -> value * scale + bias."""
        s = _vec4(scale, (1, 1, 1, 1))
        b = _vec4(bias, (0, 0, 0, 0))
        const = tuple(c * sc + bc for c, sc, bc in zip(self.constant, s, b))
        expr = None
        if self.expr is not None:
            expr = Expr(op="add", args=(Expr(op="multiply", args=(self.expr, _const_expr(s))),
                                        _const_expr(b)))
        if self.texture is None:
            return GraphValue(constant=const, expr=expr)
        ts = tuple(a * b2 for a, b2 in zip(self.texture.scale, s))
        tb = tuple(a * s2 + b2 for a, s2, b2 in zip(self.texture.bias, s, b))
        return GraphValue(constant=const,
                          texture=dataclasses.replace(self.texture, scale=ts, bias=tb),
                          expr=expr)


def _binary(op: str, a: GraphValue, b: GraphValue, node_id: str) -> GraphValue:
    """Fold a binary node while it stays affine in one texture; beyond
    that, the exact Expr (dynamic, or baked) beside the affine form."""
    if (a.expr is not None or b.expr is not None
            or (a.texture is not None and b.texture is not None)
            or (op == "divide" and b.texture is not None)):
        get_logger().info("shader graph: %s is not affine in one texture; baking a "
                          "composite texture", node_id)
        expr = Expr(op=op, args=(a.exact, b.exact))
        approx = _binary(op, GraphValue(constant=a.constant, texture=a.texture),
                         GraphValue(constant=b.constant), node_id)
        return dataclasses.replace(approx, expr=expr)
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
    operand carries a texture and the factor is constant; beyond that,
    the exact Expr (dynamic, or baked) beside the affine form."""
    if (fg.expr is not None or bg.expr is not None or mix.expr is not None
            or sum(v.texture is not None for v in (fg, bg, mix)) > 1
            or mix.texture is not None):
        get_logger().info("shader graph: %s is not affine in one texture; baking a "
                          "composite texture", node_id)
        expr = Expr(op="mix", args=(fg.exact, bg.exact, mix.exact))
        approx = _mix(GraphValue(constant=fg.constant, texture=fg.texture),
                      GraphValue(constant=bg.constant), GraphValue(constant=mix.constant),
                      node_id)
        return dataclasses.replace(approx, expr=expr)
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
    """Recursive evaluator over one material's node dict; `frame` is the
    value frame and time nodes fold to."""

    def __init__(self, desc, frame: float = 0.0) -> None:
        self.desc = desc
        self.frame = float(frame)
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
            const = tuple(min(max(c, l), h) for c, l, h in zip(v.constant, lo, hi))
            if v.texture is not None or v.expr is not None:
                # clamp is not affine: the exact composite bakes
                expr = Expr(op="clamp", args=(v.exact, _const_expr(lo), _const_expr(hi)))
                return GraphValue(constant=const, texture=v.texture, expr=expr)
            return GraphValue(constant=const)
        if sid == "convert":
            return ev("in", default, color_hint)
        if sid in ("swizzle", "extract", "separate2", "separate3", "separate4"):
            v = ev("in", default, color_hint)
            ch = str(node.inputs.get("channels", out_name or "r")).lower()
            if len(ch) == 1 and ch in _CH:
                const = (v.constant[_CH[ch]],) * 4
                if v.expr is not None:
                    return GraphValue(constant=const, texture=v.texture,
                                      expr=Expr(op="extract", channel=ch, args=(v.expr,)))
                if v.texture is not None:
                    return GraphValue(constant=const,
                                      texture=dataclasses.replace(v.texture, channel=ch))
                return GraphValue(constant=const)
            return v
        if sid == "normalmap":
            v = ev("in", (0.5, 0.5, 1.0), False)
            # tangent-space decode [0, 1] -> [-1, 1] (previewSurfaceNetworkPatcher.cpp)
            return v.with_affine(scale=(2.0, 2.0, 2.0, 1.0), bias=(-1.0, -1.0, -1.0, 0.0))
        if sid == "viewdirection":
            # world space, camera -> surface (MDL state::direction)
            return GraphValue(constant=(0.0, 0.0, 1.0, 0.0), expr=Expr(op="viewdir"))
        if sid == "normal" and not node.input_connections:
            # the world-space shading normal as a value node
            return GraphValue(constant=(0.0, 0.0, 1.0, 0.0), expr=Expr(op="normalvec"))
        if sid == "dotproduct":
            a, b = ev("in1"), ev("in2")
            d = sum(x * y for x, y in zip(a.constant[:3], b.constant[:3]))
            return GraphValue(constant=(d, d, d, d),
                              expr=Expr(op="dot", args=(a.exact, b.exact)))
        if sid == "absval":
            v = ev("in", default, color_hint)
            const = tuple(abs(c) for c in v.constant)
            if v.texture is None and v.expr is None:
                return GraphValue(constant=const)
            return GraphValue(constant=const, texture=v.texture,
                              expr=Expr(op="abs", args=(v.exact,)))
        if sid == "power":
            a = ev("in1", default, color_hint)
            b = ev("in2", (1.0, 1.0, 1.0, 1.0))
            const = tuple(max(x, 0.0) ** y for x, y in zip(a.constant, b.constant))
            if a.texture is None and a.expr is None and b.texture is None and b.expr is None:
                return GraphValue(constant=const)
            return GraphValue(constant=const, texture=a.texture,
                              expr=Expr(op="power", args=(a.exact, b.exact)))
        if sid in ("frame", "time"):
            # the current frame folds to a constant at lowering; materials
            # holding these nodes carry traits.is_animated and are lowered
            # anew when the frame setting changes (the reference's
            # time-node detection, MtlxMdlCodeGen.cpp:116-144)
            val = self.frame
            if sid == "time":
                val = val / float(node.inputs.get("fps", 24.0) or 24.0)
            return GraphValue(constant=(val, val, val, val))
        if sid.startswith("UsdPrimvarReader") or sid == "geompropvalue":
            # a named primvar is a dynamic leaf (displayColor from the
            # interpolated vertex colours, instance-rate names from the
            # instance tables; gi keeps it static where neither holds it),
            # an unnamed reader its fallback
            var = str(node.inputs.get("varname", node.inputs.get("geomprop", "")))
            fallback = _vec4(node.inputs.get("fallback", node.inputs.get("default", default)))
            if var:
                return GraphValue(constant=fallback,
                                  expr=Expr(op="primvar", channel=var, const=fallback))
            return GraphValue(constant=fallback)
        if sid == "texcoord":
            # a bakeable uv leaf: math over texcoord bakes over the texel
            # grid (the reference reads state::texture_coordinate)
            return GraphValue(constant=_vec4(node.inputs.get("fallback", default)),
                              expr=Expr(op="texcoord"))
        if sid in _PROC_GENERATORS:
            return self._eval_proc_node(node, sid, ev, color_hint)
        get_logger().debug("shader graph: unhandled node %s (%s)", sid, node.path)
        return GraphValue(constant=_vec4(default))

    def _eval_proc_node(self, node, sid: str, ev, color_hint: bool) -> GraphValue:
        """A procedural generator -> an Expr leaf for the texture baker.
        Value inputs (colours, amplitude, pivot) stay Exprs so textured
        parameters compose; shape scalars (tiling, octaves, jitter) fold
        into the Expr's const quad."""
        def c4(name, d):
            return _vec4(ev(name, _vec4(d)).constant, _vec4(d))

        if sid == "checkerboard":
            a = ev("in1", (1.0, 1.0, 1.0, 1.0), color_hint)
            b = ev("in2", (0.0, 0.0, 0.0, 1.0), color_hint)
            tile = c4("uvtiling", (8.0, 8.0, 0.0, 0.0))
            off = c4("uvoffset", (0.0, 0.0, 0.0, 0.0))
            mean = tuple((x + y) / 2 for x, y in zip(a.constant, b.constant))
            return GraphValue(constant=mean, expr=Expr(
                op=sid, const=(tile[0], tile[1], off[0], off[1]), args=(a.exact, b.exact)))
        if sid in ("ramplr", "ramptb"):
            a_name, b_name = ("valuel", "valuer") if sid == "ramplr" else ("valuet", "valueb")
            a = ev(a_name, (0.0, 0.0, 0.0, 1.0), color_hint)
            b = ev(b_name, (1.0, 1.0, 1.0, 1.0), color_hint)
            mean = tuple((x + y) / 2 for x, y in zip(a.constant, b.constant))
            return GraphValue(constant=mean, expr=Expr(op=sid, args=(a.exact, b.exact)))
        if sid == "ramp4":
            vs = [ev(n, (0.0, 0.0, 0.0, 1.0), color_hint)
                  for n in ("valuetl", "valuetr", "valuebl", "valuebr")]
            mean = tuple(sum(v.constant[i] for v in vs) / 4 for i in range(4))
            return GraphValue(constant=mean, expr=Expr(op=sid, args=tuple(v.exact for v in vs)))
        if sid in ("noise2d", "noise3d"):
            amp = ev("amplitude", (1.0, 1.0, 1.0, 1.0))
            piv = ev("pivot", (0.0, 0.0, 0.0, 0.0))
            return GraphValue(constant=piv.constant,
                              expr=Expr(op=sid, args=(amp.exact, piv.exact)))
        if sid == "fractal3d":
            amp = ev("amplitude", (1.0, 1.0, 1.0, 1.0))
            octaves = float(c4("octaves", (3.0,) * 4)[0])
            lac = float(c4("lacunarity", (2.0,) * 4)[0])
            dim = float(c4("diminish", (0.5,) * 4)[0])
            return GraphValue(constant=(0.0, 0.0, 0.0, 0.0), expr=Expr(
                op=sid, const=(octaves, lac, dim, 0.0), args=(amp.exact,)))
        if sid in ("cellnoise2d", "cellnoise3d"):
            return GraphValue(constant=(0.5, 0.5, 0.5, 0.5), expr=Expr(op=sid))
        # worleynoise2d / worleynoise3d
        jitter = float(c4("jitter", (1.0,) * 4)[0])
        return GraphValue(constant=(0.5, 0.5, 0.5, 0.5),
                          expr=Expr(op=sid, const=(jitter, 0.0, 0.0, 0.0)))
