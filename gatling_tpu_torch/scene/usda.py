"""Minimal USDA (text USD) parser.

The reference consumes USD through the pxr library (hdGatling is a Hydra
delegate; the standalone loads scenes via UsdStage::Open,
src/gatling/main.cpp:132). No USD Python bindings exist in this environment,
so this module implements a from-scratch recursive-descent parser for the
USDA subset that gatling-class scenes use: prim hierarchies, typed
attributes (scalars, tuples, arrays, strings, asset paths), attribute
connections, relationships, prim/attribute metadata, sublayer-free flat
files, and `references`/`payload` arcs to other usda files.

It is NOT a general USD composition engine: variant sets, inherits,
specializes and value clips are out of scope.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Iterator


@dataclasses.dataclass
class Attr:
    type_name: str  # e.g. "float3[]", "token", "matrix4d"
    value: Any
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    connect: str | None = None  # target path for name.connect
    uniform: bool = False
    # authored timeSamples {time: value}; resolve_frame() picks the sample
    # nearest the render frame into .value (the reference reads values at
    # the frame through UsdStage — renderPass.cpp:131-168)
    time_samples: dict[float, Any] | None = None


@dataclasses.dataclass
class Prim:
    name: str
    type_name: str  # "" for typeless `def "Name"`
    path: str
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    attrs: dict[str, Attr] = dataclasses.field(default_factory=dict)
    rels: dict[str, list[str]] = dataclasses.field(default_factory=dict)
    children: dict[str, "Prim"] = dataclasses.field(default_factory=dict)

    def find(self, path: str) -> "Prim | None":
        """Look up a prim by absolute path like /Root/Materials/White."""
        parts = [p for p in path.split("/") if p]
        prim: Prim | None = self
        for part in parts:
            if prim is None:
                return None
            prim = prim.children.get(part)
        return prim

    def walk(self) -> Iterator["Prim"]:
        yield self
        for c in self.children.values():
            yield from c.walk()


@dataclasses.dataclass
class Stage:
    root: Prim  # pseudo-root holding top-level prims as children
    meta: dict[str, Any]
    path: str = ""

    def find(self, path: str) -> Prim | None:
        return self.root.find(path)

    def walk(self) -> Iterator[Prim]:
        for c in self.root.children.values():
            yield from c.walk()


_TOKEN_RE = re.compile(
    r"""
      (?P<comment>\#[^\n]*)
    | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
    | (?P<asset>@[^@]*@)
    | (?P<path><[^>]*>)
    | (?P<number>-?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)
    | (?P<punct>[()\[\]{}=,;:])
    | (?P<word>[A-Za-z_][A-Za-z_0-9:.\[\]]*)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    n = len(text)
    while pos < n:
        ch = text[pos]
        if ch in " \t\r\n":
            pos += 1
            continue
        # triple-quoted strings
        if text.startswith('"""', pos) or text.startswith("'''", pos):
            q = text[pos:pos + 3]
            end = text.find(q, pos + 3)
            tokens.append(("string", text[pos + 3:end]))
            pos = end + 3
            continue
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ValueError(f"usda: cannot tokenize at {text[pos:pos+40]!r}")
        kind = m.lastgroup
        val = m.group()
        pos = m.end()
        if kind == "comment":
            continue
        if kind == "string":
            val = val[1:-1]
        elif kind == "asset":
            val = val[1:-1]
        elif kind == "path":
            val = val[1:-1]
        tokens.append((kind, val))
    return tokens


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self, offset: int = 0) -> tuple[str, str]:
        j = self.i + offset
        return self.toks[j] if j < len(self.toks) else ("eof", "")

    def next(self) -> tuple[str, str]:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, val: str) -> None:
        kind, v = self.next()
        if v != val:
            raise ValueError(f"usda: expected {val!r}, got {v!r} (kind {kind}) near token {self.i}")

    # ---- values -----------------------------------------------------------

    def parse_value(self) -> Any:
        kind, v = self.peek()
        if v == "(":  # tuple
            self.next()
            items = []
            while self.peek()[1] != ")":
                items.append(self.parse_value())
                if self.peek()[1] == ",":
                    self.next()
            self.next()
            return tuple(items)
        if v == "[":  # list
            self.next()
            items = []
            while self.peek()[1] != "]":
                items.append(self.parse_value())
                if self.peek()[1] == ",":
                    self.next()
            self.next()
            return items
        if v == "{":  # metadata dict, or a timeSamples map ({time: value})
            self.next()
            d: dict[str, Any] = {}
            while self.peek()[1] != "}":
                if self.peek(1)[1] == ":":  # `<time>: value` entry
                    key = self.next()[1]
                    self.expect(":")
                    d[float(key)] = self.parse_value()
                    if self.peek()[1] == ",":
                        self.next()
                else:
                    d.update([self.parse_dict_entry()])
            self.next()
            return d
        self.next()
        if kind == "number":
            return float(v) if ("." in v or "e" in v or "E" in v) else int(v)
        if kind == "word":
            if v == "true":
                return True
            if v == "false":
                return False
            if v == "None":
                return None
        return v

    def parse_dict_entry(self) -> tuple[str, Any]:
        # `type name = value` or `name = value` or `dictionary name = {..}`
        parts = []
        while self.peek()[1] != "=":
            parts.append(self.next()[1])
        self.expect("=")
        name = parts[-1]
        return name, self.parse_value()

    def parse_metadata_block(self) -> dict[str, Any]:
        """Parse `( ... )` metadata after a prim/attr or at layer start."""
        meta: dict[str, Any] = {}
        self.expect("(")
        while self.peek()[1] != ")":
            kind, v = self.peek()
            if kind == "string":  # doc string
                meta["doc"] = self.next()[1]
                continue
            # qualifier words: add/append/prepend/delete/reorder
            qual = None
            if v in ("add", "append", "prepend", "delete", "reorder"):
                qual = self.next()[1]
                v = self.peek()[1]
            name = self.next()[1]
            if self.peek()[1] == "=":
                self.next()
                meta[name] = self.parse_value()
            else:
                meta[name] = True
            del qual
        self.expect(")")
        return meta

    # ---- prims ------------------------------------------------------------

    def parse_prim(self, parent_path: str) -> Prim:
        spec = self.next()[1]  # def / over / class
        assert spec in ("def", "over", "class"), spec
        kind, v = self.peek()
        type_name = ""
        if kind == "word":
            type_name = self.next()[1]
        name = self.next()[1]
        path = f"{parent_path}/{name}" if parent_path != "/" else f"/{name}"
        prim = Prim(name=name, type_name=type_name, path=path)
        if self.peek()[1] == "(":
            prim.meta = self.parse_metadata_block()
        self.expect("{")
        while self.peek()[1] != "}":
            self.parse_statement(prim)
        self.expect("}")
        return prim

    def parse_statement(self, prim: Prim) -> None:
        kind, v = self.peek()
        if v in ("def", "over", "class"):
            child = self.parse_prim(prim.path)
            prim.children[child.name] = child
            return
        if v == "variantSet":
            # variantSet "name" = { "sel" (meta) { statements } ... }
            # each selection becomes a child prim named "{name=sel}" that
            # _compose_variants merges per the authored selection
            self.next()
            set_name = self.next()[1]
            self.expect("=")
            self.expect("{")
            while self.peek()[1] != "}":
                sel = self.next()[1]
                vpath = f"{prim.path}/{{{set_name}={sel}}}"
                vprim = Prim(name=f"{{{set_name}={sel}}}", type_name="",
                             path=vpath)
                if self.peek()[1] == "(":
                    vprim.meta = self.parse_metadata_block()
                self.expect("{")
                while self.peek()[1] != "}":
                    self.parse_statement(vprim)
                self.expect("}")
                prim.children[vprim.name] = vprim
            self.expect("}")
            return

        qualifiers = []
        while self.peek()[1] in ("uniform", "custom", "varying", "add", "append", "prepend", "delete"):
            qualifiers.append(self.next()[1])

        if self.peek()[1] == "rel":
            self.next()
            rel_name = self.next()[1]
            targets: list[str] = []
            if self.peek()[1] == "=":
                self.next()
                val = self.parse_value()
                targets = val if isinstance(val, list) else [val]
            if self.peek()[1] == "(":
                self.parse_metadata_block()
            prim.rels[rel_name] = [str(t) for t in targets]
            return

        # attribute: type name[.connect] [= value] [( meta )]
        type_name = self.next()[1]
        attr_name = self.next()[1]
        if type_name == "dictionary":
            # treat as prim metadata-ish; parse and stash
            if self.peek()[1] == "=":
                self.next()
                prim.meta[attr_name] = self.parse_value()
            return
        connect = None
        if attr_name.endswith(".connect"):
            attr_name = attr_name[: -len(".connect")]
            self.expect("=")
            connect = str(self.parse_value())
        elif attr_name.endswith((".timeSamples",)):
            base = attr_name.rsplit(".", 1)[0]
            self.expect("=")
            samples = self.parse_value()  # dict {time: value}
            ts = ({float(k): v for k, v in samples.items()}
                  if isinstance(samples, dict) and samples else None)
            first = ts[min(ts)] if ts else None
            existing = prim.attrs.get(base)
            if existing is None:
                existing = Attr(type_name=type_name, value=first,
                                uniform="uniform" in qualifiers)
                prim.attrs[base] = existing
            elif existing.value is None:
                existing.value = first
            existing.time_samples = ts
            if self.peek()[1] == "(":
                self.parse_metadata_block()
            return
        value = None
        if self.peek()[1] == "=":
            self.next()
            value = self.parse_value()
        meta = {}
        if self.peek()[1] == "(":
            meta = self.parse_metadata_block()
        if connect is not None:
            attr = prim.attrs.setdefault(attr_name, Attr(type_name=type_name, value=None))
            attr.connect = connect
            attr.meta.update(meta)
        else:
            prim.attrs[attr_name] = Attr(
                type_name=type_name, value=value, meta=meta,
                uniform="uniform" in qualifiers,
            )

    def parse_layer(self) -> tuple[dict[str, Any], list[Prim]]:
        meta: dict[str, Any] = {}
        if self.peek()[1] == "(":
            meta = self.parse_metadata_block()
        prims = []
        while self.peek()[0] != "eof":
            prims.append(self.parse_prim("/"))
        return meta, prims


def _compose_variants(prim: Prim) -> None:
    """Resolve variantSets: merge the selected variant child ("{set=sel}"
    prims, authored by the text parser's variantSet blocks or the crate
    reader's variant-selection paths) into the prim, then drop all variant
    children. Strength: local opinions > variant opinions (the L-over-V of
    LIVRPS; references compose after, weaker still)."""
    selections = prim.meta.get("variants") or {}
    sets = prim.meta.get("variantSets") or []
    if isinstance(sets, str):
        sets = [sets]
    variant_children = [n for n in prim.children if n.startswith("{")]
    for set_name in sets:
        sel = selections.get(set_name)
        if sel is None:
            # no authored selection: first authored variant wins (pxr would
            # consult fallbacks; alphabetical-first is the deterministic
            # approximation)
            cands = sorted(n for n in variant_children
                           if n.startswith("{" + set_name + "="))
            if not cands:
                continue
            key = cands[0]
        else:
            key = f"{{{set_name}={sel}}}"
        vprim = prim.children.get(key)
        if vprim is None:
            continue
        _compose_variants(vprim)  # nested variants inside the variant
        _merge_prim(prim, vprim)
    for n in variant_children:
        prim.children.pop(n, None)
    for child in list(prim.children.values()):
        _compose_variants(child)


def _compose_references(prim: Prim, base_dir: str) -> None:
    """Resolve `references`/`payload` metadata by merging the referenced
    layer's default (or named) prim into this prim. Flat, best-effort USD
    composition: referenced opinions are weaker than local ones."""
    refs = prim.meta.get("references") or prim.meta.get("payload")
    if refs:
        if not isinstance(refs, list):
            refs = [refs]
        for ref in refs:
            target_path = None
            if isinstance(ref, tuple):  # (@file@, </prim>)
                asset, target_path = ref[0], (ref[1] if len(ref) > 1 else None)
            else:
                asset = ref
            asset = str(asset)
            if "</" in asset:
                continue  # internal reference — unsupported
            full = os.path.join(base_dir, asset)
            if not os.path.exists(full):
                continue
            sub = load_usd(full, compose=False)
            if target_path is not None:
                target_path = str(target_path).strip("<>")
            src = sub.find(str(target_path)) if target_path else None
            if src is None:
                default = sub.meta.get("defaultPrim")
                src = sub.find(f"/{default}") if default else next(iter(sub.root.children.values()), None)
            if src is not None:
                # variant selections authored on the referencing prim are
                # stronger than the referenced layer's and apply down
                # namespace (USD: selections inherit to descendant sets)
                ref_sel = prim.meta.get("variants") or {}
                if ref_sel:
                    for sp in src.walk():
                        if sp.meta.get("variantSets") or any(
                                n.startswith("{") for n in sp.children):
                            cur = dict(sp.meta.get("variants") or {})
                            cur.update(ref_sel)
                            sp.meta["variants"] = cur
                _compose_variants(src)
                _compose_references(src, os.path.dirname(full))
                _merge_prim(prim, src)
    for child in prim.children.values():
        _compose_references(child, base_dir)


def _merge_prim(dst: Prim, src: Prim) -> None:
    """Merge src (weaker) under dst (stronger)."""
    if not dst.type_name:
        dst.type_name = src.type_name
    for k, v in src.attrs.items():
        if k not in dst.attrs:
            dst.attrs[k] = v
    for k, v in src.rels.items():
        dst.rels.setdefault(k, v)
    for k, v in src.children.items():
        if k in dst.children:
            _merge_prim(dst.children[k], v)
        else:
            dst.children[k] = _reparent(v, dst.path)


def _reparent(prim: Prim, new_parent: str) -> Prim:
    new_path = f"{new_parent}/{prim.name}"
    out = Prim(name=prim.name, type_name=prim.type_name, path=new_path,
               meta=prim.meta, attrs=prim.attrs, rels=prim.rels)
    for k, v in prim.children.items():
        out.children[k] = _reparent(v, new_path)
    return out


def compose_stage(stage: Stage) -> Stage:
    """Apply the supported composition arcs in strength order
    (local > variants > references/payload)."""
    _compose_variants(stage.root)
    if stage.path:
        _compose_references(stage.root,
                            os.path.dirname(os.path.abspath(stage.path)))
    return stage


def resolve_frame(stage: Stage, frame: float) -> Stage:
    """Resolve every attribute with authored timeSamples to its value at
    `frame` (nearest-sample / held interpolation). Within a layer,
    timeSamples are stronger than the default when queried at a time —
    the reference reads frame values through UsdStage
    (src/gatling/main.cpp:132; frame plumbed at
    src/hdGatling/renderPass.cpp:131-168)."""
    frame = float(frame)
    for prim in stage.walk():
        for attr in prim.attrs.values():
            ts = attr.time_samples
            if ts:
                key = min(ts, key=lambda t: (abs(t - frame), t))
                attr.value = ts[key]
    return stage


def stage_frame_default(stage: Stage) -> float:
    """The frame a stage resolves at when none is requested: a gtl:frame
    scene setting if authored, else the layer's startTimeCode, else 0."""
    for prim in stage.walk():
        a = prim.attrs.get("gtl:frame")
        if a is not None and a.value is not None:
            try:
                return float(a.value)
            except (TypeError, ValueError):
                pass
    try:
        return float(stage.meta.get("startTimeCode", 0.0) or 0.0)
    except (TypeError, ValueError):
        return 0.0


def parse_usda(text: str, path: str = "", compose: bool = True) -> Stage:
    if not text.lstrip().startswith("#usda"):
        raise ValueError("not a usda text file")
    tokens = _tokenize(text)
    meta, prims = _Parser(tokens).parse_layer()
    root = Prim(name="", type_name="", path="/")
    for p in prims:
        root.children[p.name] = p
    stage = Stage(root=root, meta=meta, path=path)
    return compose_stage(stage) if compose else stage


def load_usda(path: str | os.PathLike, compose: bool = True) -> Stage:
    with open(path, "r", encoding="utf-8") as f:
        return parse_usda(f.read(), str(path), compose=compose)


def _load_usdz(path: str, compose: bool) -> Stage:
    """usdz = uncompressed zip; the FIRST .usd[ac] entry is the default
    layer (usdz spec). Entries extract to a mtime-keyed temp tree so
    relative texture/reference asset paths resolve as real files."""
    import hashlib
    import tempfile
    import zipfile

    st = os.stat(path)
    key = hashlib.md5(f"{os.path.abspath(path)}:{st.st_mtime_ns}:"
                      f"{st.st_size}".encode()).hexdigest()[:16]
    out_dir = os.path.join(tempfile.gettempdir(), f"gatling_usdz_{key}")
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        if not os.path.isdir(out_dir):
            tmp = out_dir + ".tmp"
            z.extractall(tmp)
            os.replace(tmp, out_dir)
    default = next((n for n in names
                    if n.lower().endswith((".usd", ".usda", ".usdc"))), None)
    if default is None:
        raise ValueError(f"usdz {path}: no usd layer inside")
    return load_usd(os.path.join(out_dir, default), compose=compose)


def load_usd(path: str | os.PathLike, compose: bool = True,
             frame: float | None = None) -> Stage:
    """Format-dispatching loader: text usda, binary usdc (crate), or usdz
    zip — detected by content, not extension (UsdStage::Open analog,
    reference: src/gatling/main.cpp:132). When `frame` is given, attributes
    with authored timeSamples resolve to their nearest sample at that
    timecode (resolve_frame)."""
    path = str(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:4] == b"PK\x03\x04":
        stage = _load_usdz(path, compose)
    elif head == b"PXR-USDC":
        from gatling_tpu_torch.scene.crate import read_usdc

        with open(path, "rb") as f:
            stage = read_usdc(f.read(), path=path)
        stage = compose_stage(stage) if compose else stage
    else:
        stage = load_usda(path, compose=compose)
    if frame is not None:
        resolve_frame(stage, frame)
    return stage
