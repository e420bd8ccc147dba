#!/usr/bin/env python3
"""Husk bridge: a husk-style command line mapped onto the port's CLI
(gatling_tpu_torch.cli; the port of dist/houdini/husk_gatling.py).

The reference registers hdGatling with Houdini's USD render stack
(reference: dist/houdini, .github/workflows/build.yml:168-180), which
Solaris drives through `husk`. The port is a Python renderer without a
pxr plugin, so UsdRenderers.json points Houdini at this bridge: it takes
the subset of husk's arguments Solaris emits and runs
`python -m gatling_tpu_torch.cli` with the checkout this file lies in on
the module path.

Usage (husk-compatible subset):
    husk_gatling.py scene.usd -o out.png --res 1200 1200 \\
        --pixel-samples 64 --camera /cameras/main [--gatling:FLAG VALUE ...]

`--gatling:device cpu` renders with the kernels' plain twins.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# the checkout: gatling_tpu_torch/dist/houdini/ is three levels below it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="husk_gatling", add_help=True)
    p.add_argument("usdfile", help="input USD scene")
    p.add_argument("-o", "--output", default="render.png", help="output image path (husk -o)")
    p.add_argument("--res", "-res", nargs=2, type=int, default=None, metavar=("W", "H"),
                   help="resolution (husk --res)")
    p.add_argument("--pixel-samples", "-ps", type=int, default=None,
                   help="samples per pixel (husk --pixel-samples)")
    p.add_argument("--camera", "-c", default=None, help="camera prim path")
    p.add_argument("--renderer", "-R", default=None,
                   help="accepted and ignored (this is the renderer)")
    p.add_argument("--frame", "-f", type=float, default=None,
                   help="the frame the animated materials and skinning evaluate at")
    p.add_argument("--verbose", "-V", nargs="?", const="1", default=None,
                   help="accepted and ignored")
    return p


def cli_command(argv: list[str]) -> list[str]:
    """The CLI's command line for husk arguments `argv`: the renderer-
    namespaced options pass straight through (--gatling:max-bounces 4 ->
    --max-bounces 4)."""
    passthrough: list[str] = []
    filtered: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--gatling:"):
            passthrough.append("--" + a[len("--gatling:"):])
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                passthrough.append(argv[i + 1])
                i += 1
        else:
            filtered.append(a)
        i += 1
    args = build_parser().parse_args(filtered)
    cmd = [sys.executable, "-m", "gatling_tpu_torch.cli", args.usdfile, args.output]
    if args.res:
        cmd += ["--image-width", str(args.res[0]), "--image-height", str(args.res[1])]
    if args.pixel_samples is not None:
        cmd += ["--spp", str(args.pixel_samples)]
    if args.camera:
        cmd += ["--camera-path", args.camera]
    if args.frame is not None:
        cmd += ["--frame", str(args.frame)]
    return cmd + passthrough


def main(argv: list[str] | None = None) -> int:
    cmd = cli_command(list(sys.argv[1:] if argv is None else argv))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    sys.exit(main())
