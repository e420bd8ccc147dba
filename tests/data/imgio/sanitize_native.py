"""The port's native host library (gatling_tpu_torch/csrc/*.cpp) under
AddressSanitizer and UndefinedBehaviorSanitizer, fed through the port's own
decoders: the legacy plugins' files of tests/test_torch_imgio_legacy.py
(its hand-made files and a Pillow corpus of every saver's modes), the
fixtures of this folder, LZMA TIFFs, and xz streams of every filter chain
(Python's lzma and tests/test_torch_tiff_codecs.py's framed ones), each
whole, cut and mutated. Any sanitizer report ends the run with an error; an
exception other than ValueError or NotImplementedError is printed and
fails it too.

Run from the repository root (g++ with libasan and libubsan; about two
minutes a seed on one core):

    python3 tests/data/imgio/sanitize_native.py [--seeds 1 2] [--per 100]
"""

import argparse
import ctypes
import glob
import importlib.util
import io
import lzma
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SUFFIXES = ("sgi", "pcx", "dcx", "blp", "ftex", "ras", "icns", "fits", "im", "xpm", "xbm",
            "msp", "flc", "spi", "area", "xv", "gbr")


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus(seed: int = 7):
    """({name: image file}, [(xz stream, strip bytes)])."""
    from PIL import Image

    sys.path.insert(0, ROOT)
    leg = _module("legacy_tests", os.path.join(ROOT, "tests", "test_torch_imgio_legacy.py"))
    tc = _module("tiff_tests", os.path.join(ROOT, "tests", "test_torch_tiff_codecs.py"))
    files = dict(leg.HAND_MADE)
    rng = np.random.default_rng(seed)
    for saver, kw in leg.SAVERS.items():
        fmt = saver.split("-")[0]
        sizes = ((16, 16),) if fmt == "ICNS" else ((1, 1), (5, 3), (17, 23), (32, 40))
        for h, w in sizes:
            img = rng.integers(0, 256, (h, w, 4), np.uint8)
            for mode in (("L", "P", "RGB", "RGBA") if fmt == "ICNS" else leg.MODES):
                im = (Image.frombytes(mode, (w, h), (img[..., 0].astype("<u2") * 257).tobytes())
                      if mode.startswith("I;16") else Image.fromarray(img).convert(mode))
                buf = io.BytesIO()
                try:
                    im.save(buf, fmt, **kw)
                except (OSError, ValueError, KeyError, TypeError):
                    continue
                files[f"pillow_{saver}_{mode}_{h}x{w}"] = buf.getvalue()
    for path in sorted(glob.glob(os.path.join(HERE, "*"))):
        if path.rsplit(".", 1)[-1] in SUFFIXES:
            with open(path, "rb") as f:
                files[os.path.basename(path)] = f.read()
    for mode in ("RGB", "L", "YCbCr"):
        im = Image.fromarray(tc.mf.texture(40, 56, 3, 3)).convert(mode)
        files[f"tiff_lzma_{mode}"] = tc.saved(im, compression="lzma")
    streams = []
    branch = [lzma.FILTER_X86, lzma.FILTER_POWERPC, lzma.FILTER_IA64, lzma.FILTER_ARM,
              lzma.FILTER_ARMTHUMB, lzma.FILTER_SPARC]
    ids = sorted(v[0] for v in tc.XZ_BRANCH.values())
    for it in range(300):
        n = int(rng.integers(16, 6000))
        raw = tc.branch_code(rng, n)
        chain = [{"id": int(rng.choice(branch))}] if it % 3 else []
        if it % 2:
            chain.insert(0, {"id": lzma.FILTER_DELTA, "dist": int(rng.integers(1, 20))})
        chain.append({"id": lzma.FILTER_LZMA2, "preset": int(rng.integers(0, 7))})
        streams.append((lzma.compress(raw, lzma.FORMAT_XZ, check=[0, 1, 4, 10][it % 4],
                                      filters=chain), n))
        framed = [(int(rng.choice(ids)), b"") for _ in range(int(rng.integers(1, 3)))]
        streams.append((tc.xz_framed([(framed, raw)], sizes=bool(it % 2)), n))
    return files, streams


def fuzz(lib_path: str, corpus_path: str, seed: int, per: int) -> int:
    """The child under the sanitizers: every input decoded; the count of
    faults of the port (exceptions other than ValueError and
    NotImplementedError)."""
    import warnings

    warnings.filterwarnings("ignore")
    sys.path.insert(0, ROOT)
    from gatling_tpu_torch import imgio, native
    from gatling_tpu_torch.imgio import tiff

    lib = ctypes.CDLL(lib_path)
    for name, (restype, argtypes) in native._ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    native._lib = lib
    with open(corpus_path, "rb") as f:
        files, streams = pickle.load(f)
    rng = np.random.default_rng(seed)

    def mutate(b: bytes) -> bytes:
        b = bytearray(b)
        kind = int(rng.integers(0, 5))
        if kind == 0 and b:
            for _ in range(int(rng.integers(1, 6))):
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        elif kind == 1:
            b = b[:int(rng.integers(0, len(b) + 1))]
        elif kind == 2 and len(b) > 4:
            at = int(rng.integers(0, len(b)))
            b[at:at] = rng.integers(0, 256, int(rng.integers(1, 64)), np.uint8).tobytes()
        elif kind == 3 and len(b) > 4:
            at = int(rng.integers(0, len(b) - 1))
            del b[at:at + int(rng.integers(1, 64))]
        elif len(b) > 2:  # a header word set to an extreme
            at = int(rng.integers(0, min(len(b) - 2, 140)))
            b[at:at + 2] = bytes([[0, 0], [255, 255], [0, 128], [1, 0], [0, 1]][
                int(rng.integers(0, 5))])
        return bytes(b)

    n, faults, outcomes = 0, 0, {}
    for name, blob in files.items():
        for k in range(per):
            data = blob if k == 0 else mutate(blob if k % 4 else mutate(blob))
            try:
                imgio.load_image(data)
                kind = "array"
            except (ValueError, NotImplementedError) as e:
                kind = type(e).__name__
            except Exception as e:  # noqa: BLE001 - any other exception is a fault
                kind = "fault"
                faults += 1
                print(f"{name} #{k}: {type(e).__name__}: {e}", flush=True)
            outcomes[kind] = outcomes.get(kind, 0) + 1
            n += 1
    for blob, size in streams:
        for k in range(max(1, per // 4)):
            data = blob if k == 0 else mutate(blob)
            for cap in (size, int(rng.integers(1, size + 20))):
                tiff._lzma(data, cap, partial=True)
                n += 1
    print(f"seed {seed}: {n} inputs, image outcomes {outcomes}, faults {faults}", flush=True)
    return faults


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--per", type=int, default=100, help="inputs made from each file")
    ap.add_argument("--child", nargs=2, metavar=("LIB", "CORPUS"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return 1 if fuzz(*args.child, args.seeds[0], args.per) else 0
    sys.path.insert(0, ROOT)
    from gatling_tpu_torch import native

    with tempfile.TemporaryDirectory(prefix="sanitize_native_") as tmp:
        lib = os.path.join(tmp, "libgatling_native_sanitized.so")
        flags = ["-O1", "-g", "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
                 "-fno-omit-frame-pointer", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
        subprocess.run(["g++", *flags, "-o", lib, *map(str, native._sources()), *native.LIBS],
                       check=True)
        path = os.path.join(tmp, "corpus.pkl")
        with open(path, "wb") as f:
            pickle.dump(corpus(), f)
        runtime = [subprocess.run(["g++", f"-print-file-name={name}"], capture_output=True,
                                  text=True, check=True).stdout.strip()
                   for name in ("libasan.so", "libubsan.so")]
        env = dict(os.environ, LD_PRELOAD=" ".join(runtime),
                   ASAN_OPTIONS="detect_leaks=0:halt_on_error=1",
                   UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1")
        failed = 0
        for seed in args.seeds:
            t0 = time.time()
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", lib, path,
                                 "--seeds", str(seed), "--per", str(args.per)], env=env).returncode
            print(f"seed {seed}: exit {rc} in {time.time() - t0:.1f} s", flush=True)
            failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
