"""One frame over a grid of devices: pixel tiles x sample shards.

The port of gatling_tpu/parallel/sharding.py. The JAX package runs one
program over a ("tiles", "spp") device mesh under shard_map; here one
process drives a [n_tiles, n_spp] grid of torch devices (`DeviceMesh`),
with no torch.distributed:

* tile t renders the contiguous block of pixel indices t * n / n_tiles ..
  (t + 1) * n / n_tiles on each device of its row, with the frame's global
  pixel ids, so its rays, their RNG streams and their paths are the
  one-device frame's;
* sample shard s renders config.spp / n_spp samples from the disjoint
  window sample_offset + s * (config.spp / n_spp) (gatling_tpu/parallel/
  sharding.py:186-187); the shards merge as `_merge_spp_axis` merges
  (:56-88): the mean for colour and the accumulating first-hit channels,
  the min for depth and the ids, the max for bounces and the hit flag;
* the scene's tables are copied to each device of the grid (read-only; a
  device that already holds them keeps them), and the AOV state stays on
  the device it came from.

The cells of the grid render one after another from the calling thread,
each under its own device; the sample loop waits on the device after each
bounce (its live-ray test), so distinct cards overlap little (ROADMAP
Queue 1). A tile of the fused route renders its samples in the one-device
frame's waves (`spp_batch_size` of the whole frame), so two tiles are
bit-equal to one device; sample shards are equal to it within float
rounding of the merge.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from gatling_tpu_torch.render.fused import render_pixels_fused, spp_batch_size
from gatling_tpu_torch.render.integrator import (
    DomeLightData,
    FirstHitInfo,
    RenderConfig,
    SampleResult,
    Uniforms,
    blend_aovs,
    render_pixels,
)


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A [n_tiles, n_spp] grid of torch devices (the JAX Mesh's
    ("tiles", "spp") axes); a device may appear more than once."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"tiles": len(self.devices), "spp": len(self.devices[0])}


def make_mesh(n_tiles: int | None = None, n_spp: int = 1, devices=None) -> DeviceMesh:
    """A ("tiles", "spp") grid over `devices` (every CUDA device by
    default; CPU devices when asked for), the first n_tiles * n_spp of them
    row by row."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu', ...] for the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_tiles is None:
        n_tiles = len(devices) // n_spp
    if n_tiles < 1 or n_tiles * n_spp > len(devices):
        raise ValueError(f"a {n_tiles}x{n_spp} mesh needs {n_tiles * n_spp} devices, "
                         f"{len(devices)} given")
    return DeviceMesh(tuple(tuple(devices[t * n_spp:(t + 1) * n_spp]) for t in range(n_tiles)))


def to_device(obj, device: torch.device):
    """`obj` with every tensor it holds (in named tuples, tuples, lists and
    dicts) on `device`; a tensor already there is kept as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, device) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def _tiles(n: int, mesh: DeviceMesh, spp: int) -> tuple[int, int]:
    n_tiles, n_spp = mesh.shape["tiles"], mesh.shape["spp"]
    if n % n_tiles:
        raise ValueError(f"pixel count {n} not divisible by tile axis {n_tiles}")
    if spp % n_spp:
        raise ValueError(f"spp {spp} not divisible by spp axis {n_spp}")
    return n // n_tiles, spp // n_spp


def _run_grid(mesh: DeviceMesh, shard_fn) -> list[list]:
    """shard_fn(t, s, device) for every cell of the grid, each under its
    own device: [tile][spp shard] results."""
    out = []
    for t, row in enumerate(mesh.devices):
        out.append([])
        for s, d in enumerate(row):
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                out[t].append(shard_fn(t, s, d))
    return out


def _mean(xs: list[torch.Tensor]) -> torch.Tensor:
    """The mean of the sample shards' values (one shard: its own)."""
    return xs[0] if len(xs) == 1 else functools.reduce(torch.add, xs) / float(len(xs))


def _merge_spp_axis(results: list[SampleResult]) -> SampleResult:
    """The sample shards of one tile merged (gatling_tpu/parallel/
    sharding.py:56-88): means for the accumulating channels, min for depth
    and the ids (deterministic where shards disagree), max for bounces and
    the hit flag."""
    if len(results) == 1:
        return results[0]
    firsts = [r.first for r in results]
    merged = {}
    for name in FirstHitInfo._fields:
        xs = [getattr(f, name) for f in firsts]
        if name in ("depth", "object_id", "face_id", "instance_id"):
            merged[name] = functools.reduce(torch.minimum, xs)
        elif name == "hit":
            merged[name] = functools.reduce(torch.logical_or, xs)
        else:
            merged[name] = _mean(xs)
    return SampleResult(color=_mean([r.color for r in results]),
                        bounces=functools.reduce(torch.maximum, [r.bounces for r in results]),
                        first=FirstHitInfo(**merged))


def render_frame_sharded(config: RenderConfig, uniforms: Uniforms, geom, materials, lights,
                         aovs: dict[str, torch.Tensor], textures, accel, mesh: DeviceMesh,
                         dome: DomeLightData | None = None,
                         instance_primvars: dict[str, torch.Tensor] | None = None
                         ) -> dict[str, torch.Tensor]:
    """render_frame (the wavefront integrator) over the mesh: tiles x spp,
    the shards merged, each tile blended into its slice of `aovs`, which
    stay on their device. config.spp is the frame's sample count; it must
    divide by the spp axis, the pixel count by the tiles axis."""
    n = config.width * config.height
    tile, local_spp = _tiles(n, mesh, config.spp)

    def shard(t, s, device):
        args = to_device((uniforms, geom, materials, lights, textures, accel, dome,
                          instance_primvars), device)
        u, g, m, lt, tex, acc, dm, pv = args
        pix = torch.arange(t * tile, (t + 1) * tile, device=device)
        return render_pixels(config, u, g, m, lt, pix, local_spp,
                             uniforms.sample_offset + s * local_spp, tex, acc, dm, pv)

    grid = _run_grid(mesh, shard)
    home = next(iter(aovs.values())).device
    out_slices: dict[str, list[torch.Tensor]] = {k: [] for k in aovs}
    for t, row in enumerate(grid):
        res = to_device(_merge_spp_axis(row), home)
        part = blend_aovs(config, uniforms, {k: v[t * tile:(t + 1) * tile]
                                             for k, v in aovs.items()}, res)
        for k in aovs:
            out_slices[k].append(part[k])
    return {k: torch.cat(v) for k, v in out_slices.items()}


def render_fused_sharded(config: RenderConfig, uniforms: Uniforms, scene, static, dome,
                         mesh: DeviceMesh, materials=None, textures=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused route (render_pixels_fused, the bounce kernels) over the
    mesh: (colour [N, 3], traced segments a sample [N]) in frame order on
    the mesh's first device. `scene` is the FusedScene, `static` its
    FusedStatic; `materials` and `textures` the raw material table and the
    pool the split bounce, the peel and the re-trace read."""
    n = config.width * config.height
    tile, local_spp = _tiles(n, mesh, config.spp)
    # the one-device frame's sample waves: each pixel sums its samples in
    # the same order, so tiles are bit-equal to it
    batch = spp_batch_size(n, local_spp)

    def shard(t, s, device):
        fs, u, dm, m, tex = to_device((scene, uniforms, dome, materials, textures), device)
        pix = torch.arange(t * tile, (t + 1) * tile, device=device)
        return render_pixels_fused(
            config, u, fs, pix, local_spp, uniforms.sample_offset + s * local_spp,
            with_stats=True, materials=m, textures=tex, textured_params=static.textured_params,
            split=static.textured, cutout_textured=static.cutout_textured, dome=dm,
            spp_batch=batch)

    grid = _run_grid(mesh, shard)
    home = mesh.devices[0][0]
    return tuple(torch.cat([_mean([to_device(cell[i], home) for cell in row]) for row in grid])
                 for i in (0, 1))



# the JAX package's name for its jit-compiled entry (gi.render calls it
# there); nothing is traced or compiled here
render_frame_sharded_jit = render_frame_sharded
