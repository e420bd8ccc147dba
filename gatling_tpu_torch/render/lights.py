"""Analytic lights: the host tables and NEE light sampling.

The tables mirror hdGatling's light sync (reference: light.cpp:100-330):
emission = color * intensity * 2^exposure / normalizeFactor, transforms
applied to radii and tangent frames. The fused path samples lights inside
the bounce kernels (and their twin, ops/bounce_ref.py); the wavefront
integrator calls `sample_light` (reference: rp_main.chit sampleLight:30-129):
a uniform pick among all lights by global index and per-type area
sampling, every type's branch computed and the picked one selected.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gatling_tpu_torch.interface import LightArrays, empty_light_arrays
from gatling_tpu_torch.ops.sampling import (
    PI,
    orthonormal_basis,
    safe_div,
    sample_disk,
    sample_sphere,
)
from gatling_tpu_torch.scene.stage import LightDesc, transform_dir, transform_point


def _area_ellipsoid(rx: float, ry: float, rz: float) -> float:
    """Thomsen approximation (reference: light.cpp:36-45)."""
    p = 1.6
    ab, ac, bc = (rx * ry) ** p, (rx * rz) ** p, (ry * rz) ** p
    return ((ab + ac + bc) / 3.0) ** (1.0 / p) * 4.0 * math.pi


def _blackbody_rgb(t: float) -> np.ndarray:
    """UsdLuxBlackbodyTemperatureAsRgb analog: Planckian locus approximation,
    normalized to luminance 1 (same contract as pxr's implementation)."""
    # Krystek 1985 CIE 1960 UCS approximation
    t = float(np.clip(t, 1000.0, 15000.0))
    t2 = t * t
    u = (0.860117757 + 1.54118254e-4 * t + 1.28641212e-7 * t2) / (
        1.0 + 8.42420235e-4 * t + 7.08145163e-7 * t2)
    v = (0.317398726 + 4.22806245e-5 * t + 4.20481691e-8 * t2) / (
        1.0 - 2.89741816e-5 * t + 1.61456053e-7 * t2)
    # CIE 1960 -> xy -> XYZ (Y=1) -> linear sRGB
    x = 3.0 * u / (2.0 * u - 8.0 * v + 4.0)
    y = 2.0 * v / (2.0 * u - 8.0 * v + 4.0)
    xyz = np.array([x / y, 1.0, (1.0 - x - y) / y])
    m = np.array([
        [3.2409699419, -1.5373831776, -0.4986107603],
        [-0.9692436363, 1.8759675015, 0.0415550574],
        [0.0556300797, -0.2039769589, 1.0569715142],
    ])
    rgb = np.maximum(m @ xyz, 0.0)
    lum = 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
    return (rgb / max(lum, 1e-9)).astype(np.float32)


def _base_emission(params: dict, normalize_factor: float) -> np.ndarray:
    """Reference: light.cpp:59-90 _CalcBaseEmission."""
    e = params["intensity"] * (2.0 ** params["exposure"]) / max(normalize_factor, 1e-20)
    emission = np.asarray(params["color"], np.float32) * e
    if params.get("enableColorTemperature"):
        emission = emission * _blackbody_rgb(params["colorTemperature"])
    return emission.astype(np.float32)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def build_light_arrays(lights: list[LightDesc], capacity: int = 8) -> LightArrays:
    """Pack LightDescs into the four dense light tables."""
    by_type: dict[str, list[LightDesc]] = {"sphere": [], "distant": [], "rect": [], "disk": []}
    for l in lights:
        if l.light_type == "simple":
            # HdSimpleLight approximation (reference light.cpp: "simple
            # light approximated"): a point-like sphere light at the prim
            # transform
            p = dict(l.params)
            p.setdefault("radius", 0.01)
            p.setdefault("normalize", True)
            l = type(l)(path=l.path, light_type="sphere",
                        transform=l.transform, params=p)
            by_type["sphere"].append(l)
        elif l.light_type in by_type:
            by_type[l.light_type].append(l)
    cap = max(capacity, *(len(v) for v in by_type.values()), 1)
    arrs = empty_light_arrays(cap)._asdict()

    def diff_spec(p):
        return [p["diffuse"], p["specular"]]

    for i, l in enumerate(by_type["sphere"]):
        m, p = l.transform, l.params
        if p.get("explicit_frame"):
            # C-style API route (giSetSphereLightRadius): radii are given
            # directly, not extracted from an axis-aligned transform
            rx, ry, rz = (float(v) for v in p["radius_xyz"])
        else:
            r = p["radius"]
            rx = float(transform_dir(m, [r, 0, 0])[0])
            ry = float(transform_dir(m, [0, r, 0])[1])
            rz = float(transform_dir(m, [0, 0, r])[2])
        area = _area_ellipsoid(rx, ry, rz)
        norm = area if (p["normalize"] and area > 0) else 1.0
        if p.get("treatAsPoint"):
            rx = ry = rz = 0.0
            area = 0.0
        arrs["sphere_pos"][i] = transform_point(m, [0, 0, 0])
        arrs["sphere_radius"][i] = [rx, ry, rz]
        arrs["sphere_emission"][i] = _base_emission(p, norm)
        arrs["sphere_area"][i] = area
        arrs["sphere_diff_spec"][i] = diff_spec(p)
    arrs["sphere_count"] = len(by_type["sphere"])

    for i, l in enumerate(by_type["distant"]):
        m, p = l.transform, l.params
        if p.get("explicit_frame"):
            d = np.asarray(p["direction"], np.float64)
        else:
            # direction light travels: -Z through inverse-transpose (light.cpp:168-175)
            d = np.asarray([0.0, 0.0, -1.0]) @ np.linalg.inv(m[:3, :3]).T
        angle = math.radians(p["angle"])
        sin_half = math.sin(angle * 0.5)
        norm = (sin_half * sin_half * math.pi) if (sin_half > 1e-6 and p["normalize"]) else 1.0
        arrs["distant_dir"][i] = _unit(d)
        arrs["distant_angle"][i] = angle
        arrs["distant_emission"][i] = _base_emission(p, norm)
        arrs["distant_inv_pdf"][i] = 1.0
        arrs["distant_diff_spec"][i] = diff_spec(p)
    arrs["distant_count"] = len(by_type["distant"])

    for i, l in enumerate(by_type["rect"]):
        m, p = l.transform, l.params
        if p.get("explicit_frame"):
            # C-style API route (giSetRectLightTangents/Dimensions): the
            # frame is given directly, no axis-component extraction
            t0, t1 = _unit(p["t0"]), _unit(p["t1"])
            width = float(p["width"])
            height = float(p["height"])
        else:
            t0 = _unit(transform_dir(m, [1, 0, 0]))
            t1 = _unit(transform_dir(m, [0, 1, 0]))
            width = float(transform_dir(m, [p["width"], 0, 0])[0])
            height = float(transform_dir(m, [0, p["height"], 0])[1])
        area = width * height
        norm = area if (p["normalize"] and area > 0) else 1.0
        arrs["rect_origin"][i] = transform_point(m, [0, 0, 0])
        arrs["rect_t0"][i] = t0
        arrs["rect_t1"][i] = t1
        arrs["rect_size"][i] = [width, height]
        arrs["rect_emission"][i] = _base_emission(p, norm)
        arrs["rect_diff_spec"][i] = diff_spec(p)
    arrs["rect_count"] = len(by_type["rect"])

    for i, l in enumerate(by_type["disk"]):
        m, p = l.transform, l.params
        if p.get("explicit_frame"):
            t0, t1 = _unit(p["t0"]), _unit(p["t1"])
            rx, ry = (float(v) for v in p["radius_xy"])
        else:
            t0 = _unit(transform_dir(m, [1, 0, 0]))
            t1 = _unit(transform_dir(m, [0, 1, 0]))
            r = p["radius"]
            rx = float(transform_dir(m, [r, 0, 0])[0])
            ry = float(transform_dir(m, [0, r, 0])[1])
        area = rx * ry * math.pi
        norm = area if (p["normalize"] and area > 0) else 1.0
        arrs["disk_origin"][i] = transform_point(m, [0, 0, 0])
        arrs["disk_t0"][i] = t0
        arrs["disk_t1"][i] = t1
        arrs["disk_radius"][i] = [rx, ry]
        arrs["disk_emission"][i] = _base_emission(p, norm)
        arrs["disk_diff_spec"][i] = diff_spec(p)
    arrs["disk_count"] = len(by_type["disk"])

    return LightArrays(**arrs)


def light_tensors(arrays: LightArrays, device) -> LightArrays:
    """The tables as f32 tensors on `device` (the counts stay ints)."""
    return LightArrays(**{k: v if k.endswith("_count")
                          else torch.as_tensor(np.asarray(v, np.float32), device=device)
                          for k, v in arrays._asdict().items()})


def total_light_count(lights: LightArrays) -> int:
    return lights.sphere_count + lights.distant_count + lights.rect_count + lights.disk_count


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def sample_light(lights: LightArrays, k4: torch.Tensor, surface_pos: torch.Tensor,
                 light_intensity_multiplier: float, sensor_exposure: float):
    """Pick one light per ray uniformly and sample a point on it
    (lights.py sample_light). `lights` holds tensors (light_tensors); k4
    [R, 4] uniforms, surface_pos [R, 3]. Returns (dir_to_light [R, 3],
    dist [R], power [R, 3], inv_pdf [R], diffuse_spec [R, 2])."""
    s, d, r = (float(c) for c in (lights.sphere_count, lights.distant_count, lights.rect_count))
    total = float(total_light_count(lights))

    pick = k4[:, 0] * total
    is_sphere = pick <= s
    is_distant = (~is_sphere) & (pick <= s + d)
    is_rect = (~is_sphere) & (~is_distant) & (pick <= s + d + r)

    def idx(count: int, cap: int) -> torch.Tensor:
        i = torch.clamp((k4[:, 1] * float(count)).to(torch.int32), max=count - 1)
        return torch.clamp(i, 0, cap - 1).long()

    # sphere (chit:33-53): area-measure inverse pdf with the cosine on the light
    si = idx(lights.sphere_count, lights.sphere_pos.shape[0])
    sp_pos = lights.sphere_pos[si]
    sp_sample = sp_pos + sample_sphere(k4[:, 2:4], lights.sphere_radius[si])
    sp_vec = sp_sample - surface_pos
    sp_dist = _norm(sp_vec)
    sp_dir = safe_div(sp_vec, sp_dist[:, None])
    sp_nrm = safe_div(sp_sample - sp_pos, _norm(sp_sample - sp_pos)[:, None])
    sp_cos = torch.clamp(-(sp_dir * sp_nrm).sum(-1), min=0.0)
    sp_area = lights.sphere_area[si]
    sp_inv_pdf = safe_div(torch.where(sp_area > 0.0, sp_area * sp_cos, 1.0), sp_dist * sp_dist)

    # distant (chit:55-78): a direction perturbed inside the cone
    di = idx(lights.distant_count, lights.distant_dir.shape[0])
    dl_dir0 = -lights.distant_dir[di]
    phi = (k4[:, 2] * 2.0 * PI) - PI
    theta = k4[:, 3] * lights.distant_angle[di]
    t1b, t2b = orthonormal_basis(dl_dir0)
    perturbed = (torch.sin(theta)[:, None] * (torch.cos(phi)[:, None] * t1b
                                              + torch.sin(phi)[:, None] * t2b)
                 + torch.cos(theta)[:, None] * dl_dir0)
    perturbed = perturbed / torch.clamp(_norm(perturbed)[:, None], min=1e-20)
    dl_dir = torch.where((lights.distant_angle[di] > 0.0)[:, None], perturbed, dl_dir0)
    dl_dist = torch.full_like(sp_dist, 100000.0)

    # rect (chit:80-105)
    ri = idx(lights.rect_count, lights.rect_origin.shape[0])
    r_size = lights.rect_size[ri]
    on_rect = (k4[:, 2:4] - 0.5) * r_size
    rt0, rt1 = lights.rect_t0[ri], lights.rect_t1[ri]
    r_sample = lights.rect_origin[ri] + on_rect[:, 0:1] * rt0 + on_rect[:, 1:2] * rt1
    r_vec = r_sample - surface_pos
    r_dist = _norm(r_vec)
    r_dir = safe_div(r_vec, r_dist[:, None])
    r_nrm = torch.linalg.cross(rt1, rt0)  # the light faces -Z, as in UsdLux
    r_cos = torch.clamp(-(r_dir * r_nrm).sum(-1), min=0.0)
    r_area = r_size[:, 0] * r_size[:, 1]
    r_inv_pdf = safe_div(torch.where(r_area > 0.0, r_area * r_cos, 1.0), r_dist * r_dist)

    # disk (chit:107-127)
    ki = idx(lights.disk_count, lights.disk_origin.shape[0])
    k_rad = lights.disk_radius[ki]
    on_disk = sample_disk(k4[:, 2:4], k_rad)
    kt0, kt1 = lights.disk_t0[ki], lights.disk_t1[ki]
    k_sample = lights.disk_origin[ki] + on_disk[:, 0:1] * kt0 + on_disk[:, 1:2] * kt1
    k_vec = k_sample - surface_pos
    k_dist = _norm(k_vec)
    k_dir = safe_div(k_vec, k_dist[:, None])
    k_nrm = torch.linalg.cross(kt1, kt0)
    k_cos = torch.clamp(-(k_dir * k_nrm).sum(-1), min=0.0)
    k_area = k_rad[:, 0] * k_rad[:, 1] * PI
    k_inv_pdf = safe_div(torch.where(k_area > 0.0, k_area * k_cos, 1.0), k_dist * k_dist)

    def sel(a, b, c, e):
        m_s, m_d, m_r = is_sphere, is_distant, is_rect
        if a.dim() > 1:
            m_s, m_d, m_r = m_s[:, None], m_d[:, None], m_r[:, None]
        return torch.where(m_s, a, torch.where(m_d, b, torch.where(m_r, c, e)))

    dir_to_light = sel(sp_dir, dl_dir, r_dir, k_dir)
    dist = sel(sp_dist, dl_dist, r_dist, k_dist)
    power = sel(lights.sphere_emission[si], lights.distant_emission[di],
                lights.rect_emission[ri], lights.disk_emission[ki]) * light_intensity_multiplier
    inv_pdf = sel(sp_inv_pdf, lights.distant_inv_pdf[di], r_inv_pdf, k_inv_pdf)
    diff_spec = sel(lights.sphere_diff_spec[si], lights.distant_diff_spec[di],
                    lights.rect_diff_spec[ri], lights.disk_diff_spec[ki])

    # chit:128-129: exposure and the uniform type and count compensation
    power = power * float(np.exp2(np.float32(sensor_exposure)))
    inv_pdf = inv_pdf * total
    if total <= 0.0:  # no lights: no contribution
        power = torch.zeros_like(power)
    return dir_to_light, dist, power, inv_pdf, diff_spec
