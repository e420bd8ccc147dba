"""The uber-BSDF behind the distilled MDL df interface, on tensors.

The port of the JAX package's render/bsdf.py: one parameter-driven BSDF
for every material (the wavefront analog of the reference's per-material
MDL-generated hit shaders, src/mc/impl/Backend.cpp:38-50 DF_NAMES):
Lambert diffuse, GGX/Smith glossy with Schlick Fresnel (anisotropic with
the Disney aspect mapping), a clearcoat layer, thin-walled and thick
dielectric transmission, and coverage opacity. Conventions (rp_main.chit):
`evaluate` returns the diffuse and glossy values with the projection
cosine folded in and the sample pdf; `sample` returns (k2, bsdf_over_pdf,
event, pdf); `auxiliary` the diffuse + glossy albedo of the Albedo AOV.
Each function follows its JAX counterpart operation for operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gatling_tpu_torch.interface import (
    BSDF_EVENT_ABSORB,
    BSDF_EVENT_DIFFUSE_REFLECTION,
    BSDF_EVENT_GLOSSY_REFLECTION,
    BSDF_EVENT_SPECULAR_TRANSMISSION,
)
from gatling_tpu_torch.ops.sampling import PI, luminance, safe_div


class BsdfParams(NamedTuple):
    """Per-ray resolved material parameters (after the texture lookups)."""

    base_color: torch.Tensor  # [R, 3]
    metallic: torch.Tensor  # [R]
    roughness: torch.Tensor  # [R]
    ior: torch.Tensor  # [R]
    opacity: torch.Tensor  # [R] coverage
    opacity_threshold: torch.Tensor  # [R] cutout threshold (0 = blend)
    emissive: torch.Tensor  # [R, 3] emitted radiance
    use_specular_workflow: torch.Tensor  # [R] 0/1
    specular_color: torch.Tensor  # [R, 3]
    transmission: torch.Tensor  # [R]
    thin_walled: torch.Tensor  # [R] bool
    volume_absorption: torch.Tensor  # [R, 3] sigma_a
    volume_scattering: torch.Tensor  # [R, 3] sigma_s
    volume_bias: torch.Tensor  # [R] Henyey-Greenstein g
    backface_edf: torch.Tensor  # [R] 0/1
    clearcoat: torch.Tensor  # [R] weight
    clearcoat_roughness: torch.Tensor  # [R]
    anisotropy: torch.Tensor  # [R] 0 = isotropic
    anisotropy_rotation: torch.Tensor  # [R] turns


MIN_ALPHA = 1e-3  # roughness^2 floor to keep GGX sampleable in f32
_COAT_F0 = 0.04  # clearcoat ior 1.5 normal-incidence reflectance


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _f0(p: BsdfParams) -> torch.Tensor:
    """Normal-incidence reflectance."""
    dielectric = ((p.ior - 1.0) / (p.ior + 1.0)) ** 2
    f0_metal = (dielectric[..., None] * (1.0 - p.metallic[..., None])
                + p.base_color * p.metallic[..., None])
    return torch.where(p.use_specular_workflow[..., None] > 0.5, p.specular_color, f0_metal)


def _schlick(f0: torch.Tensor, cos_theta: torch.Tensor) -> torch.Tensor:
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * (m * m) ** 2 * m


def _ggx_d(alpha2: torch.Tensor, nh: torch.Tensor) -> torch.Tensor:
    d = nh * nh * (alpha2 - 1.0) + 1.0
    return alpha2 / torch.clamp(PI * d * d, min=1e-12)


def _smith_g1(alpha2: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    nv = torch.clamp(nv, min=1e-6)
    return 2.0 * nv / (nv + torch.sqrt(alpha2 + (1.0 - alpha2) * nv * nv))


def _alpha_xy(p: BsdfParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Anisotropic GGX roughnesses (ax = ay when anisotropy == 0)."""
    alpha = torch.clamp(p.roughness * p.roughness, min=MIN_ALPHA)
    aspect = torch.sqrt(1.0 - 0.9 * torch.clamp(p.anisotropy, 0.0, 1.0))
    return torch.clamp(alpha / aspect, min=MIN_ALPHA), torch.clamp(alpha * aspect, min=MIN_ALPHA)


def _rot_local(v_l: torch.Tensor, cos_r, sin_r) -> torch.Tensor:
    """Rotate local xy by the anisotropy rotation (z unchanged)."""
    x = v_l[..., 0] * cos_r + v_l[..., 1] * sin_r
    y = -v_l[..., 0] * sin_r + v_l[..., 1] * cos_r
    return torch.stack([x, y, v_l[..., 2]], dim=-1)


def _aniso_d(ax, ay, h_l: torch.Tensor) -> torch.Tensor:
    q = (h_l[..., 0] / ax) ** 2 + (h_l[..., 1] / ay) ** 2 + h_l[..., 2] ** 2
    return 1.0 / torch.clamp(PI * ax * ay * q * q, min=1e-12)


def _aniso_g1(ax, ay, v_l: torch.Tensor) -> torch.Tensor:
    vz = torch.clamp(v_l[..., 2].abs(), min=1e-6)
    lam = 0.5 * (-1.0 + torch.sqrt(
        1.0 + ((ax * v_l[..., 0]) ** 2 + (ay * v_l[..., 1]) ** 2) / (vz * vz)))
    return 1.0 / (1.0 + lam)


def _fresnel_dielectric(cos_i: torch.Tensor, eta_rel: torch.Tensor) -> torch.Tensor:
    """Exact unpolarized dielectric Fresnel; 1 under total internal reflection."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp(eta_rel * eta_rel, min=1e-12)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = (cos_i - eta_rel * cos_t) / torch.clamp(cos_i + eta_rel * cos_t, min=1e-12)
    rp = (eta_rel * cos_i - cos_t) / torch.clamp(eta_rel * cos_i + cos_t, min=1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def _coat_atten(p: BsdfParams, cos_theta: torch.Tensor) -> torch.Tensor:
    """Base-lobe attenuation under the clearcoat: 1 - weight * F_coat."""
    f = _COAT_F0 + (1.0 - _COAT_F0) * torch.clamp(1.0 - cos_theta, 0.0, 1.0) ** 5
    return 1.0 - p.clearcoat * f


def _thin(p: BsdfParams) -> torch.Tensor:
    return p.thin_walled if p.thin_walled.dtype == torch.bool else p.thin_walled > 0.5


def _thick_transmission(p: BsdfParams) -> torch.Tensor:
    """The share of the surface the self-contained thick-glass lobe handles."""
    return p.transmission * (1.0 - _thin(p).to(torch.float32))


def _lobe_weights(p: BsdfParams, f0: torch.Tensor):
    """One-sample MIS lobe probabilities (diffuse, glossy, transmission, clearcoat)."""
    w_d = luminance(p.base_color) * (1.0 - p.metallic) * (1.0 - p.transmission)
    w_g_raw = luminance(f0)
    w_g = torch.where(w_g_raw > 0.0, torch.clamp(w_g_raw, min=0.04), 0.0)
    w_g = w_g * (1.0 - _thick_transmission(p))
    w_t = p.transmission
    w_c = 0.25 * p.clearcoat
    total = w_d + w_g + w_t + w_c
    return safe_div(w_d, total), safe_div(w_g, total), safe_div(w_t, total), safe_div(w_c, total)


def _to_local(v, t, b, n) -> torch.Tensor:
    return torch.stack([_dot(v, t), _dot(v, b), _dot(v, n)], dim=-1)


def _from_local(v, t, b, n) -> torch.Tensor:
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def _eval_lobes(p: BsdfParams, wo_l: torch.Tensor, wi_l: torch.Tensor):
    """(f_diffuse * cos, f_glossy * cos, pdf) of the reflection lobes in
    the local frame; transmission is a (near-)delta lobe and adds nothing."""
    f0 = _f0(p)
    ax, ay = _alpha_xy(p)
    theta = (2.0 * PI) * p.anisotropy_rotation
    cos_r, sin_r = torch.cos(theta), torch.sin(theta)
    wo_r = _rot_local(wo_l, cos_r, sin_r)
    wi_r = _rot_local(wi_l, cos_r, sin_r)

    cos_o = wo_l[..., 2]
    cos_i = wi_l[..., 2]
    refl = (cos_o > 0.0) & (cos_i > 0.0)
    cos_i_c = torch.clamp(cos_i, min=0.0)

    h_r = wo_r + wi_r
    h_r = h_r / torch.clamp(_norm(h_r), min=1e-12)
    nh = h_r[..., 2].abs()
    oh = torch.clamp(_dot(wo_r, h_r), min=1e-6)

    d = _aniso_d(ax, ay, h_r)
    g = _aniso_g1(ax, ay, wo_r) * _aniso_g1(ax, ay, wi_r)
    fr = _schlick(f0, oh[..., None])

    ac = torch.clamp(p.clearcoat_roughness * p.clearcoat_roughness, min=MIN_ALPHA)
    ac2 = ac * ac
    dc = _ggx_d(ac2, nh)
    gc = _smith_g1(ac2, cos_o) * _smith_g1(ac2, cos_i_c)
    fc = _COAT_F0 + (1.0 - _COAT_F0) * torch.clamp(1.0 - oh, 0.0, 1.0) ** 5
    coat = p.clearcoat * fc * dc * gc / torch.clamp(4.0 * cos_o * cos_i_c, min=1e-9)
    att = _coat_atten(p, cos_o) * _coat_atten(p, cos_i_c)

    spec = fr * ((1.0 - _thick_transmission(p)) * att * d * g
                 / torch.clamp(4.0 * cos_o * cos_i_c, min=1e-9))[..., None]
    spec = spec + coat[..., None]
    f_glossy = torch.where(refl[..., None], spec * cos_i_c[..., None], 0.0)

    diff_albedo = p.base_color * (att * (1.0 - p.metallic) * (1.0 - p.transmission))[..., None]
    f_diffuse = torch.where(refl[..., None], diff_albedo * (cos_i_c / PI)[..., None], 0.0)

    pdf_diff = cos_i_c / PI
    pdf_spec = d * nh / torch.clamp(4.0 * oh, min=1e-9)
    pdf_coat = dc * nh / torch.clamp(4.0 * oh, min=1e-9)
    p_d, p_g, _, p_c = _lobe_weights(p, f0)
    pdf = torch.where(refl, p_d * pdf_diff + p_g * pdf_spec + p_c * pdf_coat, 0.0)
    return f_diffuse, f_glossy, pdf


def evaluate(p: BsdfParams, wo, wi, n, t, b):
    """mdl_bsdf_scattering_evaluate: (bsdf_diffuse, bsdf_glossy, pdf)."""
    return _eval_lobes(p, _to_local(wo, t, b, n), _to_local(wi, t, b, n))


def sample(p: BsdfParams, wo, n, t, b, xi: torch.Tensor, front: torch.Tensor | None = None):
    """mdl_bsdf_scattering_sample: (k2 [R, 3], bsdf_over_pdf [R, 3], event
    [R] int32, pdf [R]). `front` (True = entering) orients refraction
    through thick transmissive surfaces; thin-walled ones pass straight."""
    if front is None:
        front = torch.ones(p.metallic.shape, dtype=torch.bool, device=p.metallic.device)
    wo_l = _to_local(wo, t, b, n)
    f0 = _f0(p)
    p_d, p_g, p_t, _p_c = _lobe_weights(p, f0)
    ax, ay = _alpha_xy(p)
    theta = (2.0 * PI) * p.anisotropy_rotation
    cos_r, sin_r = torch.cos(theta), torch.sin(theta)

    sel = xi[..., 0]
    pick_d = sel < p_d
    pick_g = (~pick_d) & (sel < p_d + p_g)
    pick_t = (~pick_d) & (~pick_g) & (sel < p_d + p_g + p_t)
    pick_c = (~pick_d) & (~pick_g) & (~pick_t)

    # diffuse: cosine hemisphere
    a = torch.sqrt(torch.clamp(xi[..., 1], 0.0, 1.0))
    phi_d = 2.0 * PI * xi[..., 2]
    wi_diff = torch.stack([a * torch.cos(phi_d), a * torch.sin(phi_d),
                           torch.sqrt(torch.clamp(1.0 - xi[..., 1], min=0.0))], dim=-1)

    # glossy: anisotropic GGX half vector (slope space), reflected
    u = torch.clamp(xi[..., 1], 0.0, 1.0 - 1e-7)
    r_slope = torch.sqrt(u / (1.0 - u))
    phi_g = 2.0 * PI * xi[..., 2]
    cos_g, sin_g = torch.cos(phi_g), torch.sin(phi_g)
    h_r = torch.stack([ax * r_slope * cos_g, ay * r_slope * sin_g, torch.ones_like(r_slope)],
                      dim=-1)
    h_r = h_r / torch.clamp(_norm(h_r), min=1e-12)
    h = _rot_local(h_r, cos_r, -sin_r)
    wi_spec = 2.0 * _dot(wo_l, h)[..., None] * h - wo_l

    # clearcoat: isotropic GGX reflection with the coat roughness
    ac = torch.clamp(p.clearcoat_roughness * p.clearcoat_roughness, min=MIN_ALPHA)
    ac2 = ac * ac
    cos2hc = (1.0 - u) / torch.clamp(1.0 + (ac2 - 1.0) * u, min=1e-12)
    cos_hc = torch.sqrt(torch.clamp(cos2hc, 0.0, 1.0))
    sin_hc = torch.sqrt(torch.clamp(1.0 - cos2hc, min=0.0))
    hc = torch.stack([sin_hc * cos_g, sin_hc * sin_g, cos_hc], dim=-1)
    wi_coat = 2.0 * _dot(wo_l, hc)[..., None] * hc - wo_l

    # transmission through a thick dielectric: microfacet interface with the
    # exact Fresnel reflect/refract split (TIR falls out as F -> 1)
    alpha_t = torch.clamp(p.roughness * p.roughness, min=MIN_ALPHA)
    alpha2_t = alpha_t * alpha_t
    cos2ht = (1.0 - u) / torch.clamp(1.0 + (alpha2_t - 1.0) * u, min=1e-12)
    cos_ht = torch.sqrt(torch.clamp(cos2ht, 0.0, 1.0))
    sin_ht = torch.sqrt(torch.clamp(1.0 - cos2ht, min=0.0))
    ht = torch.stack([sin_ht * cos_g, sin_ht * sin_g, cos_ht], dim=-1)
    eta_rel = torch.where(front, p.ior, safe_div(torch.ones_like(p.ior), p.ior))
    c_oh = torch.clamp(_dot(wo_l, ht), min=0.0)
    f_t = _fresnel_dielectric(c_oh, eta_rel)
    eta_inv = safe_div(torch.ones_like(eta_rel), eta_rel)
    k_t = 1.0 - eta_inv * eta_inv * (1.0 - c_oh * c_oh)
    cos_t = torch.sqrt(torch.clamp(k_t, min=0.0))
    wi_refr = -eta_inv[..., None] * wo_l + (eta_inv * c_oh - cos_t)[..., None] * ht
    wi_trefl = 2.0 * c_oh[..., None] * ht - wo_l
    refl_pick = xi[..., 3] < f_t
    thin = _thin(p)
    wi_trans = torch.where(thin[..., None], -wo_l,
                           torch.where(refl_pick[..., None], wi_trefl, wi_refr))

    wi_l = torch.where(pick_d[..., None], wi_diff,
                       torch.where(pick_g[..., None], wi_spec,
                                   torch.where(pick_c[..., None], wi_coat, wi_trans)))

    f_diffuse, f_glossy, pdf = _eval_lobes(p, wo_l, wi_l)
    bsdf_over_pdf = safe_div(f_diffuse + f_glossy, pdf[..., None])

    # transmission lobe weights (delta-treated; the Smith G1 of wi carries
    # the rough interface's shadowing for both branches)
    cos_o_c = torch.clamp(wo_l[..., 2], min=0.0)
    g1_wi = _smith_g1(alpha2_t, wi_l[..., 2].abs())
    thin_weight = p.transmission[..., None] * (1.0 - _schlick(f0, cos_o_c[..., None]))
    thick_weight = (p.transmission * g1_wi)[..., None] * torch.ones_like(f0)
    trans_weight = torch.where(thin[..., None], thin_weight, thick_weight)
    bsdf_over_pdf = torch.where(pick_t[..., None], safe_div(trans_weight, p_t[..., None]),
                                bsdf_over_pdf)

    valid = torch.where(pick_t, (p_t > 0.0) & (thin | refl_pick | (k_t > 0.0)),
                        (pdf > 1e-12) & (wi_l[..., 2] > 0.0) & (wo_l[..., 2] > 0.0))
    event = torch.where(
        pick_d, BSDF_EVENT_DIFFUSE_REFLECTION,
        torch.where(pick_g | pick_c, BSDF_EVENT_GLOSSY_REFLECTION,
                    torch.where(thin | ~refl_pick, BSDF_EVENT_SPECULAR_TRANSMISSION,
                                BSDF_EVENT_GLOSSY_REFLECTION)))
    event = torch.where(valid, event, BSDF_EVENT_ABSORB).to(torch.int32)
    bsdf_over_pdf = torch.where(valid[..., None], bsdf_over_pdf, 0.0)
    return _from_local(wi_l, t, b, n), bsdf_over_pdf, event, pdf


def auxiliary(p: BsdfParams, wo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """mdl_bsdf_scattering_auxiliary: albedo_diffuse + albedo_glossy (the
    Albedo AOV, rp_main.chit:268-290)."""
    f0 = _f0(p)
    cos_o = torch.clamp(_dot(wo, n), min=0.0)
    att = _coat_atten(p, cos_o)[..., None]
    albedo_diffuse = p.base_color * (
        att[..., 0] * (1.0 - p.metallic) * (1.0 - p.transmission))[..., None]
    fc = _COAT_F0 + (1.0 - _COAT_F0) * torch.clamp(1.0 - cos_o, 0.0, 1.0) ** 5
    albedo_glossy = _schlick(f0, cos_o[..., None]) * att + (p.clearcoat * fc)[..., None]
    return albedo_diffuse + albedo_glossy


def edf_emission(p: BsdfParams) -> torch.Tensor:
    """mdl_edf_emission_evaluate * intensity: the emitted radiance."""
    return p.emissive


def cutout_opacity(p: BsdfParams) -> torch.Tensor:
    """mdl_cutout_opacity: binary with a positive opacityThreshold, else
    the opacity itself is the stochastic pass probability."""
    binary = (p.opacity >= p.opacity_threshold).to(torch.float32)
    return torch.where(p.opacity_threshold > 0.0, binary, p.opacity)
