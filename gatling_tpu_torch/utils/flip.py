"""LDR-FLIP perceptual image difference (Andersson et al. 2020,
"FLIP: A Difference Evaluator for Alternating Images", HPG), and the sRGB
encode of COLOR (`srgb_encode`) that the graphical harness
(gatling_tpu_torch/testing.py) diffs; the port's own copy of the JAX
package's gatling_tpu/flip.py.

The harness gates on exact error-component counts and on the mean FLIP
score per product. Pure NumPy, from the published algorithm:

1. color pipeline: sRGB -> linear -> opponent YCxCz, spatially filtered by
   contrast-sensitivity functions (sum-of-Gaussians per channel), back to
   linear RGB, to Hunt-adjusted L*a*b*, HyAB distance, perceptual
   redistribution,
2. feature pipeline: edge/point detection on achromatic contrast with
   derivative-of-Gaussian filters,
3. final: dE = dE_color ^ (1 - dE_feature), per pixel in [0, 1].
"""

from __future__ import annotations

import numpy as np

# sRGB <-> XYZ (D65) and the YCxCz opponent space of the paper
_RGB2XYZ = np.array([
    [0.41238656, 0.35759149, 0.18045049],
    [0.21263682, 0.71518298, 0.07218020],
    [0.01933062, 0.11919716, 0.95037259],
], np.float64)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_D65 = np.array([0.950428, 1.0, 1.088795], np.float64)


def _srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_xyz(rgb):
    return rgb @ _RGB2XYZ.T


def _xyz_to_linear(xyz):
    return xyz @ _XYZ2RGB.T


def _xyz_to_ycxcz(xyz):
    y = 116.0 * xyz[..., 1] / _D65[1] - 16.0
    cx = 500.0 * (xyz[..., 0] / _D65[0] - xyz[..., 1] / _D65[1])
    cz = 200.0 * (xyz[..., 1] / _D65[1] - xyz[..., 2] / _D65[2])
    return np.stack([y, cx, cz], axis=-1)


def _ycxcz_to_xyz(ycxcz):
    yy = (ycxcz[..., 0] + 16.0) / 116.0
    x = (ycxcz[..., 1] / 500.0 + yy) * _D65[0]
    z = (yy - ycxcz[..., 2] / 200.0) * _D65[2]
    return np.stack([x, yy * _D65[1], z], axis=-1)


def _xyz_to_lab_hunt(xyz):
    """CIELAB with the Hunt adjustment (a,b scaled by L/100) used by FLIP."""
    r = xyz / _D65

    def f(t):
        delta = 6.0 / 29.0
        return np.where(t > delta ** 3, np.cbrt(np.maximum(t, 1e-30)),
                        t / (3 * delta * delta) + 4.0 / 29.0)

    fr = f(r)
    L = 116.0 * fr[..., 1] - 16.0
    a = 500.0 * (fr[..., 0] - fr[..., 1])
    b = 200.0 * (fr[..., 1] - fr[..., 2])
    scale = np.maximum(L, 0.0) * 0.01
    return np.stack([L, a * scale, b * scale], axis=-1)


def _hyab(a, b):
    d = a - b
    return np.abs(d[..., 0]) + np.sqrt(d[..., 1] ** 2 + d[..., 2] ** 2)


def _separable_filter(img, kernel):
    """Same-size separable convolution with edge clamp (one [K] kernel)."""
    pad = len(kernel) // 2
    out = img
    for axis in (0, 1):
        p = np.take(out, np.clip(np.arange(-pad, out.shape[axis] + pad), 0,
                                 out.shape[axis] - 1), axis=axis)
        out = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="valid"), axis, p)
    return out


def _csf_kernel(a1, b1, a2, b2, ppd):
    """Spatial-domain sum-of-Gaussians CSF kernel (paper eq. 2-3):
    g(x) = a1*sqrt(pi/b1)*exp(-pi^2 x^2 / b1) + a2*sqrt(pi/b2)*exp(...)."""
    # kernel radius: 3 sigma of the wider Gaussian, in pixels
    sigma_max = max(np.sqrt(b1 / (2 * np.pi ** 2)),
                    np.sqrt(b2 / (2 * np.pi ** 2)))
    radius = int(np.ceil(3.0 * sigma_max * ppd))
    x = np.arange(-radius, radius + 1, dtype=np.float64) / ppd
    g = (a1 * np.sqrt(np.pi / b1) * np.exp(-np.pi ** 2 * x ** 2 / b1)
         + a2 * np.sqrt(np.pi / b2) * np.exp(-np.pi ** 2 * x ** 2 / b2))
    return g / g.sum()


def _feature_kernels(ppd):
    """First/second derivative-of-Gaussian kernels (w = 0.082 deg)."""
    w = 0.082
    sigma = 0.5 * w * ppd
    radius = int(np.ceil(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    dg = -x * g          # edge detector
    ddg = (x ** 2 / (sigma ** 2) - 1.0) * g  # point detector
    # normalize: positive and negative lobes each sum to 1 (paper appendix)
    def norm(k):
        pos = k[k > 0].sum()
        neg = -k[k < 0].sum()
        s = max(pos, neg)
        return k / s if s > 0 else k
    return g / g.sum(), norm(dg), norm(ddg)


def _filter_xy(img, kx, ky):
    pad_x, pad_y = len(kx) // 2, len(ky) // 2
    p = np.take(img, np.clip(np.arange(-pad_y, img.shape[0] + pad_y), 0,
                             img.shape[0] - 1), axis=0)
    p = np.apply_along_axis(lambda m: np.convolve(m, ky, mode="valid"), 0, p)
    p = np.take(p, np.clip(np.arange(-pad_x, p.shape[1] + pad_x), 0,
                           p.shape[1] - 1), axis=1)
    return np.apply_along_axis(lambda m: np.convolve(m, kx, mode="valid"), 1, p)


def flip(reference: np.ndarray, test: np.ndarray,
         pixels_per_degree: float = 67.0) -> np.ndarray:
    """Per-pixel LDR-FLIP error map in [0,1].

    Inputs are sRGB-encoded images, [H,W,3] float in [0,1] or uint8."""
    def prep(img):
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float64) / 255.0
        return np.clip(img[..., :3].astype(np.float64), 0.0, 1.0)

    ref = prep(reference)
    tst = prep(test)
    ppd = float(pixels_per_degree)

    # ---- color pipeline ----
    ycc_r = _xyz_to_ycxcz(_linear_to_xyz(_srgb_to_linear(ref)))
    ycc_t = _xyz_to_ycxcz(_linear_to_xyz(_srgb_to_linear(tst)))

    # CSF parameters (paper table): achromatic, red-green, blue-yellow
    k_a = _csf_kernel(1.0, 0.0047, 0.0, 1e-5, ppd)
    k_rg = _csf_kernel(1.0, 0.0053, 0.0, 1e-5, ppd)
    k_by = _csf_kernel(34.1, 0.04, 13.5, 0.025, ppd)

    def filter_ycc(ycc):
        out = np.empty_like(ycc)
        out[..., 0] = _separable_filter(ycc[..., 0], k_a)
        out[..., 1] = _separable_filter(ycc[..., 1], k_rg)
        out[..., 2] = _separable_filter(ycc[..., 2], k_by)
        return out

    def to_lab(ycc):
        rgb = np.clip(_xyz_to_linear(_ycxcz_to_xyz(ycc)), 0.0, 1.0)
        return _xyz_to_lab_hunt(_linear_to_xyz(rgb))

    lab_r = to_lab(filter_ycc(ycc_r))
    lab_t = to_lab(filter_ycc(ycc_t))

    de = _hyab(lab_r, lab_t)
    qc, pc, pt = 0.7, 0.4, 0.95
    # cmax: HyAB distance between Hunt-adjusted green and blue
    green = _xyz_to_lab_hunt(_linear_to_xyz(np.array([[0.0, 1.0, 0.0]])))
    blue = _xyz_to_lab_hunt(_linear_to_xyz(np.array([[0.0, 0.0, 1.0]])))
    cmax = float(_hyab(green, blue)[0]) ** qc
    de = np.minimum(de, np.inf) ** qc
    e_color = np.where(
        de < pc * cmax,
        (pt / (pc * cmax)) * de,
        pt + ((de - pc * cmax) / (cmax - pc * cmax)) * (1.0 - pt))
    e_color = np.clip(e_color, 0.0, 1.0)

    # ---- feature pipeline (achromatic contrast in [0,1]) ----
    ach_r = (ycc_r[..., 0] + 16.0) / 116.0
    ach_t = (ycc_t[..., 0] + 16.0) / 116.0
    g, dg, ddg = _feature_kernels(ppd)

    def edges_points(y):
        ex = _filter_xy(y, dg, g)
        ey = _filter_xy(y, g, dg)
        px = _filter_xy(y, ddg, g)
        py = _filter_xy(y, g, ddg)
        return np.sqrt(ex ** 2 + ey ** 2), np.sqrt(px ** 2 + py ** 2)

    er, pr = edges_points(ach_r)
    et, pt_ = edges_points(ach_t)
    qf = 0.5
    e_feat = np.maximum(np.abs(er - et), np.abs(pr - pt_))
    e_feat = np.clip((e_feat / np.sqrt(2.0)) ** qf, 0.0, 1.0)

    return np.clip(e_color ** (1.0 - e_feat), 0.0, 1.0)


def mean_flip(reference: np.ndarray, test: np.ndarray,
              pixels_per_degree: float = 67.0) -> float:
    """Mean LDR-FLIP score (0 = identical, toward 1 = very different)."""
    return float(flip(reference, test, pixels_per_degree).mean())


def srgb_encode(rgb: np.ndarray) -> np.ndarray:
    """Linear values, clipped to [0, 1], through the sRGB transfer curve
    (float64), as the harness encodes COLOR (main.cpp:332-376)."""
    rgb = np.clip(rgb.astype(np.float64), 0.0, 1.0)
    return np.where(rgb <= 0.0031308, rgb * 12.92,
                    1.055 * np.power(np.maximum(rgb, 1e-9), 1 / 2.4) - 0.055)

