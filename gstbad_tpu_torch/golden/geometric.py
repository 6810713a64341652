"""Inverse-map builders of the 16 geometric warps
(gst/geometrictransform/).

A copy of gstbad_tpu/golden/geometric.py:mod_float .. MAP_BUILDERS: the map
functions of the 16 element sources and the geometricmath.c helpers, built
in float64 exactly like the C gdouble path and returned as [H, W, 2]
(in_x, in_y) arrays.  The base application (off-edge policy and
truncation sampling) lives in ops/remap.py:fix_map.
"""

from __future__ import annotations

import numpy as np

# ----- geometricmath.c helpers ---------------------------------------------


def mod_float(a, b):
    """gst_gm_mod_float (geometricmath.c:172-181): a - trunc(a/b)*b, then
    +b if negative."""
    n = np.trunc(a / b)
    r = a - n * b
    return np.where(r < 0, r + b, r)


def triangle(x):
    """gst_gm_triangle (geometricmath.c:184-190)."""
    r = mod_float(x, 1.0)
    return 2.0 * np.where(r < 0.5, r, 1 - r)


def smoothstep(edge0, edge1, x):
    """gst_gm_smoothstep (geometricmath.c:193-199)."""
    t = np.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _grid(w, h):
    x = np.arange(w, dtype=np.float64)[None, :].repeat(h, 0)
    y = np.arange(h, dtype=np.float64)[:, None].repeat(w, 1)
    return x, y


def _circle_precalc(w, h, x_center=0.5, y_center=0.5, radius=0.35):
    """circle_geometric_transform_precalc
    (gstcirclegeometrictransform.c:145-155)."""
    pcx = x_center * w
    pcy = y_center * h
    pr = radius * 0.5 * np.sqrt(w * w + h * h)
    return pcx, pcy, pr, pr * pr


# ----- map builders ---------------------------------------------------------


def fisheye_map(w, h):
    """fisheye_map (gstfisheye.c:85-127)."""
    x, y = _grid(w, h)
    nx = 2.0 * x / w - 1.0
    ny = 2.0 * y / h - 1.0
    r = np.sqrt((nx * nx + ny * ny) / 2.0)
    scale = 0.33 + 0.1 * r * r + 0.57 * np.power(r, 6.0)
    nx = nx * scale
    ny = ny * scale
    return np.stack([0.5 * (nx + 1.0) * w, 0.5 * (ny + 1.0) * h], -1)


def twirl_map(w, h, angle=np.pi, x_center=0.5, y_center=0.5, radius=0.35):
    """twirl_map (gsttwirl.c:139-164)."""
    pcx, pcy, pr, pr2 = _circle_precalc(w, h, x_center, y_center, radius)
    x, y = _grid(w, h)
    dx = x - pcx
    dy = y - pcy
    dist = dx * dx + dy * dy
    d = np.sqrt(dist)
    a = np.arctan2(dy, dx) + angle * (pr - d) / pr
    in_x = np.where(dist > pr2, x, pcx + d * np.cos(a))
    in_y = np.where(dist > pr2, y, pcy + d * np.sin(a))
    return np.stack([in_x, in_y], -1)


def perspective_map(w, h, matrix=None):
    """perspective_map (gstperspective.c:185-211). matrix: 9 doubles,
    row-major; default identity (gstperspective.c:60)."""
    m = np.eye(3).ravel() if matrix is None else np.asarray(matrix, np.float64)
    x, y = _grid(w, h)
    xp = m[0] * x + m[1] * y + m[2]
    yp = m[3] * x + m[4] * y + m[5]
    wp = m[6] * x + m[7] * y + m[8]
    return np.stack([xp / wp, yp / wp], -1)


def rotate_map(w, h, angle=0.0):
    """rotate_map (gstrotate.c:156-200)."""
    x, y = _grid(w, h)
    cox, coy = 0.5 * w, 0.5 * h
    xo = x - cox
    yo = y - coy
    ao = np.arctan2(yo, xo)
    r = np.sqrt(xo * xo + yo * yo)
    ai = ao + angle
    return np.stack([r * np.cos(ai) + cox, r * np.sin(ai) + coy], -1)


def bulge_map(w, h, zoom=3.0, x_center=0.5, y_center=0.5, radius=0.35):
    """bulge_map (gstbulge.c:159-200)."""
    x, y = _grid(w, h)
    nx = 2.0 * (x / w - x_center)
    ny = 2.0 * (y / h - y_center)
    r = np.sqrt(0.5 * (nx * nx + ny * ny))
    scale = 1.0 / (zoom + (1.0 - zoom) * smoothstep(0, radius, r))
    nx *= scale
    ny *= scale
    return np.stack([(0.5 * nx + x_center) * w, (0.5 * ny + y_center) * h], -1)


def pinch_map(w, h, intensity=0.5, x_center=0.5, y_center=0.5, radius=0.35):
    """pinch_map (gstpinch.c:150-190)."""
    pcx, pcy, pr, pr2 = _circle_precalc(w, h, x_center, y_center, radius)
    x, y = _grid(w, h)
    dx = x - pcx
    dy = y - pcy
    dist = dx * dx + dy * dy
    inside = ~((dist > pr2) | (dist == 0))
    d = np.sqrt(np.where(inside, dist, 1.0) / pr2)
    t = np.power(np.sin(np.pi * 0.5 * d), -intensity)
    in_x = np.where(inside, pcx + dx * t, x)
    in_y = np.where(inside, pcy + dy * t, y)
    return np.stack([in_x, in_y], -1)


def sphere_map(w, h, refraction=1.5, x_center=0.5, y_center=0.5, radius=0.35):
    """sphere_map (gstsphere.c:148-196).  Note the reference's condition
    `dy2 >= r2 - (r2*dx2)/r2` reduces to dy2 >= r2 - dx2."""
    pcx, pcy, pr, pr2 = _circle_precalc(w, h, x_center, y_center, radius)
    x, y = _grid(w, h)
    dx = x - pcx
    dy = y - pcy
    dx2 = dx * dx
    dy2 = dy * dy
    outside = dy2 >= (pr2 - (pr2 * dx2) / pr2)
    with np.errstate(invalid="ignore", divide="ignore"):
        z = np.sqrt(np.maximum(1.0 - dx2 / pr2 - dy2 / pr2, 0.0) * pr2)
        z2 = z * z
        r_refr = 1.0 / refraction

        def bend(dc, dc2):
            angle = np.arccos(np.clip(dc / np.sqrt(dc2 + z2), -1, 1))
            angle1 = np.pi / 2 - angle
            angle2 = np.arcsin(np.sin(angle1) * r_refr)
            angle2 = np.pi / 2 - angle - angle2
            return np.tan(angle2) * z

        in_x = np.where(outside, x, x - bend(dx, dx2))
        in_y = np.where(outside, y, y - bend(dy, dy2))
    return np.stack([in_x, in_y], -1)


def kaleidoscope_map(w, h, angle=0.0, angle2=0.0, sides=3,
                     x_center=0.5, y_center=0.5, radius=0.35):
    """kaleidoscope_map (gstkaleidoscope.c:150-190)."""
    pcx, pcy, pr, pr2 = _circle_precalc(w, h, x_center, y_center, radius)
    x, y = _grid(w, h)
    dx = x - pcx
    dy = y - pcy
    distance = np.sqrt(dx * dx + dy * dy)
    theta = np.arctan2(dy, dx) - angle - angle2
    theta = triangle(theta / np.pi * sides * 0.5)
    if pr != 0:
        radiusc = pr / np.cos(theta)
        distance = radiusc * triangle(distance / radiusc)
    theta = theta + angle
    return np.stack([pcx + distance * np.cos(theta),
                     pcy + distance * np.sin(theta)], -1)


def circle_map(w, h, angle=0.0, height=20.0, spread_angle=np.pi,
               x_center=0.5, y_center=0.5, radius=0.35):
    """circle_map (gstcircle.c:131-160)."""
    pcx, pcy, pr, _ = _circle_precalc(w, h, x_center, y_center, radius)
    x, y = _grid(w, h)
    dx = x - pcx
    dy = y - pcy
    distance = np.sqrt(dx * dx + dy * dy)
    theta = np.arctan2(-dy, -dx) + angle
    theta = mod_float(theta, 2 * np.pi)
    in_x = w * theta / (spread_angle + 0.0001)
    in_y = h * (1 - (distance - pr) / (height + 0.0001))
    return np.stack([in_x, in_y], -1)


def waterripple_map(w, h, amplitude=10.0, phase=0.0, wavelength=16.0,
                    x_center=0.5, y_center=0.5, radius=0.35):
    """water_ripple_map (gstwaterripple.c:148-190)."""
    pcx, pcy, pr, pr2 = _circle_precalc(w, h, x_center, y_center, radius)
    x, y = _grid(w, h)
    dx = x - pcx
    dy = y - pcy
    dist = dx * dx + dy * dy
    d = np.sqrt(dist)
    amount = amplitude * np.sin(d / wavelength * np.pi * 2 - phase)
    amount = amount * (pr - d) / pr
    amount = np.where(d != 0, amount * (wavelength / np.where(d != 0, d, 1.0)),
                      amount)
    in_x = np.where(dist > pr2, x, x + dx * amount)
    in_y = np.where(dist > pr2, y, y + dy * amount)
    return np.stack([in_x, in_y], -1)


def stretch_map(w, h, intensity=0.5, x_center=0.5, y_center=0.5, radius=0.35):
    """stretch_map (gststretch.c:144-186); MAX_SHRINK_AMOUNT=3.0."""
    x, y = _grid(w, h)
    nx = 2.0 * (x / w - x_center)
    ny = 2.0 * (y / h - y_center)
    r = np.sqrt(0.5 * (nx * nx + ny * ny))
    a = 1.0 + (3.0 - 1.0) * intensity
    b = a - 1.0
    s = a - b * smoothstep(0.0, radius, r)
    nx *= s
    ny *= s
    return np.stack([(0.5 * nx + x_center) * w, (0.5 * ny + y_center) * h], -1)


def tunnel_map(w, h, x_center=0.5, y_center=0.5, radius=0.35):
    """tunnel_map (gsttunnel.c:125-160)."""
    x, y = _grid(w, h)
    m = max(w, h)
    nx = 2.0 * (x - x_center * w) / m
    ny = 2.0 * (y - y_center * h) / m
    r = np.sqrt(0.5 * (nx * nx + ny * ny))
    with np.errstate(invalid="ignore", divide="ignore"):
        f = np.clip(r, 0.0, radius) / r
    nx *= f
    ny *= f
    return np.stack([0.5 * nx * m + x_center * w,
                     0.5 * ny * m + y_center * h], -1)


def square_map(w, h, width=0.5, height=0.5, zoom=2.0):
    """square_map (gstsquare.c:122-160)."""
    x, y = _grid(w, h)
    nx = 2.0 * x / w - 1.0
    ny = 2.0 * y / h - 1.0
    nx = nx * (1.0 / zoom) * (1.0 + (zoom - 1.0)
                              * smoothstep(width - 0.125, width + 0.125,
                                           np.abs(nx)))
    ny = ny * (1.0 / zoom) * (1.0 + (zoom - 1.0)
                              * smoothstep(height - 0.125, height + 0.125,
                                           np.abs(ny)))
    return np.stack([0.5 * (nx + 1.0) * w, 0.5 * (ny + 1.0) * h], -1)


def mirror_map(w, h, mode="left"):
    """mirror_map (gstmirror.c:128-170)."""
    x, y = _grid(w, h)
    hw = w / 2.0 - 1.0
    hh = h / 2.0 - 1.0
    if mode == "left":
        in_x = np.where(x > hw, w - 1.0 - x, x)
        in_y = y
    elif mode == "right":
        in_x = np.where(x > hw, x, w - 1.0 - x)
        in_y = y
    elif mode == "top":
        in_y = np.where(y > hh, h - 1.0 - y, y)
        in_x = x
    elif mode == "bottom":
        in_y = np.where(y > hh, y, h - 1.0 - y)
        in_x = x
    else:
        raise ValueError(mode)
    return np.stack([in_x, in_y], -1)


def diffuse_map(w, h, scale=4.0, rng=None):
    """diffuse_map (gstdiffuse.c:151-186): random displacement from 256-entry
    sin/cos tables.  The reference draws per-pixel random angles/distances;
    we take an explicit RNG for reproducibility."""
    rng = rng or np.random.default_rng(0)
    i = np.arange(256)
    ang = i * 2 * np.pi / 256.0
    sin_t = scale * np.sin(ang)
    cos_t = scale * np.cos(ang)
    x, y = _grid(w, h)
    angle = rng.integers(0, 256, size=(h, w))
    distance = rng.random(size=(h, w))
    return np.stack([x + distance * sin_t[angle],
                     y + distance * cos_t[angle]], -1)


def marble_map(w, h, xscale=4.0, yscale=4.0, turbulence=1.0, rng=None):
    """marble_map (gstmarble.c:192-222): Perlin-ish noise displacement into
    sin/cos tables.  gst_gm_noise_2 seeds from g_random_int(); we use an
    explicit RNG and the same table construction (geometricmath.c:70-100)."""
    rng = rng or np.random.default_rng(0)
    B = 0x100
    BM = 0xFF
    N = 0x1000
    p = np.arange(B)
    g2 = rng.integers(0, 2 * B, size=(B, 2)) - B
    g2 = g2 / float(B)
    norm = np.sqrt((g2 * g2).sum(-1, keepdims=True))
    g2 = g2 / np.where(norm == 0, 1.0, norm)
    for i in range(B - 1, -1, -1):
        j = int(rng.integers(0, B))
        p[i], p[j] = p[j], p[i]
    p = np.concatenate([p, p, p[:2]])
    g2 = np.concatenate([g2, g2, g2[:2]])

    def s_curve(t):
        return t * t * (3.0 - 2.0 * t)

    def noise2(xx, yy):
        t = xx + N
        bx0 = t.astype(np.int64) & BM
        bx1 = (bx0 + 1) & BM
        rx0 = t - np.trunc(t)
        rx1 = rx0 - 1.0
        t = yy + N
        by0 = t.astype(np.int64) & BM
        by1 = (by0 + 1) & BM
        ry0 = t - np.trunc(t)
        ry1 = ry0 - 1.0
        i = p[bx0]
        j = p[bx1]
        b00 = p[i + by0]
        b10 = p[j + by0]
        b01 = p[i + by1]
        b11 = p[j + by1]
        sx = s_curve(rx0)
        sy = s_curve(ry0)
        u = rx0 * g2[b00, 0] + ry0 * g2[b00, 1]
        v = rx1 * g2[b10, 0] + ry0 * g2[b10, 1]
        a = u + sx * (v - u)
        u = rx0 * g2[b01, 0] + ry1 * g2[b01, 1]
        v = rx1 * g2[b11, 0] + ry1 * g2[b11, 1]
        b = u + sx * (v - u)
        return 1.5 * (a + sy * (b - a))

    i = np.arange(256)
    ang = np.pi * 2 * i / 256.0 * turbulence
    sin_t = -yscale * np.sin(ang)
    cos_t = yscale * np.cos(ang)
    x, y = _grid(w, h)
    disp = 127 * (1 + noise2(x / xscale, y / xscale))
    disp = np.clip(disp.astype(np.int64), 0, 255)
    return np.stack([x + sin_t[disp], y + cos_t[disp]], -1)


MAP_BUILDERS = {
    "fisheye": fisheye_map, "twirl": twirl_map, "perspective": perspective_map,
    "rotate": rotate_map, "bulge": bulge_map, "pinch": pinch_map,
    "sphere": sphere_map, "kaleidoscope": kaleidoscope_map,
    "circle": circle_map, "waterripple": waterripple_map,
    "stretch": stretch_map, "tunnel": tunnel_map, "square": square_map,
    "mirror": mirror_map, "diffuse": diffuse_map, "marble": marble_map,
}
