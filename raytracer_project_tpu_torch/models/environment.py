"""Environment lighting table (twin of
raytracer_project_tpu/models/environment.py, subset).

Modes: PHYSICAL_SUN (procedural sun-sky), HDR_MAP (equirect image) and
SOLID_COLOR (environment.hpp:8-77, camera.hpp:828-925). The fused pool
shades the background inside the shade-advance kernel (ops/fused_step.py);
the chunked integrator uses `background_color` here and the unfused pool
`background_color_soa`. The module also holds the parameter table, its
constructor, the HDR map lookup under the asset root (`refresh_hdr_list`,
`load_hdr_by_name`) and the astronomical sun model of the reference UI
(main.cpp:822-893).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..core import soa, vecmath
from ..core.constants import PI
from ..core.tree import to_device, unflatten

PHYSICAL_SUN = 0
HDR_MAP = 1
SOLID_COLOR = 2

# HDR map directory under the asset root (environment.hpp:6): the
# RAYTRACER_TPU_ASSETS variable, else ./assets.
HDR_DIR = "hdr_maps"


def refresh_hdr_list(directory: str | None = None) -> list[str]:
    """Sorted absolute paths of the environment maps in `directory`, else
    in $RAYTRACER_TPU_ASSETS/hdr_maps or ./assets/hdr_maps (reference
    refresh_hdr_list, environment.py:34; camera.hpp:123-140). Call again to
    see files added since."""
    if directory is None:
        directory = os.path.join(os.environ.get("RAYTRACER_TPU_ASSETS", "assets"),
                                 HDR_DIR)
    if not os.path.isdir(directory):
        return []
    return sorted(os.path.abspath(os.path.join(directory, f))
                  for f in os.listdir(directory)
                  if f.lower().endswith((".hdr", ".exr", ".png", ".jpg", ".jpeg")))


def load_hdr_by_name(name: str, directory: str | None = None) -> np.ndarray:
    """The map whose path, file name or stem is `name`, as f32 [H, W, 3];
    the black 1x1 fallback when there is none or it does not load
    (environment.hpp:64-68)."""
    from ..utils import image_io

    for path in refresh_hdr_list(directory):
        base = os.path.basename(path)
        if name in (path, base, base.rsplit(".", 1)[0]):
            img = (image_io.load_hdr(path) if path.lower().endswith(".hdr")
                   else image_io.load_image(path))
            if img is not None:
                return np.asarray(img, np.float32)
    return np.zeros((1, 1, 3), np.float32)


class Environment(NamedTuple):
    """Environment parameters (f32 tensors). hdr_image is an equirect
    [H, W, 3] linear-radiance map, a 1x1 black placeholder when unused."""

    background_color: torch.Tensor  # [3]
    intensity: torch.Tensor         # []
    hdr_image: torch.Tensor         # [H, W, 3]
    hdri_rotation: torch.Tensor     # [] yaw, radians
    hdri_tilt: torch.Tensor         # [] pitch, radians
    hdri_roll: torch.Tensor         # [] roll, radians
    sun_direction: torch.Tensor     # [3]
    sun_color: torch.Tensor         # [3]
    sun_intensity: torch.Tensor     # []
    sun_size: torch.Tensor          # [] UI scale 0.1..10 (camera.hpp:914)

    def to(self, device):
        return to_device(self, device)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def make_environment(
    *,
    background_color=(0.5, 0.7, 1.0),
    intensity=1.0,
    hdr_image=None,
    hdri_rotation=0.0,
    hdri_tilt=0.0,
    hdri_roll=0.0,
    sun_direction=(0.5, 0.8, 0.3),
    sun_color=(1.0, 0.95, 0.9),
    sun_intensity=5.0,
    sun_size=1.0,
) -> Environment:
    if hdr_image is None:
        hdr_image = np.zeros((1, 1, 3), np.float32)  # black fallback
    return Environment(
        background_color=_f32(background_color),
        intensity=_f32(intensity),
        hdr_image=_f32(hdr_image),
        hdri_rotation=_f32(hdri_rotation),
        hdri_tilt=_f32(hdri_tilt),
        hdri_roll=_f32(hdri_roll),
        sun_direction=_f32(sun_direction),
        sun_color=_f32(sun_color),
        sun_intensity=_f32(sun_intensity),
        sun_size=_f32(sun_size),
    )


def environment_from_numpy(d: dict) -> Environment:
    """Environment from a flat {field name: numpy array} dict."""
    return unflatten(Environment, d)


# Shaders of the chunked integrator: unit directions [N, 3] -> radiance
# [N, 3] (camera.hpp:828-925). The fused pool shades inside K3.

def shade_solid(env: Environment, unit_dir):
    """SOLID_COLOR mode (camera.hpp:832-834)."""
    c = env.background_color * env.intensity
    return c.expand(unit_dir.shape[:-1] + (3,))


def shade_hdr(env: Environment, unit_dir):
    """HDR_MAP mode: yaw/pitch/roll rotation and a nearest equirect lookup
    with u wrapping and v clamped (camera.hpp:837-870)."""
    x, y, z = unit_dir[..., 0], unit_dir[..., 1], unit_dir[..., 2]
    cy, sy = torch.cos(env.hdri_rotation), torch.sin(env.hdri_rotation)
    x, z = cy * x + sy * z, -sy * x + cy * z
    cp, sp = torch.cos(env.hdri_tilt), torch.sin(env.hdri_tilt)
    y, z = cp * y - sp * z, sp * y + cp * z
    cr, sr = torch.cos(env.hdri_roll), torch.sin(env.hdri_roll)
    x, y = cr * x - sr * y, sr * x + cr * y
    phi = torch.atan2(z, x) + PI
    theta = vecmath.safe_arccos(y)
    u = phi / (2.0 * PI)
    v = theta / PI
    h, w = env.hdr_image.shape[0], env.hdr_image.shape[1]
    uu = u - torch.floor(u)
    i = torch.clamp((uu * w).to(torch.int64), 0, w - 1)
    j = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return env.hdr_image[j, i] * env.intensity


def shade_sun_sky(env: Environment, unit_dir):
    """PHYSICAL_SUN mode: day/night curves, zenith/horizon gradient, sunset
    lerp and the anti-aliased sun disc (camera.hpp:871-925)."""
    dev = unit_dir.device
    const = lambda *v: torch.tensor(v, dtype=torch.float32, device=dev)
    sun_dir = vecmath.normalize(env.sun_direction)
    sun_height = sun_dir[1]
    adjusted = sun_height - 0.05
    sky_exposure = torch.clamp(adjusted * 8.0 + 1.4, 0.0, 1.0)
    day_factor = torch.clamp(adjusted * 10.0 + 1.1, 0.0, 1.0)
    sunset_i = torch.clamp(1.0 - torch.abs(adjusted + 0.05) * 30.0, 0.0, 1.0)
    sunset = torch.where(adjusted > -0.1, sunset_i, 0.0)
    sunset = torch.where(sun_height < 0.0, sunset * (sun_height * 10.0 + 1.0),
                         sunset)
    sunset = torch.clamp(sunset, 0.0, 1.0)
    zenith = (const(0.01, 0.03, 0.1) * (1.0 - day_factor)
              + const(0.2, 0.5, 1.0) * day_factor)
    horizon = (const(0.05, 0.02, 0.01) * (1.0 - day_factor)
               + const(0.6, 0.8, 1.0) * day_factor)
    horizon = horizon * (1.0 - sunset) + const(1.0, 0.35, 0.1) * sunset

    a = unit_dir[..., 1:2]
    sky = torch.where(a > 0.0, (1.0 - a) * horizon + a * zenith, horizon * 0.1)
    final = sky * (env.intensity * 1.5) * sky_exposure

    sun_focus = vecmath.dot(unit_dir, sun_dir)
    threshold = 1.0 - env.sun_size * 0.001
    s_color = env.sun_color * (1.0 - sunset) + const(1.0, 0.3, 0.1) * sunset
    visibility = torch.clamp(sun_height * 5.0 + 1.0, 0.0, 1.0)
    alpha = vecmath.smoothstep(threshold, threshold + 0.0002, sun_focus)
    disc_on = (sun_focus > threshold) & (adjusted > -0.1)
    return final + torch.where(
        disc_on[..., None],
        s_color * env.sun_intensity * visibility * alpha[..., None], 0.0)


_SHADERS = {PHYSICAL_SUN: shade_sun_sky, HDR_MAP: shade_hdr,
            SOLID_COLOR: shade_solid}


def background_color(env: Environment, direction, mode: int):
    """Radiance of rays that leave the scene (camera.hpp:828-925);
    direction [N, 3] need not be unit."""
    return _SHADERS[mode](env, vecmath.normalize(direction))


# SoA twins of the shaders for the unfused pool (reference
# environment.py:207-284): directions and radiance as (x, y, z) tuples.

def _shade_solid_soa(env: Environment, d):
    c = env.background_color * env.intensity
    one = torch.ones_like(d[0])
    return c[0] * one, c[1] * one, c[2] * one


def _shade_hdr_soa(env: Environment, d):
    x, y, z = soa.normalize(d)
    cy, sy = torch.cos(env.hdri_rotation), torch.sin(env.hdri_rotation)
    x, z = cy * x + sy * z, -sy * x + cy * z
    cp, sp = torch.cos(env.hdri_tilt), torch.sin(env.hdri_tilt)
    y, z = cp * y - sp * z, sp * y + cp * z
    cr, sr = torch.cos(env.hdri_roll), torch.sin(env.hdri_roll)
    x, y = cr * x - sr * y, sr * x + cr * y
    phi = torch.atan2(z, x) + PI
    theta = vecmath.safe_arccos(y)
    h, w = env.hdr_image.shape[0], env.hdr_image.shape[1]
    uu = phi / (2.0 * PI)
    uu = uu - torch.floor(uu)
    i = torch.clamp((uu * w).to(torch.int64), 0, w - 1)
    j = torch.clamp((theta / PI * h).to(torch.int64), 0, h - 1)
    texel = env.hdr_image[j, i] * env.intensity
    return texel[:, 0], texel[:, 1], texel[:, 2]


def _shade_sun_sky_soa(env: Environment, d):
    ux, uy, uz = soa.normalize(d)
    sd = vecmath.normalize(env.sun_direction)
    sun_height = sd[1]
    adjusted = sun_height - 0.05
    sky_exposure = torch.clamp(adjusted * 8.0 + 1.4, 0.0, 1.0)
    day_factor = torch.clamp(adjusted * 10.0 + 1.1, 0.0, 1.0)
    sunset_i = torch.clamp(1.0 - torch.abs(adjusted + 0.05) * 30.0, 0.0, 1.0)
    sunset = torch.where(adjusted > -0.1, sunset_i, 0.0)
    sunset = torch.where(sun_height < 0.0, sunset * (sun_height * 10.0 + 1.0),
                         sunset)
    sunset = torch.clamp(sunset, 0.0, 1.0)
    zen = (0.01, 0.03, 0.1)
    zday = (0.2, 0.5, 1.0)
    hor = (0.05, 0.02, 0.01)
    hday = (0.6, 0.8, 1.0)
    hsun = (1.0, 0.35, 0.1)
    scol_sunset = (1.0, 0.3, 0.1)
    visibility = torch.clamp(sun_height * 5.0 + 1.0, 0.0, 1.0)
    threshold = 1.0 - env.sun_size * 0.001
    sun_focus = ux * sd[0] + uy * sd[1] + uz * sd[2]
    alpha = vecmath.smoothstep(threshold, threshold + 0.0002, sun_focus)
    disc_on = (sun_focus > threshold) & (adjusted > -0.1)
    up = uy > 0.0
    gain = env.intensity * 1.5 * sky_exposure
    out = []
    for k in range(3):
        zenith = zen[k] * (1.0 - day_factor) + zday[k] * day_factor
        horizon = hor[k] * (1.0 - day_factor) + hday[k] * day_factor
        horizon = horizon * (1.0 - sunset) + hsun[k] * sunset
        sky = torch.where(up, (1.0 - uy) * horizon + uy * zenith, horizon * 0.1)
        s_col = env.sun_color[k] * (1.0 - sunset) + scol_sunset[k] * sunset
        disc = torch.where(disc_on,
                           s_col * env.sun_intensity * visibility * alpha, 0.0)
        out.append(sky * gain + disc)
    return tuple(out)


_SHADERS_SOA = {PHYSICAL_SUN: _shade_sun_sky_soa, HDR_MAP: _shade_hdr_soa,
                SOLID_COLOR: _shade_solid_soa}


def background_color_soa(env: Environment, direction, mode: int):
    """SoA twin of background_color: direction (need not be unit) and the
    radiance are (x, y, z) tuples of f32[N]."""
    return _SHADERS_SOA[mode](env, direction)


# Astronomical daylight (main.cpp:822-893), f32 like the reference.

def solar_position(latitude_deg, day_of_year, hour):
    """Solar (elevation, azimuth) in degrees (main.cpp:830-851)."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    lat = torch.deg2rad(f32(latitude_deg))
    decl = torch.deg2rad(
        23.45 * torch.sin(torch.deg2rad(360.0 / 365.0 * (f32(day_of_year) - 81.0))))
    hour_angle = torch.deg2rad(15.0 * (f32(hour) - 12.0))
    sin_elev = (torch.sin(lat) * torch.sin(decl)
                + torch.cos(lat) * torch.cos(decl) * torch.cos(hour_angle))
    elev = torch.arcsin(torch.clamp(sin_elev, -1.0, 1.0))
    cos_az = (torch.sin(decl) - torch.sin(elev) * torch.sin(lat)) / torch.clamp(
        torch.cos(elev) * torch.cos(lat), min=1e-6)
    az = torch.arccos(torch.clamp(cos_az, -1.0, 1.0))
    az = torch.where(hour_angle > 0.0, 2.0 * PI - az, az)
    return torch.rad2deg(elev), torch.rad2deg(az)


def direction_from_spherical(elevation_deg, azimuth_deg):
    """Spherical (degrees) -> unit direction, y-up (common.hpp:94-103)."""
    phi = torch.deg2rad(azimuth_deg)
    theta = torch.deg2rad(90.0 - elevation_deg)
    sin_t = torch.sin(theta)
    return torch.stack(
        [sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], dim=-1)


def sun_direction_from_time(latitude_deg, day_of_year, hour):
    """Sun direction via the astronomical model (main.cpp:853)."""
    elev, az = solar_position(latitude_deg, day_of_year, hour)
    return direction_from_spherical(elev, az)


def auto_sun_color(elevation_deg):
    """Altitude-keyed warm shift (main.cpp:855-871)."""
    e = torch.as_tensor(elevation_deg, dtype=torch.float32)
    t = torch.clamp(e / 60.0, 0.0, 1.0)
    low = torch.tensor([1.0, 0.45, 0.15])
    high = torch.tensor([1.0, 0.95, 0.9])
    color = low * (1.0 - t[..., None]) + high * t[..., None]
    return torch.where(e[..., None] < 0.0, torch.tensor([0.8, 0.35, 0.25]), color)
