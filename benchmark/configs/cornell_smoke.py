"""Scene generator of the `cornell_smoke` configuration: "Ray Tracing: The
Next Week" (P. Shirley), scene `cornell_smoke` -- the 555-unit Cornell box,
a 7,7,7 light under the ceiling, and the two boxes replaced by constant
media of density 0.01, black (the tall box) and white (the short box).

Departures, stated in cornell_smoke.json: the port's fog volumes are
axis-aligned boxes or spheres, so the media are axis-aligned boxes at the
book's translated box positions without the 15 and -18 degree turns; the
walls are 1-unit boxes and the light a 1-unit slab (the port has no quad).
`build(b, cfg)` drives any builder with the port's SceneBuilder interface.
"""

from __future__ import annotations


def build(b, cfg: dict) -> None:
    p = cfg["scene"]
    s = float(p["box_size"])
    th = float(p["wall_thickness"])
    m = b.materials
    g = b.geometry
    red = m.lambertian("red", tuple(p["red"]))
    white = m.lambertian("white", tuple(p["white"]))
    green = m.lambertian("green", tuple(p["green"]))
    light = m.diffuse_light("light", tuple(p["light_emit"]))

    g.add_box((s, 0, 0), (s + th, s, s), green)      # x = 555 wall
    g.add_box((-th, 0, 0), (0, s, s), red)           # x = 0 wall
    g.add_box((0, s, 0), (s, s + th, s), white)      # ceiling
    g.add_box((0, -th, 0), (s, 0, s), white)         # floor
    g.add_box((0, 0, s), (s, s, s + th), white)      # back
    lo, hi = p["light_min"], p["light_max"]
    g.add_box(tuple(lo), tuple(hi), light)
    for medium in p["media"]:
        b.add_fog_box(tuple(medium["min"]), tuple(medium["max"]),
                      float(medium["density"]), tuple(medium["albedo"]))
