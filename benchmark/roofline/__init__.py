"""The yardstick of the kernels' roofline shares: the H100's peaks and the
bytes that a path-tracing step's closest hit (K1) and shade-advance (K3)
must move, counted from the cell's inputs, never from the port's layout.

Both counts are algorithmic lower bounds on traffic:

* K1, per live lane: the ray read once (origin and direction, 6 x f32 =
  24 B) and its hit written once (t, primitive index, primitive type,
  3 x 4 B = 12 B): 36 B. Per launch: the scene's geometry read once, a
  sphere's centre and radius (16 B), a triangle's vertex and two edges
  (36 B), a box's affine inverse (9 + 3 floats, 48 B).
* K3, per live lane: the hit read (12 B) and the path state a path-tracing
  step reads and writes (origin, direction, throughput, radiance: 12 x f32;
  live flag, bounce, sample, pixel: 4 x i32; 64 B each way): 140 B. Per
  finished path its contribution (3 x f32 = 12 B). Per launch: the
  geometry as above (the shading record), each material's albedo, type and
  parameter (5 x 4 B = 20 B) and each fog volume (kind, bounds, density,
  albedo: 16 x 4 B = 64 B).

No operation count is used: the tests a closest-hit query needs depend on
the acceleration scheme, so a count of them would go stale under a better
cull. Both shares are therefore bounded by bytes at 3.35 TB/s.
"""

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth, f32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

K1_LANE_BYTES = 24 + 12
K3_LANE_BYTES = 12 + 64 + 64
K3_PATH_BYTES = 12
SPHERE_BYTES, TRIANGLE_BYTES, BOX_BYTES = 16, 36, 48
MATERIAL_BYTES = 20
VOLUME_BYTES = 64


def geometry_bytes(n_spheres: int, n_triangles: int, n_boxes: int) -> int:
    return (SPHERE_BYTES * n_spheres + TRIANGLE_BYTES * n_triangles
            + BOX_BYTES * n_boxes)


def k1_bytes(lanes: int, launches: int, counts) -> int:
    """Bytes K1 must move for `lanes` live-lane queries over `launches`
    launches against a scene of counts = (spheres, triangles, boxes)."""
    return K1_LANE_BYTES * lanes + launches * geometry_bytes(*counts)


def k3_bytes(lanes: int, paths: int, launches: int, counts,
             n_materials: int, n_volumes: int) -> int:
    """Bytes K3 must move for `lanes` live-lane steps that finish `paths`
    paths over `launches` launches."""
    per_launch = (geometry_bytes(*counts) + MATERIAL_BYTES * n_materials
                  + VOLUME_BYTES * n_volumes)
    return K3_LANE_BYTES * lanes + K3_PATH_BYTES * paths + launches * per_launch


def bound_seconds(nbytes: int) -> float:
    """The least seconds the H100 needs to move `nbytes`."""
    return nbytes / PEAK_BYTES_PER_S
