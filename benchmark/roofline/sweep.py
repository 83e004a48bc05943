"""The ray sweeps' least work a ray (csrc/intersect_sweep.cu's two
entries, as PERF.md §6 counts them when this benchmark was defined).

A ray is priced at the cheaper of the two entries' bounds, whatever entry
traced it, so the count stays right whatever implements the sweep:
- closest hit: the ray in (6 float32) and its distance (float32) and
  primitive (int64) out, 36 bytes; every primitive tested, 1,181.3
  operations a ray on scene 0 (PERF.md §6: 262,144 random rays, 4.62 us,
  bound by operations; 9.4 MB = 2.8 us);
- any hit: direction and distance (16 bytes), the ray's own point (12) and
  its mask and answer bytes (2), 30 bytes; the origin and tmax (7
  operations) and at least one primitive, the cheapest a sphere's 25.
The any-hit bound (bytes) is the cheaper, so every ray is priced at it.
"""

from .peaks import least_seconds

CLOSEST_BYTES = 6 * 4 + 4 + 8
CLOSEST_OPS_SCENE0 = 1181.3
ANYHIT_BYTES = 16 + 12 + 2
ANYHIT_OPS = 7 + 25


def closest_seconds(rays: int, ops_per_ray: float = CLOSEST_OPS_SCENE0):
    return least_seconds(rays * CLOSEST_BYTES, rays * ops_per_ray)[0]


def anyhit_seconds(rays: int):
    return least_seconds(rays * ANYHIT_BYTES, rays * ANYHIT_OPS)[0]


def least_seconds_for(rays: int) -> float:
    """The least seconds the sweeps could take for ``rays`` useful rays."""
    return min(closest_seconds(rays), anyhit_seconds(rays))


def roofline_pct(rays: int, device_s: float):
    """Share (%) of the sweeps' device time that their least time is; None
    where no sweep ran."""
    if rays <= 0 or device_s <= 0:
        return None
    return 100.0 * least_seconds_for(rays) / device_s
