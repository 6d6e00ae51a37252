"""Geohash encoding + haversine distance for the spatial index.

The reference indexes memories under precision-10 geohash keys
(``geo:{hash}:{id}``, storage.rs:1616-1624) and prefilters by radius.
This is a standard base-32 geohash implementation (public algorithm,
Niemeyer 2008) written fresh.
"""

from __future__ import annotations

import math

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"

EARTH_RADIUS_M = 6_371_000.0


def encode(lat: float, lon: float, precision: int = 10) -> str:
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    bits = []
    even = True
    while len(bits) < precision * 5:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                bits.append(1)
                lon_lo = mid
            else:
                bits.append(0)
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                bits.append(1)
                lat_lo = mid
            else:
                bits.append(0)
                lat_hi = mid
        even = not even
    out = []
    for i in range(0, len(bits), 5):
        idx = 0
        for b in bits[i : i + 5]:
            idx = (idx << 1) | b
        out.append(_BASE32[idx])
    return "".join(out)


def decode(gh: str) -> tuple[float, float]:
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for c in gh:
        idx = _BASE32.index(c)
        for shift in range(4, -1, -1):
            bit = (idx >> shift) & 1
            if even:
                mid = (lon_lo + lon_hi) / 2
                if bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return (lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2


def haversine_m(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    """Great-circle distance in meters."""
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * EARTH_RADIUS_M * math.asin(math.sqrt(a))


# Geohash cell sizes (approx, meters) by precision — used to pick the prefix
# length whose cell comfortably covers a search radius.
_CELL_M = {
    1: 5_000_000,
    2: 1_250_000,
    3: 156_000,
    4: 39_100,
    5: 4_890,
    6: 1_220,
    7: 153,
    8: 38,
    9: 4.8,
    10: 1.2,
}


def precision_for_radius(radius_m: float) -> int:
    for p in range(10, 0, -1):
        if _CELL_M[p] >= radius_m:
            return p
    return 1


_NEIGHBOR_DELTAS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]


def cover(lat: float, lon: float, radius_m: float) -> list[str]:
    """Geohash prefixes covering a radius: the center cell + 8 neighbors
    at a precision whose cell size >= radius (so 3x3 covers the circle)."""
    p = precision_for_radius(radius_m)
    # Approximate neighbor centers by offsetting lat/lon by one cell size.
    cell_deg_lat = 180.0 / (2 ** ((5 * p) // 2))
    cell_deg_lon = 360.0 / (2 ** ((5 * p + 1) // 2))
    out = set()
    for di, dj in _NEIGHBOR_DELTAS:
        nlat = min(90.0, max(-90.0, lat + di * cell_deg_lat))
        nlon = lon + dj * cell_deg_lon
        if nlon > 180.0:
            nlon -= 360.0
        if nlon < -180.0:
            nlon += 360.0
        out.add(encode(nlat, nlon, p))
    return sorted(out)
