"""Reverse geocoding for video GPS metadata.

Copy of eioku_tpu/services/geocoding.py for the PyTorch port.

Capability parity: backend/src/services/reverse_geocoding_service.py:12-54
(Nominatim via geopy with an LRU cache, returning country/state/city). This
environment has zero network egress and no geopy, so the default resolver is
fully offline: nearest-city matching over an embedded ~1,350-city dataset with
admin regions (services/geo_data.py) gives city-level results near population
centers, with country bounding boxes as the open-country fallback. A
network-backed resolver can be plugged in via the same interface.
"""
from __future__ import annotations

from functools import lru_cache

from eioku_tpu_torch.services.geo_data import (
    CITIES,
    COUNTRY_BOXES,
    city_coords,
    haversine_km,
)

# beyond this distance a city attribution would be misleading: fall back to
# (country, state) and then to country boxes
CITY_RADIUS_KM = 60.0
STATE_RADIUS_KM = 200.0
# within this distance the city itself is stronger evidence than any coarse
# country box: skip the border sanity check (boxes miss exclaves/islands —
# the Alaska panhandle sits inside Canada's box, Rhodes outside Greece's)
TRUST_CITY_KM = 25.0


class ReverseGeocoder:
    """Interface: resolve (lat, lon) -> {country, state, city} (fields may be None)."""

    def get_location_info(self, latitude: float, longitude: float) -> dict:
        raise NotImplementedError


class OfflineReverseGeocoder(ReverseGeocoder):
    @staticmethod
    def _box_countries(lat_q: float, lon_q: float) -> list[str]:
        return [name for name, lat0, lat1, lon0, lon1 in COUNTRY_BOXES
                if lat0 <= lat_q <= lat1 and lon0 <= lon_q <= lon1]

    @lru_cache(maxsize=1000)
    def _lookup(self, lat_q: float, lon_q: float) -> dict:
        d = haversine_km(lat_q, lon_q, city_coords())
        i = int(d.argmin())
        city, state, country, _, _ = CITIES[i]
        if d[i] <= TRUST_CITY_KM:
            return {"country": country, "state": state, "city": city}
        # border sanity check: a point near a national border can sit within
        # CITY_RADIUS_KM of a neighbor-country city. The coarse country boxes
        # overlap at borders, so only distrust the city when its country's
        # box doesn't even contain the point AND exactly one other country
        # claims it (unambiguous) — never when boxes merely overlap.
        boxes = self._box_countries(lat_q, lon_q)
        country_has_box = any(n == country for n, *_ in COUNTRY_BOXES)
        if boxes and country_has_box and country not in boxes:
            # the nearest city's country claims territory elsewhere but not
            # here; countries without any box stay trusted (no evidence)
            # one candidate: unambiguous. Several overlapping boxes (common
            # near European tri-borders): the point is genuinely inside at
            # least one of them, so fall back to the first (most-specific,
            # smallest-area-first ordering in COUNTRY_BOXES) containing box
            # rather than discarding a valid match.
            return {"country": boxes[0], "state": None, "city": None}
        if d[i] <= CITY_RADIUS_KM:
            return {"country": country, "state": state, "city": city}
        if d[i] <= STATE_RADIUS_KM:
            # near enough to trust the admin region, not the city itself
            return {"country": country, "state": state, "city": None}
        if boxes:
            return {"country": boxes[0], "state": None, "city": None}
        return {"country": None, "state": None, "city": None}

    def get_location_info(self, latitude: float, longitude: float) -> dict:
        # Quantize to ~1km so the cache is effective (reference caches exact coords).
        return self._lookup(round(latitude, 2), round(longitude, 2))
