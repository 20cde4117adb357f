"""Real-world scene modeling: materials, geodesy, triangulation, elevation.

Re-design of ``sar_scene_data.py``: the per-landcover material dictionary
(:9-69), scene model placements (:73-128), lat/lon local-meter projection
(:131-134), fan triangulation (:146-174), and the elevation-grid container
with bilinear lookup (:223-241).

Network access (Overpass/Open-Elevation, :185-339) is *gated*: this
environment is zero-egress, and production compute nodes often are too, so
``SceneFetcher`` accepts pre-fetched JSON/elevation payloads (the documented
formats) and only touches HTTP when explicitly asked with ``online=True``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

def _rgb(hex_color: str) -> Tuple[float, float, float]:
    h = hex_color.lstrip("#")
    return tuple(int(h[i:i + 2], 16) / 255.0 for i in (0, 2, 4))


def _m(hex_color: str, roughness: float, dielectric: float,
       height_m: float = 0.0) -> dict:
    return {"color": _rgb(hex_color), "roughness": roughness,
            "dielectric": dielectric, "height_m": height_m}


# Per-landcover/coating radar+visual material properties: color (viz),
# roughness and dielectric constant (backscatter modeling) — the full
# reference MATERIALS taxonomy (sar_scene_data.py:9-69, roughness/dielectric
# values preserved as data per class), extended with a per-class default
# extrusion height for the world/point-target bridges.
MATERIALS: Dict[str, dict] = {
    # natural
    "water": _m("#4A90D9", 0.05, 80.0),
    "ocean": _m("#1E5799", 0.02, 80.0),
    "coastline": _m("#4A90D9", 0.05, 80.0),
    "bay": _m("#4A90D9", 0.05, 80.0),
    "sand": _m("#F5DEB3", 0.7, 3.0),
    "beach": _m("#FFF8DC", 0.7, 3.0),
    "wood": _m("#228B22", 0.9, 5.0, height_m=12.0),
    "tree_row": _m("#228B22", 0.9, 5.0, height_m=8.0),
    "scrub": _m("#6B8E23", 0.85, 5.0, height_m=1.5),
    "grassland": _m("#90EE90", 0.8, 5.0, height_m=0.2),
    "wetland": _m("#6B8E6B", 0.6, 40.0),
    "bare_rock": _m("#A0A0A0", 0.9, 7.0, height_m=0.5),
    # landuse
    "residential": _m("#DCDCDC", 0.7, 4.0),
    "commercial": _m("#F5DEB3", 0.6, 4.0),
    "industrial": _m("#D8BFD8", 0.5, 4.0),
    "retail": _m("#FFD0D0", 0.6, 4.0),
    "grass": _m("#90EE90", 0.8, 5.0, height_m=0.2),
    "forest": _m("#006400", 0.9, 5.0, height_m=12.0),
    "farmland": _m("#EEE8AA", 0.75, 4.0, height_m=0.3),
    "farmyard": _m("#D2B48C", 0.7, 4.0),
    "orchard": _m("#9ACD32", 0.85, 5.0, height_m=4.0),
    "meadow": _m("#98FB98", 0.8, 5.0, height_m=0.2),
    "cemetery": _m("#AACBAF", 0.7, 4.0),
    "construction": _m("#C8B464", 0.6, 4.0),
    "railway": _m("#808080", 0.3, 1000.0),
    # leisure
    "park": _m("#C8FACC", 0.8, 5.0, height_m=0.2),
    "garden": _m("#BDECB6", 0.8, 5.0, height_m=0.3),
    "playground": _m("#CCFFFF", 0.6, 4.0),
    "pitch": _m("#89D689", 0.75, 5.0),
    "golf_course": _m("#B5E3B5", 0.8, 5.0),
    "swimming_pool": _m("#66B2FF", 0.1, 80.0),
    # infrastructure
    "parking": _m("#F7EFCE", 0.3, 6.0),
    "road": _m("#333333", 0.2, 6.0),
    "highway": _m("#333333", 0.2, 6.0),
    "footway": _m("#AAAAAA", 0.3, 5.0),
    "path": _m("#D2B48C", 0.5, 4.0),
    # buildings
    "building": _m("#D9D0C9", 0.7, 4.0, height_m=9.0),
    "house": _m("#D9D0C9", 0.7, 4.0, height_m=6.0),
    # default / terrain
    "default": _m("#C0C0C0", 0.5, 4.0),
    "ground": _m("#8FBC8F", 0.6, 4.0),
    "terrain": _m("#8B7355", 0.7, 4.0),
    "metal": _m("#FF4444", 0.0, 1000.0),
    "rock": _m("#A0A0A0", 0.85, 7.0, height_m=0.5),
    # vehicle / aircraft coatings
    "stealth_coating": _m("#2A2A2A", 0.9, 2.5),     # low reflectivity
    "aluminum": _m("#C0C0C0", 0.1, 1000.0),         # shiny, high reflectivity
    "car_paint": _m("#FF0000", 0.2, 10.0),
    "steel_armor": _m("#3A4030", 0.7, 1000.0),      # matte green metal
    "ship_metal": _m("#708090", 0.6, 1000.0),       # slate grey
}


def material_for(kind: str) -> dict:
    return MATERIALS.get(kind, MATERIALS["default"])


def material_rcs_factor(kind: str) -> float:
    """Relative RCS scaling of a material, from its radar constants:
    normal-incidence power reflectance rho = ((sqrt(eps)-1)/(sqrt(eps)+1))^2
    attenuated by surface roughness (diffuse scattering off the specular
    return): factor = rho * (1 - roughness/2). Conductor-class dielectrics
    (eps=1000: aluminum/ship_metal/steel_armor) land near 1; stealth_coating
    (eps=2.5, roughness 0.9) lands near 0.03 — consistent with the
    reference's F-35 rcs_scale=0.01 convention (vehicle_targets.py:99-100).
    """
    mat = material_for(kind)
    rt = math.sqrt(mat["dielectric"])
    rho = ((rt - 1.0) / (rt + 1.0)) ** 2
    return rho * (1.0 - 0.5 * mat["roughness"])


def latlon_to_meters(lat: float, lon: float, lat0: float, lon0: float
                     ) -> Tuple[float, float]:
    """Local tangent-plane projection (sar_scene_data.py:131-134):
    x = east meters, y = north meters about (lat0, lon0)."""
    r = 6371000.0
    x = math.radians(lon - lon0) * r * math.cos(math.radians(lat0))
    y = math.radians(lat - lat0) * r
    return x, y


def triangulate_polygon(vertices: Sequence[Sequence[float]]) -> np.ndarray:
    """Fan triangulation of a simple polygon (sar_scene_data.py:146-174):
    returns (n-2, 3, 2) triangles. Degenerate inputs return empty."""
    v = np.asarray(vertices, np.float64)
    if v.shape[0] < 3:
        return np.zeros((0, 3, 2))
    # drop duplicated closing vertex
    if np.allclose(v[0], v[-1]):
        v = v[:-1]
    if v.shape[0] < 3:
        return np.zeros((0, 3, 2))
    tris = [(v[0], v[i], v[i + 1]) for i in range(1, v.shape[0] - 1)]
    return np.asarray(tris)


def polygon_area(vertices: Sequence[Sequence[float]]) -> float:
    """Shoelace area (m^2) of a projected polygon."""
    v = np.asarray(vertices, np.float64)
    if v.shape[0] < 3:
        return 0.0
    x, y = v[:, 0], v[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


@dataclass
class ElevationGrid:
    """Regular elevation grid with bilinear lookup
    (sar_scene_data.py:185-241)."""

    xs: np.ndarray        # (Nx,) east coordinates [m]
    ys: np.ndarray        # (Ny,) north coordinates [m]
    z: np.ndarray         # (Ny, Nx) elevations [m]

    def elevation_at(self, x, y):
        """Bilinear interpolation, clamped to the grid edges."""
        xs, ys, z = self.xs, self.ys, self.z
        fx = np.clip((np.asarray(x) - xs[0]) / (xs[1] - xs[0]), 0, len(xs) - 1)
        fy = np.clip((np.asarray(y) - ys[0]) / (ys[1] - ys[0]), 0, len(ys) - 1)
        ix = np.clip(np.floor(fx).astype(int), 0, len(xs) - 2)
        iy = np.clip(np.floor(fy).astype(int), 0, len(ys) - 2)
        wx, wy = fx - ix, fy - iy
        return ((1 - wy) * ((1 - wx) * z[iy, ix] + wx * z[iy, ix + 1])
                + wy * ((1 - wx) * z[iy + 1, ix] + wx * z[iy + 1, ix + 1]))

    @staticmethod
    def flat(half_width_m: float = 1000.0, n: int = 2) -> "ElevationGrid":
        xs = np.linspace(-half_width_m, half_width_m, n)
        return ElevationGrid(xs, xs.copy(), np.zeros((n, n)))


#: tag keys whose *value* is tried directly against the MATERIALS taxonomy,
#: in the reference's precedence order (sar_scene_data.py:297-305):
#: landuse, then natural, then leisure, then amenity.
_TAG_PRECEDENCE = ("landuse", "natural", "leisure", "amenity")


def classify_tags(tags: dict) -> str:
    """OSM tags -> MATERIALS key, covering the whole taxonomy.

    Reference behavior (sar_scene_data.py:295-311): building and highway
    dominate; otherwise the landuse/natural/leisure/amenity tag *value*
    itself is the material key when the taxonomy knows it (this is how
    railway/wetland/sand/park/pitch/parking/residential/... scenes reach
    their dedicated radar constants); anything unknown falls to 'default'.
    Two refinements over the reference: building=house keeps its lower
    default extrusion, and footway/path keep their dedicated materials
    instead of collapsing to 'road'.
    """
    if "building" in tags:
        return "house" if tags.get("building") == "house" else "building"
    if "highway" in tags:
        hv = tags.get("highway")
        return hv if hv in ("footway", "path") else "road"
    for key in _TAG_PRECEDENCE:
        val = tags.get(key)
        if val is not None:
            if val in MATERIALS:
                return val
            # common synonyms the taxonomy folds together
            if key == "natural" and val in ("water", "wetland", "sand",
                                            "beach", "bay", "coastline"):
                return val
            if key == "leisure" and val == "swimming_pool":
                return "swimming_pool"
            return "default"
    if "water" in tags or "waterway" in tags:
        return "water"
    return "default"


@dataclass
class SceneFeature:
    kind: str                         # material key
    polygon_m: np.ndarray             # (N, 2) projected outline
    height_m: float
    tags: dict = field(default_factory=dict)

    @property
    def material(self) -> dict:
        return material_for(self.kind)

    @property
    def triangles(self) -> np.ndarray:
        return triangulate_polygon(self.polygon_m)


class SceneFetcher:
    """Builds SceneFeatures + ElevationGrid around (lat0, lon0).

    Offline-first: pass ``osm_json`` (Overpass response format, the schema
    the reference queries at sar_scene_data.py:243-339) and/or an elevation
    array. ``online=True`` attempts live HTTP (requests) and raises a clear
    error when the environment has no egress.
    """

    #: the six Overpass clauses the reference queries
    #: (sar_scene_data.py:247-254)
    OVERPASS_CLAUSES = (
        '["landuse"]',
        '["natural"]',
        '["leisure"]',
        '["amenity"="parking"]',
        '["building"]',
        '["highway"]',
    )

    def __init__(self, lat0: float, lon0: float, radius_m: float = 500.0,
                 online: bool = False,
                 terrain_extent_m: Optional[float] = None):
        self.lat0, self.lon0, self.radius_m = lat0, lon0, radius_m
        self.online = online
        # when set, features whose centroid lies outside +-extent are
        # dropped (the reference's clipping, sar_scene_data.py:289-292)
        self.terrain_extent_m = terrain_extent_m

    def _project(self, lat, lon):
        return latlon_to_meters(lat, lon, self.lat0, self.lon0)

    def features_from_osm(self, osm_json: dict) -> List[SceneFeature]:
        """Parse an Overpass response into projected, classified features.

        Accepts both response shapes: 'out geom' (each way carries inline
        ``geometry``) and the reference's 'out body' + node recursion
        (sar_scene_data.py:255-276 — node elements indexed by id, ways
        carrying ``nodes`` id lists). Classification runs the full
        MATERIALS taxonomy via :func:`classify_tags`; line features
        (2-node highway segments) are kept, other degenerate ways are
        dropped; centroid clipping applies when ``terrain_extent_m``
        is set.
        """
        elements = osm_json.get("elements", [])
        nodes = {el["id"]: (el["lat"], el["lon"]) for el in elements
                 if el.get("type") == "node"
                 and "lat" in el and "lon" in el}
        feats: List[SceneFeature] = []
        for el in elements:
            if el.get("type") == "node":
                continue
            tags = el.get("tags", {})
            geom = el.get("geometry")
            if geom:
                latlons = [(p["lat"], p["lon"]) for p in geom]
            else:
                latlons = [nodes[nid] for nid in el.get("nodes", ())
                           if nid in nodes]
            if len(latlons) < 3 and not ("highway" in tags
                                         and len(latlons) >= 2):
                continue
            poly = np.asarray([self._project(la, lo) for la, lo in latlons])
            if self.terrain_extent_m is not None:
                cx, cy = poly[:, 0].mean(), poly[:, 1].mean()
                if abs(cx) > self.terrain_extent_m or \
                        abs(cy) > self.terrain_extent_m:
                    continue
            kind = classify_tags(tags)
            h = material_for(kind)["height_m"]
            try:
                h = float(tags.get("height", h))
            except (TypeError, ValueError):
                pass
            feats.append(SceneFeature(kind=kind, polygon_m=poly, height_m=h,
                                      tags=tags))
        return feats

    def elevation_from_grid(self, elevations: np.ndarray,
                            half_width_m: Optional[float] = None,
                            smooth_sigma: float = 0.0) -> ElevationGrid:
        """Grid -> ElevationGrid, optionally Gaussian-smoothed.

        The reference smooths every fetched elevation grid with
        ``gaussian_filter(sigma=1.0)`` to remove API quantization jags
        (sar_scene_data.py:211-212); pass ``smooth_sigma=1.0`` for parity
        (the fetch path does so by default)."""
        elevations = np.asarray(elevations, np.float64)
        if smooth_sigma > 0.0:
            from scipy.ndimage import gaussian_filter
            elevations = gaussian_filter(elevations, sigma=smooth_sigma)
        hw = half_width_m or self.radius_m
        ny, nx = elevations.shape
        return ElevationGrid(np.linspace(-hw, hw, nx),
                             np.linspace(-hw, hw, ny), elevations)

    def parse_elevation_response(self, payload: dict, n: int,
                                 smooth_sigma: float = 1.0) -> ElevationGrid:
        """Open-Elevation response -> smoothed grid. Payload schema:
        {'results': [{'latitude','longitude','elevation'}, ...]} in the
        row-major (y over x) order the query built
        (sar_scene_data.py:192-211)."""
        z = np.asarray([p["elevation"] for p in payload["results"]],
                       np.float64)
        return self.elevation_from_grid(z.reshape(n, n),
                                        smooth_sigma=smooth_sigma)

    # ---- online paths (gated; zero-egress safe) ----
    def fetch_osm(self) -> List[SceneFeature]:
        if not self.online:
            raise RuntimeError(
                "SceneFetcher is offline; pass osm_json to features_from_osm "
                "or construct with online=True in a networked environment")
        import requests
        around = f'(around:{self.radius_m},{self.lat0},{self.lon0})'
        clauses = "".join(f"way{around}{sel};"
                          for sel in self.OVERPASS_CLAUSES)
        q = f'[out:json][timeout:30];({clauses});out geom;'
        r = requests.post("https://overpass-api.de/api/interpreter",
                          data={"data": q}, timeout=30)
        r.raise_for_status()
        return self.features_from_osm(r.json())

    def fetch_elevation(self, n: int = 16) -> ElevationGrid:
        """Open-Elevation POST (the reference's request format,
        sar_scene_data.py:199-205) + sigma-1 Gaussian smoothing."""
        if not self.online:
            return ElevationGrid.flat(self.radius_m)
        import requests
        lats = np.linspace(-1, 1, n) * self.radius_m / 111320.0 + self.lat0
        lons = (np.linspace(-1, 1, n) * self.radius_m
                / (111320.0 * math.cos(math.radians(self.lat0))) + self.lon0)
        locations = [{"latitude": float(la), "longitude": float(lo)}
                     for la in lats for lo in lons]
        r = requests.post("https://api.open-elevation.com/api/v1/lookup",
                          json={"locations": locations},
                          headers={"Content-Type": "application/json"},
                          timeout=30)
        r.raise_for_status()
        return self.parse_elevation_response(r.json(), n)


def delaunay_triangulate(points_2d: np.ndarray) -> np.ndarray:
    """Delaunay triangulation of scattered 2-D points -> (M, 3) vertex
    indices (scipy). The reference imports scipy.spatial.Delaunay for its
    scene pipeline (sar_scene_data.py:5) — the actual capability lives here:
    terrain meshes from non-grid elevation samples (viz/world.py consumes
    it; grid terrains keep the cheaper regular-grid strips)."""
    from scipy.spatial import Delaunay

    pts = np.asarray(points_2d, np.float64)
    if pts.shape[0] < 3:
        return np.zeros((0, 3), np.int64)
    return Delaunay(pts).simplices.astype(np.int64)


def features_to_point_targets(features: Sequence[SceneFeature],
                              elevation: Optional[ElevationGrid] = None,
                              density_per_m2: float = 0.001,
                              rng: Optional[np.random.Generator] = None):
    """Rasterize scene features into point scatterers for the echo engine:
    scatterer density per area, RCS from dielectric/roughness, z from the
    feature height + terrain. This is the bridge from real-world scenes to
    the point-target simulator (new capability; the reference only renders
    these scenes visually)."""
    from nis_sar_amtigmti_video_tpu.scene.targets import PointTargets

    rng = rng or np.random.default_rng(0)
    pos, rcs, names = [], [], []
    for fi, f in enumerate(features):
        tris = f.triangles
        if tris.shape[0] == 0:
            continue
        e1 = tris[:, 1] - tris[:, 0]
        e2 = tris[:, 2] - tris[:, 0]
        areas = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        total = float(areas.sum())
        n_pts = max(1, int(total * density_per_m2))
        t_idx = rng.choice(tris.shape[0], n_pts, p=areas / max(total, 1e-12))
        u = rng.random(n_pts)
        v = rng.random(n_pts)
        flip = u + v > 1
        u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
        pts = (tris[t_idx, 0]
               + u[:, None] * (tris[t_idx, 1] - tris[t_idx, 0])
               + v[:, None] * (tris[t_idx, 2] - tris[t_idx, 0]))
        mat = f.material
        z0 = (elevation.elevation_at(pts[:, 0], pts[:, 1])
              if elevation is not None else np.zeros(n_pts))
        z = z0 + f.height_m * rng.random(n_pts)
        # simple backscatter: sigma ~ area/n * Fresnel power reflectance
        # rho = ((sqrt(eps)-1)/(sqrt(eps)+1))^2 (the same reflectivity form
        # material_rcs_factor uses) scaled by diffuse roughness return
        rt = math.sqrt(mat["dielectric"])
        refl = ((rt - 1.0) / (rt + 1.0)) ** 2
        sig = (total / n_pts) * refl * (0.2 + 0.8 * mat["roughness"])
        pos.append(np.column_stack([pts, z]))
        rcs.append(np.full(n_pts, sig))
        names.extend([f"{f.kind}_{fi}_{j}" for j in range(n_pts)])
    if not pos:
        return PointTargets(np.zeros((0, 3)), np.zeros(0), ())
    return PointTargets(np.concatenate(pos), np.concatenate(rcs), tuple(names))


# --------------------------------------------------------------------------
# scene-model placements (sar_scene_data.py:73-128)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ScenePlacement:
    """One vehicle/aircraft model placed into a fetched real-world scene —
    the typed equivalent of a reference SCENE_MODELS entry
    (sar_scene_data.py:73-128, consumed by sar_simulator_ursina.py:247-266).

    ``position_m`` is ground (x, y) meters about the scene origin (the
    reference's Ursina (x, z) ground plane), ``height_offset_m`` lifts the
    model above the terrain, ``heading_deg`` is the ground-plane heading
    (the reference rotation triple's yaw component; the full triple is kept
    for mesh-viewer parity), ``material`` keys MATERIALS and drives the
    radar RCS scaling of the bridged point-target model, and ``scale`` is
    the mesh display scale (the point-target models are already metric, so
    the bridge ignores it).
    """
    name: str
    model: str                     # scene.targets generator key
    position_m: Tuple[float, float]
    height_offset_m: float
    scale: float
    material: str
    heading_deg: float
    rotation_deg: Tuple[float, float, float] = (0.0, 0.0, 0.0)


# The reference's six placements, reproduced as data (name / position /
# height offset / scale / material / rotation: sar_scene_data.py:73-128).
# Each FBX file maps to the nearest scene.targets point-scatterer model.
SCENE_PLACEMENTS: Tuple[ScenePlacement, ...] = (
    ScenePlacement("F-35B Lightning II", "f35", (0.0, 200.0), 45.0, 0.02,
                   "stealth_coating", 45.0, (0.0, 45.0, 0.0)),
    ScenePlacement("Boeing 787-8", "airliner", (60.0, 240.0), 45.0, 0.02,
                   "aluminum", 45.0, (0.0, 45.0, 0.0)),
    ScenePlacement("Civilian Car", "car", (40.0, 210.0), 0.8, 0.02,
                   "steel_armor", -35.0, (-90.0, -35.0, 0.0)),
    ScenePlacement("Main Battle Tank", "tank", (55.0, 225.0), 0.8, 0.02,
                   "steel_armor", -35.0, (-90.0, -35.0, 0.0)),
    ScenePlacement("Small Boat", "boat", (20.0, 400.0), 0.0, 0.02,
                   "ship_metal", -35.0, (-90.0, -35.0, 0.0)),
    ScenePlacement("Navy Frigate", "frigate", (-70.0, 600.0), 0.0, 0.02,
                   "ship_metal", 145.0, (-90.0, 145.0, 0.0)),
)


def _placement_model(model: str):
    """Point-scatterer model for a placement key (scene.targets bridge)."""
    from nis_sar_amtigmti_video_tpu.scene import targets as T

    if model == "f35":
        return T.f35()
    if model == "airliner":
        return T.airliner()
    if model == "car":
        return T.car()
    if model == "tank":
        return T.tank()
    if model == "boat":
        # small craft: car-class scatterer count at boat-class RCS
        return T.car().scale_rcs(5.0)
    if model == "frigate":
        return T.destroyer()
    raise ValueError(f"unknown placement model {model!r}")


def placement_targets(placements: Sequence[ScenePlacement] = SCENE_PLACEMENTS,
                      elevation: Optional[ElevationGrid] = None):
    """Drop the placed models into the scene as point targets: each model's
    scatterer cloud is heading-rotated, translated to its placement position
    at terrain + height offset, and RCS-scaled by its coating material
    (:func:`material_rcs_factor`) — the simulation bridge the reference's
    Ursina world only renders visually."""
    from nis_sar_amtigmti_video_tpu.scene.targets import PointTargets

    parts = []
    for pl in placements:
        x, y = pl.position_m
        z = pl.height_offset_m
        if elevation is not None:
            z = z + float(elevation.elevation_at(x, y))
        m = (_placement_model(pl.model)
             .rotate_z(pl.heading_deg)
             .scale_rcs(material_rcs_factor(pl.material))
             .translate((x, y, z)))
        parts.append(m)
    return PointTargets.concatenate(parts)
