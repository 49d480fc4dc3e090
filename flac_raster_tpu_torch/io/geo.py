"""Geospatial primitives: affine transform, pixel window, bounding box, CRS.

Drop-in semantic equivalents of the rasterio types the reference leans on
(``rasterio.transform.Affine``, ``rasterio.windows.Window``, ``src.bounds``
-- reference ``converter.py:73-85``, ``spatial_encoder.py:123-131``), but
self-contained: this framework owns its raster I/O stack (GDAL is not part
of the deployment image).

Carried over unchanged from ``flac_raster_tpu.io.geo``: that package's
``__init__`` imports JAX, so the port keeps its own copy of this
pure-Python layer.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Affine", "Window", "BoundingBox", "crs_to_epsg", "epsg_to_crs_string"]


@dataclass(frozen=True)
class Affine:
    """2-D affine transform, rasterio parameter order:

        x = a * col + b * row + c
        y = d * col + e * row + f
    """

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    @classmethod
    def identity(cls) -> "Affine":
        return cls(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    @classmethod
    def from_origin(cls, west: float, north: float, xsize: float, ysize: float) -> "Affine":
        """North-up transform from the top-left corner and pixel sizes."""
        return cls(xsize, 0.0, west, 0.0, -ysize, north)

    def __mul__(self, colrow) -> tuple[float, float]:
        col, row = colrow
        return (
            self.a * col + self.b * row + self.c,
            self.d * col + self.e * row + self.f,
        )

    def __iter__(self):
        yield from (self.a, self.b, self.c, self.d, self.e, self.f)

    def translated(self, col_off: float, row_off: float) -> "Affine":
        """Transform for a window whose origin is (col_off, row_off)."""
        x0, y0 = self * (col_off, row_off)
        return Affine(self.a, self.b, x0, self.d, self.e, y0)

    @property
    def is_rectilinear(self) -> bool:
        return self.b == 0.0 and self.d == 0.0

    def to_gdal(self) -> tuple[float, float, float, float, float, float]:
        return (self.c, self.a, self.b, self.f, self.d, self.e)


@dataclass(frozen=True)
class Window:
    """Pixel window (col_off, row_off, width, height) -- rasterio field order."""

    col_off: int
    row_off: int
    width: int
    height: int

    def to_dict(self) -> dict:
        return {
            "col_off": self.col_off,
            "row_off": self.row_off,
            "width": self.width,
            "height": self.height,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Window":
        return cls(d["col_off"], d["row_off"], d["width"], d["height"])


@dataclass(frozen=True)
class BoundingBox:
    left: float
    bottom: float
    right: float
    top: float

    def __iter__(self):
        yield from (self.left, self.bottom, self.right, self.top)


def bounds_of(transform: Affine, width: int, height: int) -> BoundingBox:
    """Geographic bounds of a raster under an affine transform."""
    corners = [
        transform * (0, 0),
        transform * (width, 0),
        transform * (0, height),
        transform * (width, height),
    ]
    xs = [c[0] for c in corners]
    ys = [c[1] for c in corners]
    return BoundingBox(min(xs), min(ys), max(xs), max(ys))


def crs_to_epsg(crs: str | None) -> int | None:
    """'EPSG:4326' -> 4326; returns None for non-EPSG strings."""
    if not crs:
        return None
    s = str(crs).strip().upper()
    if s.startswith("EPSG:"):
        try:
            return int(s.split(":", 1)[1])
        except ValueError:
            return None
    return None


def epsg_to_crs_string(code: int) -> str:
    return f"EPSG:{code}"
