"""Command-line interface of the port: convert / info / extract / query /
compare.

The port of ``flac_raster_tpu/cli.py``: the same commands, flags, output
lines and exit codes (suffix-dispatched convert, auto output naming, the
``--force`` guard, remote URL download, streaming extract by
tile-id/bbox/center/last, row windows of a plain file by ``--rows``), with
argparse.  Exit code 1 on failure with the error logged.

Every command takes ``--device {cuda,cpu}`` (default ``cuda``), the port's
counterpart of ``JAX_PLATFORMS``: the device is passed down to every
converter, encoder and streamer the command builds.  Without CUDA, a
command on ``cuda`` exits 1 with ``resolve_device``'s message; the CPU runs
only when asked for.  ``convert --trace DIR`` writes a torch.profiler trace
(``utils.profiling.device_trace``).

    python -m flac_raster_tpu_torch convert in.tif -o out.flac --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

logger = logging.getLogger("flac_raster_tpu_torch.cli")


def _setup_logging(verbose: bool = False) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="[%(asctime)s] %(levelname)s %(name)s: %(message)s",
        datefmt="%X",
    )
    logging.getLogger("flac_raster_tpu_torch").setLevel(
        logging.DEBUG if verbose else logging.INFO
    )


def _resolve_input(input_path: str, temp_files: list) -> Path:
    """Download remote inputs to a temp file (reference ``cli.py:41-48``)."""
    from .io.remote import download_remote, is_remote_url

    if is_remote_url(input_path):
        print(f"Downloading remote file: {input_path}")
        local = download_remote(input_path)
        temp_files.append(local)
        return local
    return Path(input_path)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def cmd_convert(args) -> int:
    _setup_logging(args.verbose)
    temp_files: list[Path] = []
    from .utils.profiling import device_trace

    try:
        input_path = _resolve_input(args.input_file, temp_files)
        if not input_path.exists():
            print(f"Error: Input file does not exist: {input_path}", file=sys.stderr)
            return 1
        suffix = input_path.suffix.lower()
        if suffix in (".tif", ".tiff"):
            direction, default_suffix = "tiff_to_flac", ".flac"
        elif suffix == ".flac":
            direction, default_suffix = "flac_to_tiff", ".tif"
        else:
            print(f"Error: Unsupported format: {suffix}", file=sys.stderr)
            print("Supported: .tif, .tiff, .flac", file=sys.stderr)
            return 1

        output = Path(args.output) if args.output else (
            input_path.with_name(f"{input_path.stem}_streaming{default_suffix}")
            if args.streaming
            else input_path.with_suffix(default_suffix)
        )
        if output.exists() and not args.force:
            print(f"Error: Output exists: {output}", file=sys.stderr)
            print("Use --force to overwrite", file=sys.stderr)
            return 1

        from .converter import RasterFLACConverter

        lossless = not args.minmax
        with device_trace(getattr(args, "trace", None), args.device):
            if args.streaming and direction == "tiff_to_flac":
                from .models.streaming import create_streaming_flac

                sindex = create_streaming_flac(
                    input_path, output, args.tile_size, args.compression, lossless,
                    device=args.device,
                )
                print(f"Created streaming FLAC: {output}")
                print(f"  Tiles: {len(sindex.frames)}")
                print(f"  Size: {output.stat().st_size / 1e6:.2f} MB")
                return 0

            conv = RasterFLACConverter(lossless=lossless, device=args.device)
            if direction == "tiff_to_flac":
                result = conv.tiff_to_flac(
                    input_path, output, args.compression, args.spatial, args.tile_size
                )
                if args.spatial and result:
                    print(f"Created {len(result.frames)} spatial tiles")
                print(f"SUCCESS: Converted to FLAC: {output}")
            else:
                conv.flac_to_tiff(input_path, output)
                print(f"SUCCESS: Converted to TIFF: {output}")
        return 0
    except Exception as e:  # noqa: BLE001
        logger.exception("Conversion failed")
        print(f"Error: {e}", file=sys.stderr)
        return 1
    finally:
        for tmp in temp_files:
            if tmp.exists():
                tmp.unlink()


# ---------------------------------------------------------------------------
# info
# ---------------------------------------------------------------------------

def cmd_info(args) -> int:
    _setup_logging(False)
    temp_files: list[Path] = []
    try:
        local = _resolve_input(args.file_path, temp_files)
        if not local.exists():
            print(f"Error: File not found: {local}", file=sys.stderr)
            return 1
        suffix = local.suffix.lower()
        if suffix in (".tif", ".tiff"):
            _show_tiff_info(local)
        elif suffix == ".flac":
            _show_flac_info(local)
        else:
            print(f"Unsupported format: {suffix}", file=sys.stderr)
            return 1
        return 0
    except Exception as e:  # noqa: BLE001
        logger.exception("Info failed")
        print(f"Error: {e}", file=sys.stderr)
        return 1
    finally:
        for tmp in temp_files:
            if tmp.exists():
                tmp.unlink()


def _show_tiff_info(path: Path) -> None:
    from .io.geotiff import open_geotiff

    with open_geotiff(path) as src:
        print(f"TIFF: {path.name}")
        print(f"  Dimensions: {src.width} x {src.height}")
        print(f"  Bands: {src.count}")
        print(f"  Data Type: {src.dtype}")
        print(f"  CRS: {src.crs}")
        b = src.bounds
        print(f"  Bounds: ({b.left:.6f}, {b.bottom:.6f}, {b.right:.6f}, {b.top:.6f})")
        print(f"  NoData: {src.nodata}")
        print(f"  File Size: {path.stat().st_size / 1e6:.2f} MB")


def _show_flac_info(path: Path) -> None:
    blob = path.read_bytes()
    # streaming container?
    if blob[:4] != b"fLaC":
        from .models.streaming import load_streaming_index

        try:
            sindex = load_streaming_index(path)
        except Exception:
            print(f"Not a FLAC or streaming container: {path}", file=sys.stderr)
            raise
        m = sindex.meta
        print(f"Streaming FLAC container: {path.name}")
        print(f"  Dimensions: {m['width']} x {m['height']}")
        print(f"  Bands: {m['bands']}   Data Type: {m['dtype']}")
        print(f"  CRS: {m['crs']}")
        print(f"  Tiles: {len(m['frames'])} @ {m['tile_size']}px")
        print(f"  File Size: {path.stat().st_size / 1e6:.2f} MB")
        return

    from .models.flac_format import BLOCK_VORBIS_COMMENT, parse_flac_metadata, parse_vorbis_comments
    from .models.metadata import parse_geospatial_comments

    si, blocks, _ = parse_flac_metadata(blob)
    print(f"FLAC: {path.name}")
    print(f"  Sample Rate: {si.sample_rate} Hz")
    print(f"  Channels: {si.channels}")
    print(f"  Bits/Sample: {si.bits_per_sample}")
    print(f"  Total Samples: {si.total_samples}")
    print(f"  File Size: {path.stat().st_size / 1e6:.2f} MB")
    if si.md5 == b"\x00" * 16:
        # the spec reserves all-zero for "MD5 unset"; the device-resident
        # encode (converter.encode_array_device) writes it
        print("  MD5: unset (device-egress file; frame CRCs still verify)")
    else:
        print(f"  MD5: {si.md5.hex()}")
    from .models.flac_format import parse_layout_block

    layout = parse_layout_block(blocks)
    if layout is not None:
        print(
            f"  Decode Index: {len(layout.sizes)} frames "
            f"(FRTP v{layout.version}; parallel/device decode + random "
            f"access enabled)"
        )
    comments: dict = {}
    for b in blocks:
        if b.block_type == BLOCK_VORBIS_COMMENT:
            _, comments = parse_vorbis_comments(b.data)
    md = parse_geospatial_comments(comments)
    if md:
        print("Geospatial Metadata:")
        print(f"  Dimensions: {md.get('width')} x {md.get('height')}")
        print(f"  Bands: {md.get('count')}")
        print(f"  Original Type: {md.get('dtype')}")
        print(f"  CRS: {md.get('crs')}")
        print(f"  Data Range: [{md.get('data_min')}, {md.get('data_max')}]")
        print(f"  Spatial Tiling: {md.get('spatial_tiling')}")
        if md.get("normalization"):
            print(f"  Normalization: {md['normalization'].mode}")


# ---------------------------------------------------------------------------
# extract
# ---------------------------------------------------------------------------


def _extract_rows(args) -> int:
    """Row-window extraction from a plain whole-raster FLAC file.

    Uses the FRTP decode index (codec/decoder.decode_flac_range) so only
    the frames covering the window are parsed, each CRC-16 checked.
    """
    from .converter import RasterFLACConverter
    from .io.geo import Affine
    from .io.geotiff import write_geotiff
    from .io.remote import RemoteFile, is_remote_url

    try:
        row0_s, count_s = args.rows.split(":", 1)
        row0, n_rows = int(row0_s), int(count_s)
    except ValueError:
        print("--rows expects START:COUNT (e.g. 1024:512)", file=sys.stderr)
        return 1
    src = args.flac_file
    conv = RasterFLACConverter(device=args.device)
    if is_remote_url(src):
        # ranged access: header prefix + only the covering frame span
        remote = RemoteFile(src)
        data, meta, fetched = conv.decode_rows_ranged(remote, row0, n_rows)
        total = remote.file_size
        if total:
            print(f"Fetched {fetched:,} of {total:,} bytes "
                  f"({100 * fetched / total:.1f}%)")
    else:
        data, meta = conv.decode_rows(Path(src).read_bytes(), row0, n_rows)
    transform = meta.get("transform")
    if transform is not None:
        t = Affine(*transform) if not isinstance(transform, Affine) else transform
        # shift the origin down by row0 pixels
        transform = Affine(t.a, t.b, t.c + t.b * row0, t.d, t.e, t.f + t.e * row0)
    write_geotiff(
        Path(args.output), data, crs=meta.get("crs"), transform=transform,
        nodata=meta.get("nodata"),
    )
    print(f"Extracted rows {row0}..{row0 + n_rows} -> {args.output} "
          f"({data.shape[0]} band(s), {n_rows}x{data.shape[2]})")
    return 0


def cmd_extract(args) -> int:
    _setup_logging(False)
    try:
        from .io.remote import RemoteFile, is_remote_url

        if args.rows:
            return _extract_rows(args)
        from .models.streaming import load_streaming_index, read_streaming_tile

        source = args.flac_file if is_remote_url(args.flac_file) else Path(args.flac_file)
        print(f"Loading streaming metadata from: {args.flac_file}")
        remote = RemoteFile(args.flac_file) if is_remote_url(args.flac_file) else None
        sindex = load_streaming_index(remote if remote else source)
        frames = sindex.frames
        print(f"Found {len(frames)} tiles")

        target = None
        if args.tile_id is not None:
            target = next((f for f in frames if f["frame_id"] == args.tile_id), None)
            if not target:
                print(f"Tile ID {args.tile_id} not found", file=sys.stderr)
                return 1
        elif args.last:
            target = max(frames, key=lambda f: f["frame_id"])
        elif args.center:
            bbs = [f["bbox"] for f in frames]
            cx = (min(b[0] for b in bbs) + max(b[2] for b in bbs)) / 2
            cy = (min(b[1] for b in bbs) + max(b[3] for b in bbs)) / 2
            target = min(
                frames,
                key=lambda f: ((f["bbox"][0] + f["bbox"][2]) / 2 - cx) ** 2
                + ((f["bbox"][1] + f["bbox"][3]) / 2 - cy) ** 2,
            )
        elif args.bbox:
            coords = [float(x.strip()) for x in args.bbox.split(",")]
            if len(coords) != 4:
                print("Bbox must have 4 coordinates", file=sys.stderr)
                return 1
            hits = [
                f for f in frames
                if coords[0] < f["bbox"][2] and coords[2] > f["bbox"][0]
                and coords[1] < f["bbox"][3] and coords[3] > f["bbox"][1]
            ]
            if not hits:
                print("No tiles intersect bbox", file=sys.stderr)
                return 1
            target = hits[0]
            if len(hits) > 1:
                print(f"Using first of {len(hits)} intersecting tiles")
        else:
            print("Specify --tile-id, --bbox, --center, or --last", file=sys.stderr)
            return 1

        print(f"Extracting tile {target['frame_id']}")
        print(f"  Bbox: {target['bbox']}")
        print(f"  Size: {target['byte_size']:,} bytes")
        tile_blob = read_streaming_tile(remote if remote else source, sindex, target)

        from .converter import RasterFLACConverter

        data, meta = RasterFLACConverter(device=args.device).decode_bytes(tile_blob)
        from .io.geo import Affine
        from .io.geotiff import write_geotiff

        t = meta.get("transform") or []
        write_geotiff(
            args.output, data,
            crs=meta.get("crs") or None,
            transform=Affine(*t[:6]) if len(t) >= 6 else None,
            nodata=meta.get("nodata"),
        )
        total = sum(f["byte_size"] for f in frames)
        savings = (1 - target["byte_size"] / total) * 100 if total else 0.0
        print(f"Saved to: {args.output}")
        print(f"Bandwidth: {target['byte_size'] / 1024:.1f} KB (saved {savings:.1f}%)")
        return 0
    except Exception as e:  # noqa: BLE001
        logger.exception("Extraction failed")
        print(f"Error: {e}", file=sys.stderr)
        return 1


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------

def cmd_query(args) -> int:
    _setup_logging(False)
    try:
        from .io.remote import is_remote_url
        from .models.spatial import SpatialFLACStreamer

        coords = tuple(float(x.strip()) for x in args.bbox.split(","))
        if len(coords) != 4:
            print("Bbox must have 4 coordinates", file=sys.stderr)
            return 1
        print("Loading spatial index...")
        streamer = SpatialFLACStreamer(
            args.flac_file if is_remote_url(args.flac_file) else Path(args.flac_file),
            device=args.device,
        )
        ranges = streamer.get_byte_ranges_for_bbox(coords)
        total = sum(e - s + 1 for s, e in ranges)
        print(f"Byte Ranges for bbox {args.bbox}")
        print(f"{'#':>3} {'Start':>12} {'End':>12} {'Size':>12}  Range Header")
        for i, (s, e) in enumerate(ranges, 1):
            print(f"{i:>3} {s:>12,} {e:>12,} {e - s + 1:>12,}  bytes={s}-{e}")
        print(f"Total: {total:,} bytes ({len(ranges)} ranges)")
        if args.output:
            Path(args.output).write_text(json.dumps({
                "bbox": list(coords),
                "ranges": [{"start": s, "end": e} for s, e in ranges],
                "total_bytes": total,
            }, indent=2))
            print(f"Saved to: {args.output}")
        return 0
    except Exception as e:  # noqa: BLE001
        logger.exception("Query failed")
        print(f"Error: {e}", file=sys.stderr)
        return 1


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------

def cmd_compare(args) -> int:
    _setup_logging(False)
    for f in (args.file1, args.file2):
        p = Path(f)
        if not p.exists():
            print(f"File not found: {p}", file=sys.stderr)
            return 1
        if p.suffix.lower() not in (".tif", ".tiff"):
            print(f"Not a TIFF file: {p}", file=sys.stderr)
            return 1
    try:
        from .compare import compare_tiffs, display_comparison_table

        results = compare_tiffs(Path(args.file1), Path(args.file2), args.show_bands)
        display_comparison_table(results)
        if args.export:
            Path(args.export).write_text(json.dumps(results, indent=2, default=str))
            print(f"Exported to: {args.export}")
        return 0
    except Exception as e:  # noqa: BLE001
        logger.exception("Comparison failed")
        print(f"Error: {e}", file=sys.stderr)
        return 1


# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flac-raster-torch",
        description="Convert GeoTIFF raster data to/from FLAC format with "
                    "spatial streaming support (PyTorch + CUDA port).",
    )
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("convert", help="Convert between TIFF and FLAC formats")
    c.add_argument("input_file", help="Input file (TIFF or FLAC); local path or URL")
    c.add_argument("-o", "--output", help="Output file path")
    c.add_argument("-c", "--compression", type=int, default=5, choices=range(0, 9),
                   metavar="0-8", help="FLAC compression level (default 5)")
    c.add_argument("-s", "--spatial", action="store_true",
                   help="Enable spatial tiling for streaming")
    c.add_argument("-t", "--tile-size", type=int, default=512,
                   help="Tile size in pixels (default 512)")
    c.add_argument("--streaming", action="store_true",
                   help="Create Netflix-style streaming format")
    c.add_argument("-f", "--force", action="store_true", help="Overwrite existing output")
    c.add_argument("-v", "--verbose", action="store_true", help="Verbose logging")
    c.add_argument("--trace", metavar="DIR",
                   help="Write a torch.profiler trace (Chrome trace JSON; the card's "
                        "kernels on cuda) to DIR")
    c.add_argument("--minmax", action="store_true",
                   help="Use reference-compatible min-max normalization "
                        "instead of exact lossless mapping")
    c.set_defaults(func=cmd_convert)

    i = sub.add_parser("info", help="Display information about a FLAC or TIFF file")
    i.add_argument("file_path", help="File to inspect (local or remote URL)")
    i.set_defaults(func=cmd_info)

    e = sub.add_parser("extract", help="Extract tiles from a streaming FLAC file")
    e.add_argument("flac_file", help="Streaming FLAC file (local or remote URL)")
    e.add_argument("-o", "--output", required=True, help="Output TIFF file path")
    e.add_argument("-b", "--bbox", help="Bounding box: 'xmin,ymin,xmax,ymax'")
    e.add_argument("--tile-id", type=int, help="Extract specific tile by ID")
    e.add_argument("--center", action="store_true", help="Extract center tile")
    e.add_argument("--last", action="store_true", help="Extract last tile")
    e.add_argument("--rows", metavar="START:COUNT",
                   help="Plain (non-streaming) FLAC only: extract a raster "
                        "row window via the embedded decode index")
    e.set_defaults(func=cmd_extract)

    q = sub.add_parser("query", help="Query spatial FLAC file by bounding box")
    q.add_argument("flac_file", help="Spatial FLAC file (local or remote)")
    q.add_argument("-b", "--bbox", required=True, help="Bounding box: 'xmin,ymin,xmax,ymax'")
    q.add_argument("-o", "--output", help="Save byte ranges to JSON file")
    q.set_defaults(func=cmd_query)

    cmp_ = sub.add_parser("compare", help="Compare two TIFF files")
    cmp_.add_argument("file1")
    cmp_.add_argument("file2")
    cmp_.add_argument("--show-bands", dest="show_bands", action="store_true", default=True)
    cmp_.add_argument("--no-bands", dest="show_bands", action="store_false")
    cmp_.add_argument("-e", "--export", help="Export comparison to JSON")
    cmp_.set_defaults(func=cmd_compare)

    for command in (c, i, e, q, cmp_):
        command.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                             help="Device of the codec (default cuda; cpu runs the "
                                  "kernels' plain PyTorch versions)")
    return p


def _normalize_argv(argv: list[str]) -> list[str]:
    """Join ``-b -105.4,...`` into ``-b=-105.4,...`` so argparse doesn't
    mistake negative coordinates for options (typer handled this natively)."""
    out = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("-b", "--bbox") and i + 1 < len(argv) and argv[i + 1].startswith("-"):
            out.append(f"{tok}={argv[i + 1]}")
            i += 2
        else:
            out.append(tok)
            i += 1
    return out


def main(argv=None) -> int:
    from .utils.devices import resolve_device

    if argv is None:
        argv = sys.argv[1:]
    args = build_parser().parse_args(_normalize_argv(list(argv)))
    try:
        # every command runs on its --device; CUDA asked for and absent
        # fails here, before any work
        args.device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
