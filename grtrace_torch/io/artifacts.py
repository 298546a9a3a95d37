"""Artifact writers: images and CSVs in the JAX package's schemas — the
port's copy of `grtrace.io.artifacts`, with no pandas and no Pillow needed
for anything but a file background.

  * photon_data.csv — i,j,final_r,final_th,final_ph,collision,h_r,h_theta,
    h_phi,p0_t,p0_r,p0_th,p0_ph,alpha0 (one row per pixel);
  * sampled_rays.csv — ray_id,point_idx,x,y,z,r,h_r,h_theta,h_phi, with each
    ray's own heading (the reference indexed it with the sample number);
  * the single-ray CSV — t,r,theta,phi, angles in degrees;
  * PNG images (manual_output.png, no_gravity.png, scene_full.png), written
    and read with the standard library's zlib.

The CSVs go through the native writer (grtrace_torch/native) when g++ can
build it, else through a writer on the `csv` module that formats every
float as the native one does (%.17g).  `writes` counts which one ran.
"""
from __future__ import annotations

import csv
import os
import struct
import zlib
from typing import Optional

import numpy as np

from . import textures

COLLISION_NAMES = ("bh", "numerical error", "escape_bg", "escape_no_patch",
                   "in_domain", "disk")
PHOTON_COLUMNS = ("i", "j", "final_r", "final_th", "final_ph", "collision",
                  "h_r", "h_theta", "h_phi", "p0_t", "p0_r", "p0_th",
                  "p0_ph", "alpha0")
SAMPLED_COLUMNS = ("ray_id", "point_idx", "x", "y", "z", "r", "h_r",
                   "h_theta", "h_phi")

# CSV files written by each writer since the process started (or since a
# caller reset them)
writes = {"native": 0, "python": 0}


def resolve_background(spec):
    """A background spec -> a loadable path.  A relative path that does not
    exist from the working directory is looked up in the repository root
    (the parent of the grtrace_torch package), then in each directory of
    GRTRACE_ASSET_PATH (colon-separated).  Absolute paths, existing
    relative paths, procedural specs and unresolvable specs pass through
    unchanged."""
    if not spec or textures.is_procedural(spec) or os.path.isabs(spec):
        return spec
    if os.path.exists(spec):
        return spec
    roots = [os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))]
    roots += [d for d in os.environ.get("GRTRACE_ASSET_PATH", "").split(":")
              if d]
    for root in roots:
        cand = os.path.join(root, spec)
        if os.path.exists(cand):
            return cand
    return spec


def load_background(path: str, size: Optional[tuple] = None) -> np.ndarray:
    """An equirectangular texture as (h, w, 3) uint8, from a procedural spec
    ('procedural:<name>[:seed]', io/textures.py: needs nothing) or an image
    file (needs Pillow).  size=(w, h) resizes a file with LANCZOS and
    generates a procedural texture at that size, as the JAX package
    does."""
    if textures.is_procedural(path):
        hw = (size[1], size[0]) if size is not None else None
        return textures.from_spec(path, size=hw)
    try:
        from PIL import Image
    except ImportError as err:
        raise RuntimeError(
            f"background {path!r} is an image file, which needs Pillow to "
            f"load; this Python has none (a procedural background such as "
            f"'procedural:starfield' needs nothing)") from err
    img = Image.open(resolve_background(path)).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.LANCZOS)
    return np.array(img)


def background_available(spec) -> bool:
    """True if `spec` names a loadable background (file or procedural)."""
    if not spec:
        return False
    return textures.is_procedural(spec) or os.path.exists(
        resolve_background(spec))


# --- PNG -------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def png_bytes(img) -> bytes:
    """An (H, W), (H, W, 3) or (H, W, 4) uint8 array as PNG bytes (8 bits a
    sample, no filter, zlib level 6)."""
    a = np.asarray(img, dtype=np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"cannot write a PNG with {c} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image(img, path: str) -> None:
    """Write an image array as a PNG file (standard library only)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def read_png(path: str) -> np.ndarray:
    """Decode a PNG as `save_image` writes it (8-bit gray, RGB or RGBA, not
    interlaced, no row filter) into an (H, W[, C]) uint8 array, checking
    every chunk's CRC."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, RGB or "
                         f"RGBA PNGs are read")
    c = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not read")
    img = rows[:, 1:].reshape(h, w, c)
    return img[..., 0] if c == 1 else img


# --- CSV -------------------------------------------------------------------

def _g17(v) -> str:
    """A float as the native writer formats it (printf %.17g)."""
    return "%.17g" % v


def _write_rows(path, header, rows) -> None:
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(header)
        out.writerows(rows)


def _photon_arrays(result):
    h, w = result.cls.shape
    return (h, w, np.asarray(result.final_q)[..., 1].reshape(-1),
            result.final_th.reshape(-1), result.final_ph.reshape(-1),
            result.cls.reshape(-1), np.asarray(result.heading).reshape(-1, 3),
            np.asarray(result.p0).reshape(-1, 4), result.alpha0.reshape(-1))


def write_photon_csv_python(path, h, w, final_r, final_th, final_ph, cls,
                            heading, p0, alpha0) -> None:
    """photon_data.csv with the `csv` module, the native writer's text."""
    floats = np.concatenate([np.stack([final_r, final_th, final_ph], -1),
                             heading, p0, np.asarray(alpha0)[:, None]],
                            axis=-1).astype(np.float64)
    rows = []
    for k in range(h * w):
        f = [_g17(v) for v in floats[k].tolist()]
        rows.append([k // w, k % w, *f[:3], COLLISION_NAMES[int(cls[k])],
                     *f[3:]])
    _write_rows(path, PHOTON_COLUMNS, rows)


def save_photon_data(result, path="photon_data.csv"):
    """Write photon_data.csv: the native writer, or the Python one where
    it is not available."""
    from .. import native
    arrays = _photon_arrays(result)
    if native.write_photon_csv(str(path), *arrays):
        writes["native"] += 1
        return
    write_photon_csv_python(path, *arrays)
    writes["python"] += 1


def write_sampled_csv_python(path, xyz, heading) -> None:
    """sampled_rays.csv with the `csv` module, the native writer's text
    (xyz: (n_rays, n_pts, 3))."""
    xyz = np.asarray(xyz, dtype=np.float64)
    rows = []
    for rid in range(xyz.shape[0]):
        hd = [_g17(v) for v in np.asarray(heading[rid], np.float64).tolist()]
        for pidx, (x, y, z) in enumerate(xyz[rid].tolist()):
            r = float(np.sqrt(np.float64(x * x + y * y + z * z)))
            rows.append([rid, pidx, _g17(x), _g17(y), _g17(z), _g17(r), *hd])
    _write_rows(path, SAMPLED_COLUMNS, rows)


def save_sampled_rays(result, path="sampled_rays.csv"):
    """Write sampled_rays.csv; zero-filled post-exit rows are kept, as the
    reference buffer has them (consumers filter all-zero points)."""
    from .. import native
    xyz = np.stack(result.sampled_trajectories)
    heading = np.asarray(result.heading)
    hsel = np.stack([heading[i, j] for (i, j) in result.sampled_indices])
    if native.write_sampled_csv(str(path), xyz, hsel):
        writes["native"] += 1
        return
    write_sampled_csv_python(path, xyz, hsel)
    writes["python"] += 1


def save_single_ray_csv(traj, path="single_ray_test.csv") -> None:
    """(steps, 4) trajectory -> CSV with t,r,theta,phi; angles in
    degrees."""
    a = np.array(traj, dtype=np.float64).reshape(-1, 4)
    a[:, 2:] = np.degrees(a[:, 2:])
    _write_rows(path, ("t", "r", "theta", "phi"),
                [[repr(v) for v in row] for row in a.tolist()])


def print_summary(counts: dict) -> None:
    """The reference's end-of-run photon summary."""
    print("\nPhoton summary:")
    print(f"  Captured by BH: {counts['captured']}")
    print(f"  Still in domain: {counts['in_domain']}")
    print(f"  Escaped: {counts['escaped']}")
    print(f"  Hit background: {counts['background']}")
    if counts.get("numerical_error"):
        print(f"  Numerical errors: {counts['numerical_error']}")
    if counts.get("disk"):
        print(f"  Hit accretion disk: {counts['disk']}")
