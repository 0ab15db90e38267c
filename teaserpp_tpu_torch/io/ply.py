"""PLY point-cloud reader/writer.

Capability parity with reference ply_io.cc:28-112 (which wraps the vendored
tinyply): reads binary-little-endian / binary-big-endian / ascii PLY vertex
elements with float32 or float64 x/y/z properties, writes binary or ascii.
Implemented on numpy structured arrays — host-side I/O. A copy of
``teaserpp_tpu/io/ply.py`` over the port's ``PointCloud``, so a file written
by either package reads the same in the other.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from teaserpp_tpu_torch.utils.geometry import PointCloud

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(f) -> Tuple[str, List[Tuple[str, int, List[Tuple[str, str]]]]]:
    """Returns (format, [(element_name, count, [(prop_name, dtype_code)])])."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                # (count_type, item_type, name) — only legal outside vertices
                elements[-1][2].append(
                    (tokens[4], f"LIST:{_PLY_TYPES[tokens[2]]}:{_PLY_TYPES[tokens[3]]}")
                )
            else:
                elements[-1][2].append((tokens[2], _PLY_TYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format line")
    return fmt, elements


def read_ply(path: str) -> PointCloud:
    """Read the vertex element of a PLY file into a PointCloud."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = "<" if fmt == "binary_little_endian" else ">"
        cloud = None
        for name, count, props in elements:
            has_list = any(code.startswith("LIST") for _, code in props)
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                if name != "vertex":
                    continue
                cols = {p: i for i, (p, _) in enumerate(props)}
                data = np.asarray(rows, dtype=np.float64)
                xyz = data[:, [cols["x"], cols["y"], cols["z"]]]
                cloud = PointCloud(xyz)
            else:
                if has_list:
                    if name == "vertex":
                        raise ValueError("list properties on vertices unsupported")
                    # skip variable-length element payload by parsing it
                    for _ in range(count):
                        for _, code in props:
                            if code.startswith("LIST"):
                                _, cnt_t, item_t = code.split(":")
                                cnt = int(
                                    np.frombuffer(
                                        f.read(np.dtype(cnt_t).itemsize),
                                        dtype=endian + cnt_t,
                                    )[0]
                                )
                                f.read(np.dtype(item_t).itemsize * cnt)
                            else:
                                f.read(np.dtype(code).itemsize)
                    continue
                dt = np.dtype([(p, endian + c) for p, c in props])
                buf = f.read(dt.itemsize * count)
                if name != "vertex":
                    continue
                arr = np.frombuffer(buf, dtype=dt, count=count)
                xyz = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=1
                ).astype(np.float64)
                cloud = PointCloud(xyz)
        if cloud is None:
            raise ValueError(f"no vertex element found in {path}")
        return cloud


def write_ply(path: str, cloud: PointCloud, binary: bool = True) -> int:
    """Write a PointCloud to PLY (float32 vertices, like reference ply_io.cc:83)."""
    pts = np.asarray(cloud.points, dtype=np.float32)
    n = pts.shape[0]
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(pts.astype("<f4")).tobytes())
        else:
            np.savetxt(f, pts, fmt="%.9g")
    return 0


class PLYReader:
    """Reference-style reader facade (ply_io.h): returns 0 on success."""

    def read(self, path: str, cloud: PointCloud) -> int:
        if not os.path.exists(path):
            return -1
        try:
            loaded = read_ply(path)
        except (ValueError, OSError):
            return -1
        cloud._pts = loaded.points
        return 0


class PLYWriter:
    """Reference-style writer facade (ply_io.h): returns 0 on success."""

    def write(self, path: str, cloud: PointCloud, binary_mode: bool = True) -> int:
        try:
            return write_ply(path, cloud, binary=binary_mode)
        except OSError:
            return -1
