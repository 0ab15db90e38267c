"""Minimal PCD point-cloud reader (x/y/z fields, ascii or binary).

The reference relies on pcl::io::loadPCDFile in its feature tests
(feature-test.cc:55); this is a dependency-free equivalent, a copy of
``teaserpp_tpu/io/pcd.py`` over the port's ``PointCloud``.
"""

from __future__ import annotations

import numpy as np

from teaserpp_tpu_torch.utils.geometry import PointCloud

_TYPE = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4", ("U", 4): "u4",
         ("I", 2): "i2", ("U", 2): "u2", ("I", 1): "i1", ("U", 1): "u1"}


def read_pcd(path: str) -> PointCloud:
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0]

        if mode == "ascii":
            rows = []
            for _ in range(n):
                rows.append([float(v) for v in f.readline().split()])
            data = np.asarray(rows, dtype=np.float64)
            cols = []
            c = 0
            colmap = {}
            for name, cnt in zip(fields, counts):
                colmap[name] = c
                c += cnt
            xyz = data[:, [colmap["x"], colmap["y"], colmap["z"]]]
        elif mode == "binary":
            dt = np.dtype(
                [
                    (name, "<" + _TYPE[(t, s)], (cnt,))
                    for name, t, s, cnt in zip(fields, types, sizes, counts)
                ]
            )
            arr = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
            xyz = np.stack(
                [arr["x"][:, 0], arr["y"][:, 0], arr["z"][:, 0]], axis=1
            ).astype(np.float64)
        else:
            raise ValueError(f"unsupported PCD data mode: {mode}")
        return PointCloud(xyz)
