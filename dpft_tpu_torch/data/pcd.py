"""Minimal PCD (Point Cloud Data) reader (counterpart of dpft_tpu/data/pcd.py).

Replaces the reference's pypcd dependency (reference processor.py:15,557).
Supports ascii and binary PCD v0.7 files with scalar fields (COUNT == 1),
which covers the K-Radar Ouster exports (fields x, y, z, intensity, t,
reflectivity, ring, ambient, range).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_TYPE_MAP = {
    ("F", 4): np.float32, ("F", 8): np.float64,
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
    ("I", 8): np.int64,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
    ("U", 8): np.uint64,
}


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Reads a PCD file into a dict of per-field 1-D arrays."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition(" ")
            header[key.upper()] = value
            if key.upper() == "DATA":
                break
        payload = f.read()

    fields = header["FIELDS"].split()
    sizes = list(map(int, header["SIZE"].split()))
    types = header["TYPE"].split()
    counts = list(map(int, header.get("COUNT", " ".join(["1"] * len(fields))).split()))
    points = int(header["POINTS"])
    mode = header["DATA"].lower()

    if any(c != 1 for c in counts):
        raise NotImplementedError("PCD COUNT != 1 not supported")

    dtype = np.dtype([
        (name, _TYPE_MAP[(t, s)]) for name, t, s in zip(fields, types, sizes)
    ])

    if mode == "binary":
        arr = np.frombuffer(payload, dtype=dtype, count=points)
    elif mode == "ascii":
        text = payload.decode("ascii", errors="replace")
        raw = np.loadtxt(text.splitlines(), dtype=np.float64, ndmin=2)
        arr = np.zeros(points, dtype=dtype)
        for i, name in enumerate(fields):
            arr[name] = raw[:points, i].astype(dtype[name])
    else:
        raise NotImplementedError(f"PCD DATA mode '{mode}' not supported")

    return {name: np.asarray(arr[name]) for name in fields}


def write_pcd(path: str, fields: Dict[str, np.ndarray],
              mode: str = "binary") -> None:
    """Writes a dict of equal-length 1-D arrays as a PCD v0.7 file."""
    names = list(fields)
    arrays = [np.asarray(fields[n]) for n in names]
    points = len(arrays[0])

    def type_char(dt):
        if dt.kind == "f":
            return "F"
        return "I" if dt.kind == "i" else "U"

    header = [
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(names),
        "SIZE " + " ".join(str(a.dtype.itemsize) for a in arrays),
        "TYPE " + " ".join(type_char(a.dtype) for a in arrays),
        "COUNT " + " ".join(["1"] * len(names)),
        f"WIDTH {points}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {points}",
        f"DATA {mode}",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if mode == "binary":
            rec = np.zeros(points, dtype=np.dtype(
                [(n, a.dtype) for n, a in zip(names, arrays)]))
            for n, a in zip(names, arrays):
                rec[n] = a
            f.write(rec.tobytes())
        else:
            for i in range(points):
                f.write((" ".join(str(a[i]) for a in arrays) + "\n").encode())
