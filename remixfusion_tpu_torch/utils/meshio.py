"""Minimal mesh / point-cloud IO (binary + ASCII PLY).

The port's copy of remixfusion_tpu.utils.meshio: the same bytes for the same
arrays. Replaces the reference's trimesh export (utils.py:202-209) and
hand-rolled ASCII writers (model/Volume.py:1348-1408) without external
dependencies.
"""

from __future__ import annotations

import numpy as np


def write_ply_mesh(path, verts, faces, colors=None, normals=None, binary=True):
    """Write a triangle mesh to PLY. colors: [V, 3] uint8/float, normals [V, 3]."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    has_c = colors is not None
    has_n = normals is not None
    if has_c:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
    if has_n:
        normals = np.asarray(normals, np.float32)

    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append(f"element vertex {len(verts)}")
    header += ["property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append(f"element face {len(faces)}")
    header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if has_n:
                fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
            if has_c:
                fields += [("r", "u1"), ("g", "u1"), ("b", "u1")]
            vdata = np.empty(len(verts), dtype=fields)
            vdata["x"], vdata["y"], vdata["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
            if has_n:
                vdata["nx"], vdata["ny"], vdata["nz"] = (
                    normals[:, 0], normals[:, 1], normals[:, 2])
            if has_c:
                vdata["r"], vdata["g"], vdata["b"] = (
                    colors[:, 0], colors[:, 1], colors[:, 2])
            f.write(vdata.tobytes())
            fdata = np.empty(len(faces), dtype=[("n", "u1"), ("i", "<i4", (3,))])
            fdata["n"] = 3
            fdata["i"] = faces
            f.write(fdata.tobytes())
        else:
            for i in range(len(verts)):
                row = list(verts[i])
                if has_n:
                    row += list(normals[i])
                line = " ".join(f"{v:f}" for v in row)
                if has_c:
                    line += " " + " ".join(str(int(c)) for c in colors[i])
                f.write((line + "\n").encode())
            for i in range(len(faces)):
                f.write((f"3 {faces[i,0]} {faces[i,1]} {faces[i,2]}\n").encode())


def write_ply_points(path, xyz, rgb=None):
    """Write a point cloud to ASCII PLY (reference Volume.py:1348-1372)."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if rgb is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            line = f"{xyz[i,0]:f} {xyz[i,1]:f} {xyz[i,2]:f}"
            if rgb is not None:
                line += f" {int(rgb[i,0])} {int(rgb[i,1])} {int(rgb[i,2])}"
            f.write(line + "\n")


def read_ply(path):
    """Read a PLY mesh/point cloud -> (verts [V,3] f32, faces [F,3] i32 or None).

    Supports the binary_little_endian and ascii files written by this module
    and common external meshes (extra vertex properties are skipped).
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype) or ('list', count_t, item_t, name)])
    cur = None
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = (t[1], int(t[2]), [])
            elements.append(cur)
        elif t[0] == "property" and cur is not None:
            if t[1] == "list":
                cur[2].append(("list", t[2], t[3], t[4]))
            else:
                cur[2].append((t[2], t[1]))  # (name, type)

    np_t = {
        "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
        "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    }
    verts = None
    faces = None
    if fmt == "ascii":
        text = body.decode("ascii", "replace").split("\n")
        ln = 0
        for name, count, props in elements:
            if name == "vertex":
                rows = []
                for i in range(count):
                    rows.append([float(x) for x in text[ln + i].split()[:3]])
                verts = np.asarray(rows, np.float32)
            elif name == "face":
                rows = []
                for i in range(count):
                    vals = text[ln + i].split()
                    k = int(vals[0])
                    rows.append([int(x) for x in vals[1: 1 + k]][:3])
                faces = np.asarray(rows, np.int32)
            ln += count
    else:
        little = fmt == "binary_little_endian"
        pre = "<" if little else ">"
        off = 0
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                # Assume uniform triangle lists (as written by standard tools).
                cnt_t = np_t[props[0][1]]
                itm_t = np_t[props[0][2]]
                rec = np.dtype([("n", pre + cnt_t), ("i", pre + itm_t, (3,))])
                arr = np.frombuffer(body, rec, count=count, offset=off)
                off += rec.itemsize * count
                if name == "face":
                    faces = arr["i"].astype(np.int32)
            else:
                rec = np.dtype([(p[0], pre + np_t[p[1]]) for p in props])
                arr = np.frombuffer(body, rec, count=count, offset=off)
                off += rec.itemsize * count
                if name == "vertex":
                    verts = np.stack(
                        [arr["x"], arr["y"], arr["z"]], axis=1
                    ).astype(np.float32)
    return verts, faces
