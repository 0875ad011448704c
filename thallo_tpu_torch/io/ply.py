"""PLY mesh IO + mesh->graph conversion for the example gallery.

The reference's mesh examples load .ply/.off meshes through OpenMesh
(examples/shared/OpenMesh.h; e.g. examples/arap_mesh_deformation reads a
mesh and builds one ThalloGraph edge per half-edge, its main.cpp /
CombinedSolver.h).  This is the TPU build's native loader: ASCII and
binary little/big-endian PLY, vertices + arbitrary scalar vertex
properties + faces, no third-party dependency.
"""
from __future__ import annotations

import numpy as np

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


def load_ply(path):
    """Load a PLY mesh.  Returns (vertices [N,3] float32, faces [F,k]
    int32 or None, props) where props maps any extra vertex property
    name -> [N] array (e.g. nx/ny/nz, red/green/blue).

    Triangulates mixed-arity faces by fanning: a face (a, b, c, d)
    yields (a,b,c), (a,c,d)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ("list", idx_t, val_t, name)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            parts = line.decode("ascii", "replace").split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", _PLY_TYPES[parts[2]],
                                            _PLY_TYPES[parts[3]], parts[4]))
                else:
                    elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]]))
            elif parts[0] == "end_header":
                break
        if fmt is None:
            raise ValueError("PLY header missing format line")
        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)

        data = {}
        if fmt == "ascii":
            tokens = f.read().split()
            pos = 0
            for name, count, props in elements:
                if any(p[0] == "list" for p in props):
                    rows = []
                    for _ in range(count):
                        row = []
                        for p in props:
                            if p[0] == "list":
                                n = int(tokens[pos]); pos += 1
                                row.append([float(tokens[pos + i]) for i in range(n)])
                                pos += n
                            else:
                                row.append(float(tokens[pos])); pos += 1
                        rows.append(row)
                    data[name] = (props, rows)
                else:
                    width = len(props)
                    arr = np.asarray(
                        tokens[pos:pos + count * width], dtype=np.float64
                    ).reshape(count, width)
                    pos += count * width
                    data[name] = (props, arr)
        else:
            for name, count, props in elements:
                if any(p[0] == "list" for p in props):
                    rows = []
                    for _ in range(count):
                        row = []
                        for p in props:
                            if p[0] == "list":
                                idx_t = np.dtype(endian + p[1])
                                val_t = np.dtype(endian + p[2])
                                n = int(np.frombuffer(f.read(idx_t.itemsize), idx_t)[0])
                                row.append(np.frombuffer(
                                    f.read(val_t.itemsize * n), val_t).tolist())
                            else:
                                t = np.dtype(endian + p[1])
                                row.append(float(np.frombuffer(f.read(t.itemsize), t)[0]))
                        rows.append(row)
                    data[name] = (props, rows)
                else:
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    arr = np.frombuffer(f.read(dt.itemsize * count), dt)
                    data[name] = (props, arr)

    # vertices
    if "vertex" not in data:
        raise ValueError("PLY file has no vertex element")
    vprops, varr = data["vertex"]
    names = [p[0] for p in vprops]
    if isinstance(varr, np.ndarray) and varr.dtype.fields:
        get = lambda n: np.asarray(varr[n], np.float64)  # noqa: E731
    else:
        get = lambda n: np.asarray(varr)[:, names.index(n)]  # noqa: E731
    verts = np.stack([get("x"), get("y"), get("z")], axis=-1).astype(np.float32)
    props_out = {n: get(n).astype(np.float32) for n in names if n not in ("x", "y", "z")}

    # faces (fan-triangulated)
    faces = None
    if "face" in data:
        fprops, frows = data["face"]
        li = next(i for i, p in enumerate(fprops) if p[0] == "list")
        tris = []
        for row in frows:
            idx = [int(v) for v in row[li]]
            for k in range(1, len(idx) - 1):
                tris.append((idx[0], idx[k], idx[k + 1]))
        faces = np.asarray(tris, np.int32) if tris else None
    return verts, faces, props_out


def save_ply(path, vertices, faces=None, ascii=False, **vertex_props):
    """Write a PLY mesh (binary little-endian by default).  Extra [N]
    float arrays go in as named vertex properties."""
    vertices = np.asarray(vertices, np.float32)
    n = len(vertices)
    cols = [("x", vertices[:, 0]), ("y", vertices[:, 1]), ("z", vertices[:, 2])]
    cols += [(k, np.asarray(v, np.float32).reshape(n)) for k, v in vertex_props.items()]
    with open(path, "wb") as f:
        f.write(b"ply\n")
        f.write(b"format ascii 1.0\n" if ascii else b"format binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % n)
        for k, _ in cols:
            f.write(b"property float %s\n" % k.encode())
        if faces is not None:
            f.write(b"element face %d\n" % len(faces))
            f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        if ascii:
            for i in range(n):
                f.write((" ".join("%.9g" % c[1][i] for c in cols) + "\n").encode())
            if faces is not None:
                for fc in np.asarray(faces, np.int64):
                    f.write(("%d " % len(fc) + " ".join(map(str, fc)) + "\n").encode())
        else:
            arr = np.empty(n, np.dtype([(k, "<f4") for k, _ in cols]))
            for k, v in cols:
                arr[k] = v
            f.write(arr.tobytes())
            if faces is not None:
                fa = np.asarray(faces, np.int32)
                k = fa.shape[1]
                rec = np.empty(len(fa), np.dtype([("n", "u1"), ("v", "<i4", (k,))]))
                rec["n"] = k
                rec["v"] = fa
                f.write(rec.tobytes())


def edges_from_faces(faces, directed=True):
    """Unique mesh edges from a face array — one graph entry per
    half-edge when directed=True (the reference builds its ARAP graph
    this way: one hyper-edge per half-edge so each vertex sees all its
    neighbors; arap_mesh_deformation CombinedSolver.h)."""
    faces = np.asarray(faces, np.int64)
    k = faces.shape[1]
    pairs = np.concatenate(
        [faces[:, [i, (i + 1) % k]] for i in range(k)], axis=0)
    und = np.sort(pairs, axis=1)
    und = np.unique(und, axis=0)
    if directed:
        e = np.concatenate([und, und[:, ::-1]], axis=0)
    else:
        e = und
    return np.ascontiguousarray(e.astype(np.int32))


def mesh_to_arap_inputs(vertices, faces, constraints=None,
                        w_fit=10.0, w_reg=1.0):
    """Build the input dict for models.arap_mesh_deformation from a
    loaded mesh.  `constraints`: dict vertex_id -> target [3] (others
    free); matches the reference CombinedSolver's constraint encoding
    (unconstrained = large negative sentinel)."""
    vertices = np.asarray(vertices, np.float32)
    N = len(vertices)
    edges = edges_from_faces(faces, directed=True)
    cons = np.full((N, 3), -9999999.0, np.float32)
    if constraints:
        for vid, tgt in constraints.items():
            cons[vid] = np.asarray(tgt, np.float32)
    return {
        "w_fitSqrt": np.sqrt(w_fit),
        "w_regSqrt": np.sqrt(w_reg),
        "Position": vertices.copy(),
        "Angle": np.zeros((N, 3), np.float32),
        "Original": vertices,
        "Constraints": cons,
        "V0": edges[:, 0],
        "V1": edges[:, 1],
    }, {"N": N, "E": len(edges)}
