"""Wavefront OBJ reading (port of rnr_tpu/data/obj.py, host-side NumPy).

The port's own copy of rnr_tpu's Python OBJ parser and of its `Mesh`:
v/vn/vt records, faces with v/vt/vn index triplets (negative indices
included), fan triangulation of polygons, optional unit-cube
normalization, and the global rigid transform with span statistics.
rnr_tpu's C++ parser route and per-face texture volumes are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    """Raw parsed OBJ arrays."""

    v: np.ndarray         # [V, 3] float32
    vn: np.ndarray        # [Vn, 3] float32 (possibly empty)
    vt: np.ndarray        # [Vt, 2] float32 (possibly empty)
    f_v_idx: np.ndarray   # [F, 3] int32
    f_vn_idx: np.ndarray  # [F, 3] int32 (possibly empty)
    f_vt_idx: np.ndarray  # [F, 3] int32 (possibly empty)


def _resolve_index(tok: str, count: int) -> int:
    i = int(tok)
    return i - 1 if i > 0 else count + i


def load_obj(path: str, normalization: bool = False) -> MeshData:
    """Parse an OBJ file into zero-based int32 face index triplets.

    normalization: translate/scale the vertices into the unit cube centred
    at the origin.  vt / vn triplets are kept only when every face carries
    them; a mixed-format OBJ degrades to positions-only faces.
    """
    vs: list[list[float]] = []
    vns: list[list[float]] = []
    vts: list[list[float]] = []
    fv: list[list[int]] = []
    fvt: list[list[int]] = []
    fvn: list[list[int]] = []

    with open(path) as fh:
        for line in fh:
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                vts.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                corners = parts[1:]
                for k in range(1, len(corners) - 1):   # fan triangulation
                    vi, vti, vni = [], [], []
                    for c in (corners[0], corners[k], corners[k + 1]):
                        toks = c.split("/")
                        vi.append(_resolve_index(toks[0], len(vs)))
                        if len(toks) > 1 and toks[1] != "":
                            vti.append(_resolve_index(toks[1], len(vts)))
                        if len(toks) > 2 and toks[2] != "":
                            vni.append(_resolve_index(toks[2], len(vns)))
                    fv.append(vi)
                    if len(vti) == 3:
                        fvt.append(vti)
                    if len(vni) == 3:
                        fvn.append(vni)

    v = np.asarray(vs, np.float32).reshape(-1, 3)
    if normalization and len(v):
        vmin = v.min(0)
        vmax = v.max(0)
        v = v - (vmax + vmin) / 2.0
        v = v / np.abs(v).max()
    if len(fvt) != len(fv):
        fvt = []
    if len(fvn) != len(fv):
        fvn = []
    return MeshData(
        v=v,
        vn=np.asarray(vns, np.float32).reshape(-1, 3),
        vt=np.asarray(vts, np.float32).reshape(-1, 2),
        f_v_idx=np.asarray(fv, np.int32).reshape(-1, 3),
        f_vn_idx=np.asarray(fvn, np.int32).reshape(-1, 3),
        f_vt_idx=np.asarray(fvt, np.int32).reshape(-1, 3),
    )


class Mesh:
    """A loaded mesh with an optional global rigid transform [4, 4]:
    original and transformed vertices / normals, and the span and centre
    statistics used to scale tolerances (`span_max`)."""

    def __init__(self, obj_path: str, global_RT: np.ndarray | None = None):
        data = load_obj(obj_path, normalization=False)
        self.data = data
        self.v_orig = data.v.copy()
        self.vn_orig = data.vn.copy()
        self.span_orig = data.v.max(0) - data.v.min(0)
        self.span_max_orig = float(self.span_orig.max())
        self.center_orig = data.v.mean(0)

        v, vn = data.v, data.vn
        if global_RT is not None:
            hom = np.concatenate([v, np.ones((v.shape[0], 1), v.dtype)], 1)
            v = (global_RT @ hom.T).T[:, :3].astype(np.float32)
            if len(vn):
                vn = (global_RT[:3, :3] @ vn.T).T
                vn = (vn / np.maximum(
                    np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
                ).astype(np.float32)
        self.v = v
        self.vn = vn
        self.vt = data.vt
        self.f_v_idx = data.f_v_idx
        self.f_vn_idx = data.f_vn_idx
        self.f_vt_idx = data.f_vt_idx
        self.num_vertex = v.shape[0]
        self.num_face = data.f_v_idx.shape[0]
        self.span = v.max(0) - v.min(0) if len(v) else np.zeros(3)
        self.span_max = float(self.span.max()) if len(v) else 0.0
        self.center = v.mean(0) if len(v) else np.zeros(3)
