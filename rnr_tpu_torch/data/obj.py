"""Wavefront OBJ reading and writing (port of rnr_tpu/data/obj.py,
host-side NumPy).

The port's own copy of rnr_tpu's Python OBJ parser and of its `Mesh`:
v/vn/vt records, faces with v/vt/vn index triplets (negative indices
included), fan triangulation of polygons, optional unit-cube
normalization, and the global rigid transform with span statistics;
`load_mtl`, per-face texture volumes from the materials
(`load_obj(load_texture=True)`, through `ops/texture_atlas.py`), and
`save_obj`, with the per-face volumes baked into an atlas PNG.  Texture
images are read by `data/imageio.py` (PNG, JPEG, BMP, OpenEXR, HDR,
`.mat`) as cv2's IMREAD_UNCHANGED reads them.  `use_native` parses
with the C++ parser (data/native.py's build and binding of the port's
csrc/obj_parse.cpp) where it builds, else with the Python parser;
`MeshData.parser` says which ran.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import numpy as np
import torch

from rnr_tpu_torch.data.imageio import IMREAD_UNCHANGED, read_image, write_png
from rnr_tpu_torch.data.native import parse_obj_native
from rnr_tpu_torch.ops import texture_atlas

# load_obj calls by the parser that ran ("native", "python"): where a
# caller asked for the native parser and got the Python one, it fell back
parser_counts: collections.Counter = collections.Counter()


@dataclasses.dataclass
class MeshData:
    """Raw parsed OBJ arrays."""

    v: np.ndarray         # [V, 3] float32
    vn: np.ndarray        # [Vn, 3] float32 (possibly empty)
    vt: np.ndarray        # [Vt, 2] float32 (possibly empty)
    f_v_idx: np.ndarray   # [F, 3] int32
    f_vn_idx: np.ndarray  # [F, 3] int32 (possibly empty)
    f_vt_idx: np.ndarray  # [F, 3] int32 (possibly empty)
    # [F, ts, ts, ts, 3] float32 when load_obj(load_texture=True)
    textures: np.ndarray | None = None
    parser: str = "python"  # "native" where the C++ parser ran


WRAP_MODES = {"REPEAT": texture_atlas.REPEAT,
              "MIRRORED_REPEAT": texture_atlas.MIRRORED_REPEAT,
              "CLAMP_TO_EDGE": texture_atlas.CLAMP_TO_EDGE,
              "CLAMP_TO_BORDER": texture_atlas.CLAMP_TO_BORDER}


def load_mtl(path: str) -> tuple[dict, dict]:
    """Kd colours and map_Kd texture file names of an MTL file:
    ({material: [3] Kd}, {material: file name})."""
    colors: dict[str, np.ndarray] = {}
    texture_filenames: dict[str, str] = {}
    material_name = ""
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                material_name = parts[1]
            elif parts[0] == "map_Kd":
                texture_filenames[material_name] = parts[1]
            elif parts[0] == "Kd":
                colors[material_name] = np.array(
                    [float(x) for x in parts[1:4]], np.float32)
    return colors, texture_filenames


def _read_texture(path: str) -> np.ndarray:
    """A material's texture image as rnr_tpu reads it (cv2's unchanged
    read, its BGR flipped): RGB float32 of the stored values / 255, gray
    to three channels, alpha dropped, rows flipped (v from the bottom)."""
    img = read_image(path, IMREAD_UNCHANGED)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img[:, :, :3].astype(np.float32) / 255.0
    return img[::-1].copy()


def _load_obj_textures(obj_path: str, mtl_path: str, texture_size: int,
                       texture_wrapping: str, use_bilinear: bool
                       ) -> np.ndarray:
    """Per-face texture volumes from an OBJ's materials, as rnr_tpu fills
    them: the faces' corner UVs from the vt records (a corner without a
    vt index takes slot 0, which the -1 shift makes the last record), 0.5
    everywhere, each material's Kd over its faces, then each map_Kd image
    sampled into its faces (`texture_atlas.load_textures`)."""
    wrap = WRAP_MODES[texture_wrapping]
    vts: list[list[float]] = []
    fvt: list[tuple[int, int, int]] = []
    material_names: list[str] = []
    material_name = ""
    with open(obj_path) as fh:
        lines = fh.readlines()
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "vt":
            vts.append([float(x) for x in parts[1:3]])
        elif parts[0] == "usemtl":
            material_name = parts[1]
        elif parts[0] == "f":
            corners = parts[1:]

            def vt_of(tok: str) -> int:
                t = tok.split("/")
                return (int(t[1]) if len(t) > 1 and t[1] != ""
                        and "//" not in tok else 0)

            for k in range(1, len(corners) - 1):
                fvt.append((vt_of(corners[0]), vt_of(corners[k]),
                            vt_of(corners[k + 1])))
                material_names.append(material_name)
    vt = np.asarray(vts, np.float32).reshape(-1, 2)
    faces_uv = vt[np.asarray(fvt, np.int32) - 1]             # [F, 3, 2]
    ts = texture_size
    textures = np.full((faces_uv.shape[0], ts, ts, ts, 3), 0.5, np.float32)
    colors, texture_filenames = load_mtl(mtl_path)
    mat_arr = np.asarray(material_names)
    for name, color in colors.items():
        textures[mat_arr == name] = color[None, None, None, None, :]
    for name, fname in texture_filenames.items():
        fp = os.path.join(os.path.dirname(obj_path), fname)
        if not os.path.isfile(fp):
            raise FileNotFoundError(fp)
        img = _read_texture(fp)
        sel = mat_arr == name
        if not sel.any():
            continue
        textures[sel] = texture_atlas.load_textures(
            torch.from_numpy(img), torch.from_numpy(faces_uv[sel]), ts,
            wrap=wrap, use_bilinear=use_bilinear).numpy()
    return textures


def _resolve_index(tok: str, count: int) -> int:
    i = int(tok)
    return i - 1 if i > 0 else count + i


def load_obj(path: str, normalization: bool = False,
             use_native: bool = True, load_texture: bool = False,
             texture_size: int = 4, texture_wrapping: str = "REPEAT",
             use_bilinear: bool = True) -> MeshData:
    """Parse an OBJ file into zero-based int32 face index triplets.

    normalization: translate/scale the vertices into the unit cube centred
    at the origin.  vt / vn triplets are kept only when every face carries
    them; a mixed-format OBJ degrades to positions-only faces.
    load_texture: fill MeshData.textures [F, ts, ts, ts, 3] from the
    materials of the OBJ's `mtllib` (texture_size ts, texture_wrapping
    one of WRAP_MODES, bilinear or nearest); an OBJ without one raises.
    use_native: parse with the C++ parser where it is available
    (`parser` "native" in the result), else with the Python parser.
    """
    textures = None
    if load_texture:
        mtl_path = None
        with open(path) as fh:
            for line in fh:
                if line.startswith("mtllib"):
                    mtl_path = os.path.join(os.path.dirname(path),
                                            line.split()[1])
        if mtl_path is None:
            raise RuntimeError(f"load_texture=True but {path} has no mtllib")
        textures = _load_obj_textures(path, mtl_path, texture_size,
                                      texture_wrapping, use_bilinear)
    res = parse_obj_native(path) if use_native else None
    parser_counts["native" if res is not None else "python"] += 1
    if res is not None:
        v, vt, vn, fv, fvt, fvn = res
        if normalization and len(v):
            v = v - (v.max(0) + v.min(0)) / 2.0
            v = v / np.abs(v).max()
        # as the Python parser: a triplet array only where every face has it
        empty = np.zeros((0, 3), np.int32)
        return MeshData(v=v, vn=vn, vt=vt, f_v_idx=fv,
                        f_vn_idx=fvn if len(fvn) and (fvn >= 0).all()
                        else empty,
                        f_vt_idx=fvt if len(fvt) and (fvt >= 0).all()
                        else empty,
                        textures=textures, parser="native")
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
        textures=textures,
    )


def save_obj(path: str, v: np.ndarray, f_v_idx: np.ndarray,
             vt: np.ndarray | None = None, vn: np.ndarray | None = None,
             f_vt_idx: np.ndarray | None = None,
             f_vn_idx: np.ndarray | None = None,
             textures: np.ndarray | None = None,
             texture_size_out: int = 16) -> None:
    """Write an OBJ file (rnr_tpu's save_obj).

    With `textures` ([F, ts, ts, ts, 3] per-face volumes) the volumes are
    baked into a tiled atlas (`texture_atlas.create_texture_image`),
    written row-flipped as `<name>.png` beside a `<name>.mtl`, and each
    face gets its own three atlas vt records (`f v/3i+1 v/3i+2 v/3i+3`);
    vt, vn and the index triplets are then not written."""
    if textures is not None:
        mtl_path = path[:-4] + ".mtl"
        png_path = path[:-4] + ".png"
        material_name = "material_1"
        image, atlas_uv = texture_atlas.create_texture_image(
            torch.as_tensor(np.asarray(textures, np.float32)),
            texture_size_out)
        image = image.numpy()[::-1]     # v from the bottom
        write_png(png_path, np.clip(image * 255.0, 0, 255).astype(np.uint8))
        with open(mtl_path, "w") as fh:
            fh.write(f"newmtl {material_name}\n")
            fh.write(f"map_Kd {os.path.basename(png_path)}\n")
        with open(path, "w") as fh:
            fh.write(f"# {os.path.basename(path)}\n#\n\n")
            fh.write(f"mtllib {os.path.basename(mtl_path)}\n\n")
            for p in v:
                fh.write(f"v {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}\n")
            fh.write("\n")
            for p in atlas_uv.numpy().reshape(-1, 2):
                fh.write(f"vt {p[0]:.8f} {p[1]:.8f}\n")
            fh.write("\n")
            fh.write(f"usemtl {material_name}\n")
            for i, tri in enumerate(f_v_idx):
                fh.write(f"f {tri[0] + 1}/{3 * i + 1} {tri[1] + 1}/"
                         f"{3 * i + 2} {tri[2] + 1}/{3 * i + 3}\n")
            fh.write("\n")
        return
    with open(path, "w") as fh:
        for p in v:
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if vt is not None:
            for p in vt:
                fh.write(f"vt {p[0]} {p[1]}\n")
        if vn is not None:
            for p in vn:
                fh.write(f"vn {p[0]} {p[1]} {p[2]}\n")
        for i, tri in enumerate(f_v_idx):
            toks = []
            for k in range(3):
                s = str(tri[k] + 1)
                if f_vt_idx is not None or f_vn_idx is not None:
                    s += "/" + (str(f_vt_idx[i][k] + 1)
                                if f_vt_idx is not None else "")
                    if f_vn_idx is not None:
                        s += "/" + str(f_vn_idx[i][k] + 1)
                toks.append(s)
            fh.write("f " + " ".join(toks) + "\n")


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
