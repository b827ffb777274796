"""The port's binding of its native host runtime (rnr_tpu_torch/data/
native.py) and `load_obj(use_native=True)`: parity with the port's
Python parser and with rnr_tpu's (tests/test_native.py's cases, and a
sphere of over a million faces), which parser ran, the fall-back where
the library is unavailable, the parser's source free of the image
libraries, and the image decoder against the port's PNG reader.  The
OBJ parser is built from rnr_tpu_torch/csrc/obj_parse.cpp, the decoder
from native/rnr_native.cpp, into build/rnr_tpu_torch/ at first use;
where they cannot be built, the tests that need them fail (they need
g++, libpng and libjpeg on the host)."""

import re
import time

import numpy as np
import pytest

from rnr_tpu.data.obj import load_obj as jax_load_obj
from rnr_tpu_torch.data import native
from rnr_tpu_torch.data.imageio import read_image, write_png
from rnr_tpu_torch.data.obj import load_obj

SMALL_OBJ = ("# header\n"
             "v 0.5 -1.25 3e-2\nv 1 0 0\nv 1 1 0.5\nv 0 1 0.5\nv 2 2 2\n"
             "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
             "vn 0 0 1\nvn 0 1 0\n"
             "f 1/1/1 2/2/1 3/3/2 4/4/2\n"
             "f -3 -2 -1\n")
TRIPLET_OBJ = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
               "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
               "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n")
FIELDS = ("v", "vt", "vn", "f_v_idx", "f_vt_idx", "f_vn_idx")


def _random_obj(rng, nv=500, nf=900) -> str:
    v = rng.standard_normal((nv, 3)).astype(np.float32)
    f = rng.integers(0, nv, (nf, 3))
    return ("\n".join("v %f %f %f" % tuple(x) for x in v) + "\n"
            + "\n".join("f %d %d %d" % tuple(x + 1) for x in f) + "\n")


@pytest.mark.parametrize("normalization", [False, True])
@pytest.mark.parametrize("case", ["small", "triplets", "random"])
def test_native_parser_matches_python_and_rnr_tpu(case, normalization,
                                                  tmp_path):
    text = {"small": SMALL_OBJ, "triplets": TRIPLET_OBJ,
            "random": _random_obj(np.random.default_rng(0))}[case]
    p = tmp_path / "m.obj"
    p.write_text(text)
    nat = load_obj(str(p), normalization, use_native=True)
    py = load_obj(str(p), normalization, use_native=False)
    ref = jax_load_obj(str(p), normalization, use_native=False)
    assert (nat.parser, py.parser) == ("native", "python")
    for name in FIELDS:
        a, b, c = (getattr(m, name) for m in (nat, py, ref))
        assert a.shape == b.shape == c.shape, name
        assert a.dtype == b.dtype, name
        if name.startswith("f_"):
            np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(a, c, err_msg=name)
        else:   # strtof against Python's float, then float32
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
            np.testing.assert_allclose(a, c, rtol=1e-6, err_msg=name)


def test_parse_obj_native_arrays(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text(SMALL_OBJ)
    v, vt, vn, fv, fvt, fvn = native.parse_obj_native(str(p))
    assert v.shape == (5, 3) and vt.shape == (4, 2) and vn.shape == (2, 3)
    # the quad's fan and the negative-index triangle; the bare face's
    # corners carry -1 for vt and vn
    np.testing.assert_array_equal(fv, [[0, 1, 2], [0, 2, 3], [2, 3, 4]])
    np.testing.assert_array_equal(fvt[2], [-1, -1, -1])
    assert native.parse_obj_native(str(tmp_path / "missing.obj")) is None


def test_library_is_built_from_the_source_not_the_checked_in_copy():
    """The OBJ parser is the port's csrc/obj_parse.cpp built into
    build/rnr_tpu_torch/, linked against no library: not the checked-in
    native/librnr_native.so, and not native/rnr_native.cpp."""
    lib = native.get_lib()
    assert lib is not None and "obj_parse" not in native.build_error
    assert native.native_available()
    path = lib._name
    assert path.startswith(str(native.BUILD_DIR))
    assert "libobj_parse-" in path and "-march" not in native.CXX_FLAGS
    source, libs = native.SOURCES["obj_parse"]
    assert source == native.ROOT / "rnr_tpu_torch" / "csrc" / "obj_parse.cpp"
    assert libs == ()


def test_obj_parser_source_needs_no_image_library():
    """csrc/obj_parse.cpp includes only libc / POSIX headers (the card
    machine has no libjpeg or libpng) and defines the two entry points
    that data/native.py binds."""
    source, _ = native.SOURCES["obj_parse"]
    text = source.read_text()
    includes = re.findall(r"#include\s*<([^>]+)>", text)
    assert includes and not {"jpeglib.h", "png.h", "zlib.h"} & set(includes)
    assert set(includes) <= {"cctype", "cstdint", "cstdlib", "fcntl.h",
                             "sys/mman.h", "sys/stat.h", "unistd.h"}
    for entry in ("int rnr_obj_count(", "int rnr_obj_parse("):
        assert entry in text


def test_python_parser_where_the_library_is_unavailable(tmp_path,
                                                        monkeypatch):
    p = tmp_path / "m.obj"
    p.write_text(SMALL_OBJ)
    monkeypatch.setitem(native._loaded, "obj_parse", None)
    monkeypatch.setitem(native._loaded, "rnr_native", None)
    m = load_obj(str(p), use_native=True)
    assert m.parser == "python"
    np.testing.assert_array_equal(m.f_v_idx, [[0, 1, 2], [0, 2, 3],
                                              [2, 3, 4]])
    assert native.parse_obj_native(str(p)) is None
    assert native.decode_images_native([str(p)]) is None


def write_sphere_obj(path: str, n_lat: int, n_lon: int):
    """synthetic.sphere_mesh(n_lat, n_lon) as an OBJ of v / vt / vn
    triplets (chip_smoke.py's write_obj, formatted row by row with one
    % each); returns the mesh."""
    from rnr_tpu_torch.synthetic import sphere_mesh
    m = sphere_mesh(n_lat, n_lon)
    rows = [map("v %.7f %.7f %.7f\n".__mod__, map(tuple, m.v.tolist())),
            map("vt %.7f %.7f\n".__mod__, map(tuple, m.vt.tolist())),
            map("vn %.7f %.7f %.7f\n".__mod__, map(tuple, m.vn.tolist())),
            map("f %d/%d/%d %d/%d/%d %d/%d/%d\n".__mod__, map(
                tuple, np.repeat(m.f_v_idx + 1, 3, axis=1).tolist()))]
    with open(path, "w") as f:
        for r in rows:
            f.writelines(r)
    return m


def test_native_parser_on_a_million_faces(tmp_path):
    """A 708 x 708 UV sphere (1,001,112 faces, 502,681 vertices): the
    native parser's arrays equal the Python parser's (indices exactly,
    floats bit for bit: both round the same decimal to float32) and the
    mesh's; both parsers' times printed."""
    path = str(tmp_path / "big.obj")
    mesh = write_sphere_obj(path, 708, 708)
    t0 = time.perf_counter()
    nat = load_obj(path, use_native=True)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = load_obj(path, use_native=False)
    t_py = time.perf_counter() - t0
    print(f"native {t_nat:.3f} s, Python {t_py:.3f} s, "
          f"{len(py.f_v_idx)} faces")
    assert (nat.parser, py.parser) == ("native", "python")
    assert len(nat.f_v_idx) == 1001112 and len(nat.v) == 502681
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(nat, name), getattr(py, name),
                                      err_msg=name)
    np.testing.assert_array_equal(nat.f_v_idx, mesh.f_v_idx)
    np.testing.assert_array_equal(nat.f_vt_idx, mesh.f_v_idx)
    np.testing.assert_allclose(nat.v, mesh.v, rtol=0, atol=6e-8)


def test_image_decode_matches_the_png_reader(tmp_path):
    rng = np.random.default_rng(3)
    paths, want = [], []
    for i, ch in enumerate((3, 3, 4, 3)):
        img = rng.integers(0, 256, (24 + i, 32, ch), dtype=np.uint8)
        path = str(tmp_path / f"img{i}.png")
        write_png(path, img)
        paths.append(path)
        want.append(read_image(path)[..., :3].astype(np.float32) / 255.0)
    got = native.decode_images_native(paths, n_threads=2)
    assert got is not None and len(got) == len(paths)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert native.decode_images_native(
        paths + [str(tmp_path / "missing.png")]) is None
