"""The port's binding of the native host runtime (rnr_tpu_torch/data/
native.py) and `load_obj(use_native=True)`: parity with the port's
Python parser and with rnr_tpu's (tests/test_native.py's cases), which
parser ran, the fall-back where the library is unavailable, and the
image decoder against the port's PNG reader.  The library is built from
native/rnr_native.cpp into build/rnr_tpu_torch/ at first use; where it
cannot be built here, the tests that need it fail (this container has
g++, libpng and libjpeg)."""

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
    lib = native.get_lib()
    assert lib is not None and native.build_error is None
    assert native.native_available()
    path = lib._name
    assert path.startswith(str(native.BUILD_DIR))
    assert "librnr_native-" in path and "-march" not in native.CXX_FLAGS


def test_python_parser_where_the_library_is_unavailable(tmp_path,
                                                        monkeypatch):
    p = tmp_path / "m.obj"
    p.write_text(SMALL_OBJ)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", True)
    m = load_obj(str(p), use_native=True)
    assert m.parser == "python"
    np.testing.assert_array_equal(m.f_v_idx, [[0, 1, 2], [0, 2, 3],
                                              [2, 3, 4]])
    assert native.parse_obj_native(str(p)) is None
    assert native.decode_images_native([str(p)]) is None


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
