"""View and light-probe datasets, host-side NumPy (port of
rnr_tpu/data/dataset.py).

calib.mat loading, the sampling patterns (all / filter / first_N /
after_N / skip_N / skipinv_N / only_N), the square crop and resize with
the intrinsics adjusted to match, RAM buffering, and the precomputed
G-buffer maps of the `precomp_<obj>/resol_<S>/` layout that either
package's precompute writes.  Images are read by `data/imageio.py` (PNG,
JPEG, BMP, OpenEXR, Radiance HDR, .mat), cv2's IMREAD_UNCHANGED read of
rnr_tpu, channels RGB.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
import scipy.io

from rnr_tpu_torch.data.imageio import (IMREAD_UNCHANGED, read_image,
                                        read_png, resize)

IMG_EXTS = ["*.png", "*.jpg", "*.JPEG", "*.bmp", "*.exr", "*.hdr", "*.mat"]


def glob_imgs(path: str) -> list[str]:
    out: list[str] = []
    for ext in IMG_EXTS:
        out.extend(glob(os.path.join(path, ext)))
    return sorted(out)


def load_img(filepath: str, square_crop: bool = False,
             target_size: list[int] | None = None):
    """An image as float32 RGB: `.exr`, `.hdr` and `.mat` as stored,
    every other format (PNG, JPEG, BMP) divided by 255, as rnr_tpu's cv2
    branch does.  Returns (img, center_coord, center_coord_new,
    img_crop_size), the reference loader's tuple, for the intrinsics
    adjustment."""
    img = read_image(filepath, IMREAD_UNCHANGED)
    if not filepath.endswith((".exr", ".hdr", ".mat")):
        img = img.astype(np.float32) / 255.0
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        img = img[:, :, :3]

    if square_crop:
        h, w = img.shape[:2]
        side = min(h, w)
        cy, cx = h // 2, w // 2
        y0, x0 = cy - side // 2, cx - side // 2
        img = img[y0:y0 + side, x0:x0 + side]
        center_coord = np.array([cy, cx])
        center_coord_new = np.array([side // 2, side // 2])
    else:
        center_coord = np.array(img.shape[:2]) // 2
        center_coord_new = center_coord
    img_crop_size = np.array(img.shape[:2])

    if target_size is not None:
        img = resize(img, (int(target_size[1]), int(target_size[0])), "area")
    return img, center_coord, center_coord_new, img_crop_size


def apply_sampling_pattern(n: int, pattern: str, keep_id=None) -> list[int]:
    """View subsampling patterns (reference dataio.py:73-124)."""
    if pattern == "all":
        return list(range(n))
    head, _, val = pattern.partition("_")
    if pattern == "filter":
        if keep_id is None:
            raise ValueError("'filter' pattern needs calib keep_id")
        return [int(i) for i in np.asarray(keep_id).ravel()]
    if head == "first":
        return list(range(min(int(val), n)))
    if head == "after":
        return list(range(int(val), n))
    if head == "skip":
        return list(range(0, n, int(val)))
    if head == "skipinv":
        return [i for i in range(n) if i % int(val) != 0]
    if head == "only":
        return [int(val)]
    raise ValueError(f"Unknown sampling pattern {pattern!r}")


def read_alpha_png(path: str) -> np.ndarray:
    """An alpha map PNG as float32 [H, W] in [0, 1]: cv2's first channel
    (blue: the file's third) of a colour file, else its gray."""
    alpha = read_png(path)
    if alpha.ndim == 3:
        alpha = alpha[..., 2 if alpha.shape[-1] >= 3 else 0]
    return alpha.astype(np.float32) / 255.0


class ViewDataset:
    """Calibrated multi-view dataset with optional precomputed G-buffers
    (reference dataio.py:11-260)."""

    PRECOMP_HIGH_KEYS = (
        "TBN_map", "uv_map", "normal_map", "view_dir_map",
        "view_dir_map_tangent", "sh_basis_map", "reflect_dir_map",
    )

    def __init__(self, root_dir: str, calib_path: str,
                 img_size: tuple[int, int], sampling_pattern: str = "all",
                 img_dir: str | None = None, load_img: bool = True,
                 ignore_dist_coeffs: bool = True,
                 load_precompute: bool = False,
                 precomp_high_dir: str | None = None,
                 precomp_low_dir: str | None = None,
                 img_gamma: float = 1.0):
        if not os.path.isdir(root_dir):
            raise ValueError(f"root dir {root_dir} does not exist")
        self.root_dir = root_dir
        self.img_size = list(img_size)
        self.load_img = load_img
        self.ignore_dist_coeffs = ignore_dist_coeffs
        self.load_precompute = load_precompute
        self.precomp_high_dir = precomp_high_dir
        self.precomp_low_dir = precomp_low_dir
        self.img_gamma = img_gamma
        self.img_dir = img_dir

        if not os.path.isfile(calib_path):
            raise ValueError(f"calib path {calib_path} does not exist")
        self.calib = scipy.io.loadmat(calib_path)
        self.global_RT = self.calib["global_RT"]
        self.global_RT_inv = np.linalg.inv(self.global_RT)
        num_view = self.calib["poses"].shape[0]

        if self.load_img:
            if img_dir is None or not os.path.isdir(img_dir):
                raise ValueError(f"image dir {img_dir} does not exist")
            self.img_fp_all = glob_imgs(img_dir)
        else:
            self.img_fp_all = ["%06d.png" % i for i in range(num_view)]

        keep = apply_sampling_pattern(
            len(self.img_fp_all), sampling_pattern,
            self.calib.get("keep_id", [[0]])[0]
            if "keep_id" in self.calib else None)
        self.keep_idx = keep
        self.img_fp_all = [self.img_fp_all[i] for i in keep]
        self.poses_all = [self.calib["poses"][i] for i in keep]
        for key in ("img_hws", "projs", "poses", "dist_coeffs"):
            self.calib[key] = self.calib[key][keep]

        self.img_idx2fn = [os.path.split(p)[-1] for p in self.img_fp_all]
        self.img_fn2idx = {fn: i for i, fn in enumerate(self.img_idx2fn)}
        self.views_all: list[dict] | None = None

    def __len__(self) -> int:
        return len(self.img_fp_all)

    def buffer_all(self) -> None:
        self.views_all = [self.read_view(i) for i in range(len(self))]

    def buffer_one(self) -> None:
        self.views_all = [self.read_view(0)]

    def read_view(self, idx: int) -> dict:
        img_fp = self.img_fp_all[idx]
        img_fn = os.path.split(img_fp)[-1]
        img_hw = self.calib["img_hws"][idx]

        if self.load_img:
            img_gt, cc, ccn, crop = load_img(img_fp, square_crop=True,
                                             target_size=self.img_size)
            img_gt = img_gt[:, :, :3] ** self.img_gamma
        else:
            min_dim = int(np.amin(img_hw))
            cc = img_hw // 2
            ccn = np.array([min_dim // 2, min_dim // 2])
            crop = np.array([min_dim, min_dim])
            img_gt = None

        pose = self.poses_all[idx] @ self.global_RT_inv
        proj = self.calib["projs"][idx].copy()
        dist = self.calib["dist_coeffs"][idx].copy()
        if self.ignore_dist_coeffs:
            dist[:] = 0.0

        proj_orig = proj.copy()
        offset = np.array([ccn[0] - cc[0], ccn[1] - cc[1]], np.float32)
        scale = np.array([self.img_size[0] / float(crop[0]),
                          self.img_size[1] / float(crop[1])], np.float32)
        # fold the crop and the resize into the intrinsics
        proj[0, -1] = (proj[0, -1] + offset[1]) * scale[1]
        proj[1, -1] = (proj[1, -1] + offset[0]) * scale[0]
        proj[0, 0] *= scale[1]
        proj[1, 1] *= scale[0]

        view = {
            "proj_orig": proj_orig.astype(np.float32),
            "proj": proj.astype(np.float32),
            "pose": pose.astype(np.float32),
            "dist_coeffs": dist.astype(np.float32),
            "offset": offset,
            "scale": scale,
            "view_dir": (-pose[2, :3]).astype(np.float32),
            "proj_inv": np.linalg.inv(proj).astype(np.float32),
            "R_inv": pose[:3, :3].T.astype(np.float32),
            "idx": idx,
            "img_fn": img_fn,
        }
        if img_gt is not None:
            view["img_gt"] = img_gt.astype(np.float32)
        if self.load_precompute:
            view.update(self._read_precompute(img_fn))
        return view

    def _read_precompute(self, img_fn: str) -> dict:
        stem = img_fn.split(".")[0]
        res = f"resol_{self.img_size[0]}"
        out: dict = {}
        raster = scipy.io.loadmat(
            os.path.join(self.precomp_low_dir, res, "raster", stem + ".mat"))
        for k in ("face_index_map", "weight_map", "faces_v_idx", "v_uvz"):
            out[k] = raster[k]
        out["v_front_mask"] = raster["v_front_mask"][0]
        for key in self.PRECOMP_HIGH_KEYS:
            m = scipy.io.loadmat(os.path.join(
                self.precomp_high_dir, res, key, stem + ".mat"))[key]
            if key == "uv_map":
                m = m - np.floor(m)
            out[key] = m.astype(np.float32)
        out["alpha_map"] = read_alpha_png(os.path.join(
            self.precomp_high_dir, res, "alpha_map", stem + ".png"))
        return out

    def __getitem__(self, idx: int) -> dict:
        if self.views_all is None:
            return self.read_view(idx)
        return self.views_all[idx]


def read_probe(fp: str, img_gamma: float = 1.0) -> np.ndarray:
    """A light probe as float32 RGB [H, W, 3]: `.exr` and `.hdr` as
    stored, every other format over 255; then the gamma."""
    img = read_image(fp, IMREAD_UNCHANGED)[:, :, :3]
    if not fp.endswith((".exr", ".hdr")):
        img = img.astype(np.float32) / 255.0
    return (np.asarray(img, np.float32) ** img_gamma).astype(np.float32)


class LightProbeDataset:
    """Equirect light-probe images (reference dataio.py:263-311)."""

    def __init__(self, data_dir: str, img_gamma: float = 1.0):
        if not os.path.isdir(data_dir):
            raise ValueError(f"data dir {data_dir} does not exist")
        self.data_dir = data_dir
        self.img_gamma = img_gamma
        self.lp_fp_all = glob_imgs(data_dir)
        self.lp_all: list[dict | None] = [None] * len(self.lp_fp_all)

    def buffer_one(self, idx: int) -> None:
        if self.lp_all[idx] is None:
            self.lp_all[idx] = {"lp_img": read_probe(self.lp_fp_all[idx],
                                                     self.img_gamma)}

    def buffer_all(self) -> None:
        for i in range(len(self.lp_fp_all)):
            self.buffer_one(i)

    def __len__(self) -> int:
        return len(self.lp_fp_all)

    def __getitem__(self, idx: int) -> dict:
        self.buffer_one(idx)
        return self.lp_all[idx]


def collate_views(views: list[dict], keys: list[str]) -> dict[str, np.ndarray]:
    """Stack per-view arrays into [N, ...] batches for the named keys."""
    return {k: np.stack([np.asarray(v[k]) for v in views]) for k in keys}


class BatchLoader:
    """Shuffling batch iterator over a buffered ViewDataset."""

    def __init__(self, dataset: ViewDataset, batch_size: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        end = len(order) - (len(order) % bs if self.drop_last else 0)
        for i in range(0, end, bs):
            yield [self.dataset[j] for j in order[i:i + bs]]

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
