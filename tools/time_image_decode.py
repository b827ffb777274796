"""Host decode times of the port's JPEG and OpenEXR readers
(rnr_tpu_torch.data.imageio), each decode checked bit-equal to cv2's.

JPEGs at quality 95, 4:2:0, baseline and progressive, at 512 x 512 and
2048 x 1536, of smooth ramps and sinusoids with Gaussian noise (sigma 8,
so that the entropy coding has photo-like work); a 512 x 256 float32
RGB OpenEXR, ZIP, written by the port's writer.  cv2 encodes the JPEGs
and decodes them for the check, so this runs where cv2 is installed.
Prints one JSON object: per file its bytes and the best and median of
`--repeats` decodes, in ms.

    python tools/time_image_decode.py [--repeats 3]
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from rnr_tpu_torch.data import imageio  # noqa: E402


def content(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([128 + 100 * np.sin(6 * xx + 3 * yy),
                    128 + 100 * np.cos(15 * yy * xx), 255 * xx * yy], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
        np.uint8)


def timed(fn, repeats: int) -> dict:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, {"best_ms": min(times), "median_ms": statistics.median(times)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for (h, w) in ((512, 512), (1536, 2048)):
            img = content(h, w)
            for mode in ("baseline", "progressive"):
                path = os.path.join(d, f"{w}x{h}_{mode}.jpg")
                cv2.imwrite(path, img, [
                    cv2.IMWRITE_JPEG_QUALITY, 95,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                    cv2.IMWRITE_JPEG_PROGRESSIVE, int(mode == "progressive")])
                got, t = timed(lambda: imageio.read_jpeg(path), args.repeats)
                want = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
                if not np.array_equal(got, want):
                    raise SystemExit(f"{path}: decode differs from cv2's")
                out[os.path.basename(path)] = dict(
                    bytes=os.path.getsize(path), **t)
        path = os.path.join(d, "512x256_zip.exr")
        hdr = content(256, 512).astype(np.float32) / 64.0
        imageio.write_exr(path, hdr)
        got, t = timed(lambda: imageio.read_exr(path), args.repeats)
        if not np.array_equal(got, hdr):
            raise SystemExit(f"{path}: not read back exactly")
        out["512x256_zip.exr"] = dict(bytes=os.path.getsize(path), **t)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
