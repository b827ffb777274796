"""Writes the image fixtures of this directory: small JPEGs and a BMP of
smooth synthetic content, each beside its cv2 decode as a PNG (RGB in
the file, as every PNG holds it).  `<stem>.png` is
cv2.imread(IMREAD_UNCHANGED); `<stem>.color.png`, where it differs,
cv2.imread's default IMREAD_COLOR (EXIF orientation applied, three
channels).  The files are committed; this script is how they were made
(cv2 with libjpeg-turbo, and PIL for the EXIF tag):

    python tests/data/images/make_fixtures.py
"""

import io
import os

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 75, 107          # partial MCUs in both directions at every sampling


def content(h: int = H, w: int = W) -> np.ndarray:
    """A smooth BGR image with some detail: sinusoids and a soft disc."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    disc = np.exp(-((yy - 0.35) ** 2 + (xx - 0.6) ** 2) * 30)
    img = np.stack([128 + 90 * np.sin(9 * xx + 4 * yy),
                    128 + 80 * np.cos(7 * yy - 3 * xx * yy) * (1 - disc),
                    60 + 180 * disc], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def jpeg(name: str, img: np.ndarray, **kw) -> bytes:
    flags = [cv2.IMWRITE_JPEG_QUALITY, kw.get("quality", 90)]
    if "sampling" in kw:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kw["sampling"]]]
    if kw.get("progressive"):
        flags += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if kw.get("restart"):
        flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, kw["restart"]]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok, name
    return buf.tobytes()


def exif6(img: np.ndarray) -> bytes:
    """A 4:2:0 JPEG whose EXIF orientation is 6 (rotate 90 clockwise)."""
    exif = Image.Exif()
    exif[0x0112] = 6
    out = io.BytesIO()
    Image.fromarray(img[..., ::-1]).save(out, "JPEG", quality=90,
                                         exif=exif.tobytes())
    return out.getvalue()


def write_decodes(path: str) -> None:
    stem = os.path.splitext(path)[0]
    unchanged = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    color = cv2.imread(path, cv2.IMREAD_COLOR)
    cv2.imwrite(stem + ".png", unchanged)
    if not np.array_equal(unchanged, color):
        cv2.imwrite(stem + ".color.png", color)


def main() -> None:
    img = content()
    files = {f"sampling_{s}.jpg": jpeg(s, img, sampling=s) for s in SAMPLING}
    files["progressive_420.jpg"] = jpeg("p", img, sampling="420",
                                        progressive=True)
    files["restart_422.jpg"] = jpeg("r", img, sampling="422", restart=3,
                                    quality=60)
    files["gray.jpg"] = jpeg("g", cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    files["exif6.jpg"] = exif6(img)
    for name, data in files.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    cv2.imwrite(os.path.join(HERE, "rgb24.bmp"), img)
    for name in [*files, "rgb24.bmp"]:
        write_decodes(os.path.join(HERE, name))


if __name__ == "__main__":
    main()
