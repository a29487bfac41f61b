"""PNG output and OpenCV's two colour maps, without OpenCV.

The JAX trainer writes its validation and test panos with
`cv2.imwrite(path, img)` and `cv2.applyColorMap(img, 1 or 9)`
(lidarnerf_tpu/nerf/trainer.py:669-679, 746-762). `imwrite` and
`apply_color_map` here keep OpenCV's conventions, so the same call writes a
file with the same pixels: a colour-mapped image is [H, W, 3] uint8 in BGR
order, and `imwrite` stores a 3-channel array as an RGB PNG by reversing
the channels, as OpenCV does. The PNG is written with zlib (filter 0 on
every row); its bytes differ from OpenCV's, its pixels do not.

The tables are OpenCV's COLORMAP_BONE (id 1) and COLORMAP_HSV (id 9),
generated once from `cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], id)`
(OpenCV 5.0.0) and written here as hex: 256 BGR entries of 3 bytes.
"""

import struct
import zlib

import numpy as np

COLORMAP_BONE = 1
COLORMAP_HSV = 9

_BGR_HEX = {
    COLORMAP_BONE: (
    "0000000101010202020403030504040604040705050806060a07070b08080c09090d0a0a0e0a0a100b0b110c0c120d0d"
    "130e0e150f0f1610101711111812121912121b13131c14141d15151e16161f1717211818221818231919241a1a251b1b"
    "271c1c281d1d291e1e2a1f1f2b20202d20202e21212f2222302323322424332525342626352626362727382828392929"
    "3a2a2a3b2b2b3c2c2c3e2d2d3f2e2e402e2e412f2f4230304431314532324633334734344834344a35354b36364c3737"
    "4d38384f3939503a3a513b3b523c3c533c3c553d3d563e3e573f3f5840405941415b42425c42425d43435e44445f4545"
    "614646624747634848644949664949674a4a684b4b694c4c6a4d4d6c4e4e6d4f4f6e50506f5050705151715252735353"
    "745454755555765756765857775957785a58795b597a5d5a7b5e5b7c5f5c7d605d7e615e7e635e7f645f806560816661"
    "826762836963846a64846b65856c66866e66876f678870688971698a726a8b746b8c756c8c766c8d776d8e786e8f7a6f"
    "907b70917c71927d72927e739380749481749582759683769784779886789987799a887a9a897a9b8a7b9c8c7c9d8d7d"
    "9e8e7e9f8f7fa09180a09281a19382a29482a39583a49784a59885a69986a79a87a89b88a89d88a99e89aa9f8aaba08b"
    "aca18cada38daea48eaea58fafa690b0a890b1a991b2aa92b3ab93b4ac94b5ae95b6af96b6b096b7b197b8b298b9b499"
    "bab59abbb69bbcb79cbcb89dbdba9ebebb9ebfbc9fc0bda0c1bea1c2c0a2c3c1a3c4c2a4c4c3a4c5c4a5c6c6a6c7c7a7"
    "c8c8a9c9c9aacacaabcbcbaccbcbaeccccafcdcdb1ceceb2cfcfb3d0d0b5d1d1b6d2d2b8d2d2b9d3d3bad4d4bcd5d5bd"
    "d6d6bed7d7c0d8d8c1d8d8c3d9d9c4dadac5dbdbc7dcdcc8ddddc9dedecbdfdfcce0e0cee0e0cfe1e1d0e2e2d2e3e3d3"
    "e4e4d4e5e5d6e6e6d7e7e7d8e7e7dae8e8dbe9e9ddeaeadeebebdfecece1edede2eeeee4eeeee5efefe6f0f0e8f1f1e9"
    "f2f2eaf3f3ecf4f4edf4f4eff5f5f0f6f6f1f7f7f3f8f8f4f9f9f5fafaf7fbfbf8fcfcfafcfcfbfdfdfcfefefeffffff"
    ),
    COLORMAP_HSV: (
    "0000ff0006ff000cff0012ff0018ff001eff0024ff002aff0030ff0036ff003cff0042ff0048ff004eff0054ff005aff"
    "0060ff0066ff006cff0072ff0078ff007eff0084ff008aff0090ff0096ff009cff00a2ff00a8ff00aeff00b4ff00baff"
    "00c0ff00c6ff00ccff00d2ff00d8ff00deff00e4ff00eaff00f0ff00f4fd00f7fa00faf700fdf400fff000ffea00ffe4"
    "00ffde00ffd800ffd200ffcc00ffc600ffc000ffba00ffb400ffae00ffa800ffa200ff9c00ff9600ff9000ff8a00ff84"
    "00ff7e00ff7800ff7200ff6c00ff6600ff6000ff5a00ff5400ff4e00ff4800ff4200ff3c00ff3600ff3000ff2a00ff24"
    "00ff1e00ff1800ff1200ff0c00ff0600ff0006ff000cff0012ff0018ff001eff0024ff002aff0030ff0036ff003cff00"
    "42ff0048ff004eff0054ff005aff0060ff0066ff006cff0072ff0078ff007eff0084ff008aff0090ff0096ff009cff00"
    "a2ff00a8ff00aeff00b4ff00baff00c0ff00c6ff00ccff00d2ff00d8ff00deff00e4ff00eaff00f0ff00f4fd00f7fa00"
    "faf700fdf400fff000ffea00ffe400ffde00ffd800ffd200ffcc00ffc600ffc000ffba00ffb400ffae00ffa800ffa200"
    "ff9c00ff9600ff9000ff8a00ff8400ff7e00ff7800ff7200ff6c00ff6600ff6000ff5a00ff5400ff4e00ff4800ff4200"
    "ff3c00ff3600ff3000ff2a00ff2400ff1e00ff1800ff1200ff0c00ff0600ff0000ff0006ff000cff0012ff0018ff001e"
    "ff0024ff002aff0030ff0036ff003cff0042ff0048ff004eff0054ff005aff0060ff0066ff006cff0072ff0078ff007e"
    "ff0084ff008aff0090ff0096ff009cff00a2ff00a8ff00aeff00b4ff00baff00c0ff00c6ff00ccff00d2ff00d8ff00de"
    "ff00e4ff00eaff00f0fd00f4fa00f7f700faf400fdf000ffea00ffe400ffde00ffd800ffd200ffcc00ffc600ffc000ff"
    "ba00ffb400ffae00ffa800ffa200ff9c00ff9600ff9000ff8a00ff8400ff7e00ff7800ff7200ff6c00ff6600ff6000ff"
    "5a00ff5400ff4e00ff4800ff4200ff3c00ff3600ff3000ff2a00ff2400ff1e00ff1800ff1200ff0c00ff0600ff0000ff"
    ),
}
COLORMAPS = {
    cid: np.frombuffer(bytes.fromhex(h), dtype=np.uint8).reshape(256, 3)
    for cid, h in _BGR_HEX.items()
}


def apply_color_map(img, colormap):
    """[H, W] uint8 -> [H, W, 3] uint8 BGR, as `cv2.applyColorMap(img, colormap)`."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"apply_color_map takes a 2-D uint8 image, got {img.dtype} "
                         f"{list(img.shape)}")
    if colormap not in COLORMAPS:
        raise ValueError(f"colour map {colormap}: only {sorted(COLORMAPS)} are included")
    return COLORMAPS[colormap][img]


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def imwrite(path, img):
    """Write a uint8 image as an 8-bit PNG, as `cv2.imwrite` does.

    img: [H, W] (grey) or [H, W, 3] in BGR order (stored as RGB).
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"imwrite takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        img = img[..., ::-1]  # BGR -> RGB
    else:
        raise ValueError(f"imwrite takes [H, W] or [H, W, 3] images, got {list(img.shape)}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return True
