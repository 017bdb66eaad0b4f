"""Host-side image transforms (Pillow + numpy), the port's copy of the JAX
package's ``data/transforms.py`` (timm's ``create_transform`` stack of the
reference's ``data/build.py:80-126``):

train: RandomResizedCrop(bicubic) -> HFlip -> RandAugment(rand-m9-mstd0.5-inc1)
       or ColorJitter -> normalize -> RandomErasing
eval:  resize(crop ratio 0.875) -> center crop -> normalize

Every random decision is drawn from the ``random.Random`` the caller passes,
in the JAX module's order, so both packages draw the same augmentation for
the same key. Pillow is imported inside the functions that use it: the
native decode path (``native_jpeg``) crops, resamples and runs RandAugment
without it, and importing this module never needs it.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _pil_filter(name: str):
    """Pillow's resampling filter for ``name`` (bicubic unless bilinear)."""
    from PIL import Image

    return Image.BILINEAR if name == "bilinear" else Image.BICUBIC


def sample_rrc_geometry(
    w: int,
    h: int,
    rng: random.Random,
    scale=(0.08, 1.0),
    ratio=(3 / 4, 4 / 3),
    interpolation: str = "bicubic",
) -> Tuple[Tuple[int, int, int, int], str]:
    """RandomResizedCrop box sampling, shared by the Pillow and native paths.

    Returns ``((x, y, cw, ch), interp_name)`` drawing from ``rng`` in
    exactly the same order regardless of which decode path consumes it.
    """
    area = w * h
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw)
            y = rng.randint(0, h - ch)
            interp = (
                rng.choice(["bilinear", "bicubic"])
                if interpolation == "random" else interpolation
            )
            return (x, y, cw, ch), interp
    # fallback: center crop
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x, y = (w - cw) // 2, (h - ch) // 2
    interp = (
        rng.choice(["bilinear", "bicubic"])
        if interpolation == "random" else interpolation
    )
    return (x, y, cw, ch), interp


def random_resized_crop(
    img,
    size: int,
    rng: random.Random,
    scale=(0.08, 1.0),
    ratio=(3 / 4, 4 / 3),
    interpolation: str = "bicubic",
):
    w, h = img.size
    (x, y, cw, ch), interp = sample_rrc_geometry(
        w, h, rng, scale, ratio, interpolation
    )
    return img.resize((size, size), _pil_filter(interp),
                      box=(x, y, x + cw, y + ch))


def center_crop_resize(img, size: int, crop: bool = True,
                       interpolation: str = "bicubic"):
    """Eval transform: resize shorter side to size/0.875 then center crop
    (timm's default test pipeline); ``crop=False`` resizes directly
    (TEST.CROP=False, e.g. 384 fine-tune eval)."""
    interp = _pil_filter(interpolation)
    if not crop:
        return img.resize((size, size), interp)
    scale_size = int(math.floor(size / 0.875))
    w, h = img.size
    if w <= h:
        nw, nh = scale_size, int(round(scale_size * h / w))
    else:
        nw, nh = int(round(scale_size * w / h)), scale_size
    img = img.resize((nw, nh), interp)
    x = (nw - size) // 2
    y = (nh - size) // 2
    return img.crop((x, y, x + size, y + size))


# ---------------------------------------------------------------------------
# RandAugment (rand-m9-mstd0.5-inc1)
# ---------------------------------------------------------------------------

_MAX_LEVEL = 10.0


def _randomly_negate(v: float, rng: random.Random) -> float:
    return -v if rng.random() > 0.5 else v


def _enhance_factor(level: float) -> float:
    # inc1 mapping: factor drifts away from 1.0 as magnitude grows
    return 1.0 + (level / _MAX_LEVEL) * 0.9


# The 15 ops, in the order the JAX module lists them (``rng.choice`` over
# this sequence draws the same op as over its list of op functions); the
# ids are shared with the native (C++) executor.
RA_OP_IDS = {
    "auto_contrast": 0, "equalize": 1, "invert": 2, "rotate": 3,
    "posterize_inc": 4, "solarize_inc": 5, "solarize_add": 6, "color": 7,
    "contrast": 8, "brightness": 9, "sharpness": 10, "shear_x": 11,
    "shear_y": 12, "translate_x": 13, "translate_y": 14,
}
_RA_OPS = tuple(RA_OP_IDS)


class RandAugment:
    """``rand-mN-mstdS-inc1``: apply ``num_layers`` random ops at magnitude
    ``N`` jittered by N(0, S).

    ``plan`` pre-draws every random decision (op choice, magnitude jitter,
    sign) so the Pillow and native executors consume the rng identically.
    """

    def __init__(self, magnitude: int = 9, mstd: float = 0.5,
                 num_layers: int = 2):
        self.magnitude = magnitude
        self.mstd = mstd
        self.num_layers = num_layers

    def plan(self, rng: random.Random, img_size: Tuple[int, int]):
        """[(op_name, signed_param)] with rng draws in the op order."""
        w, h = img_size
        ops = []
        for _ in range(self.num_layers):
            name = rng.choice(_RA_OPS)
            level = self.magnitude
            if self.mstd > 0:
                level = rng.gauss(level, self.mstd)
            level = min(_MAX_LEVEL, max(0.0, level))
            frac = level / _MAX_LEVEL
            if name == "rotate":
                param = _randomly_negate(frac * 30.0, rng)
            elif name == "posterize_inc":
                param = max(1, 4 - int(frac * 4))
            elif name == "solarize_inc":
                param = max(0, 256 - int(frac * 256))
            elif name == "solarize_add":
                param = int(frac * 110)
            elif name in ("color", "contrast", "brightness", "sharpness"):
                param = 1.0 + _randomly_negate(
                    _enhance_factor(level) - 1.0, rng)
            elif name in ("shear_x", "shear_y"):
                param = _randomly_negate(frac * 0.3, rng)
            elif name == "translate_x":
                param = _randomly_negate(frac * 0.45, rng) * w
            elif name == "translate_y":
                param = _randomly_negate(frac * 0.45, rng) * h
            else:  # auto_contrast / equalize / invert
                param = 0.0
            ops.append((name, param))
        return ops

    @staticmethod
    def apply_plan_pil(img, ops):
        """Execute a pre-drawn plan with Pillow (fallback executor)."""
        from PIL import Image, ImageEnhance, ImageOps

        affine = {"shear_x": lambda p: (1, p, 0, 0, 1, 0),
                  "shear_y": lambda p: (1, 0, 0, p, 1, 0),
                  "translate_x": lambda p: (1, 0, p, 0, 1, 0),
                  "translate_y": lambda p: (1, 0, 0, 0, 1, p)}
        enhance = {"color": ImageEnhance.Color,
                   "contrast": ImageEnhance.Contrast,
                   "brightness": ImageEnhance.Brightness,
                   "sharpness": ImageEnhance.Sharpness}
        for name, p in ops:
            if name == "auto_contrast":
                img = ImageOps.autocontrast(img)
            elif name == "equalize":
                img = ImageOps.equalize(img)
            elif name == "invert":
                img = ImageOps.invert(img)
            elif name == "rotate":
                img = img.rotate(p, Image.BILINEAR)
            elif name == "posterize_inc":
                img = ImageOps.posterize(img, int(p))
            elif name == "solarize_inc":
                img = ImageOps.solarize(img, int(p))
            elif name == "solarize_add":
                arr = np.asarray(img).astype(np.int32)
                arr = np.where(arr < 128, np.clip(arr + int(p), 0, 255), arr)
                img = Image.fromarray(arr.astype(np.uint8))
            elif name in enhance:
                img = enhance[name](img).enhance(p)
            elif name in affine:
                img = img.transform(img.size, Image.AFFINE, affine[name](p),
                                    Image.BILINEAR)
        return img

    def __call__(self, img, rng: random.Random):
        return self.apply_plan_pil(img, self.plan(rng, img.size))


def parse_rand_augment(spec: str) -> Optional[RandAugment]:
    """Parse timm-style policy strings like ``rand-m9-mstd0.5-inc1``."""
    if not spec or not spec.startswith("rand"):
        return None
    magnitude, mstd, layers = 9, 0.0, 2
    for part in spec.split("-")[1:]:
        if part.startswith("mstd"):
            mstd = float(part[4:])
        elif part.startswith("m"):
            magnitude = int(part[1:])
        elif part.startswith("n"):
            layers = int(part[1:])
        # 'inc1' selects the increasing mappings, which we always use
    return RandAugment(magnitude=magnitude, mstd=mstd, num_layers=layers)


def color_jitter(img, strength: float, rng: random.Random):
    from PIL import ImageEnhance

    for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                ImageEnhance.Color):
        f = 1.0 + rng.uniform(-strength, strength)
        img = enh(img).enhance(max(0.0, f))
    return img


def random_erasing(
    arr: np.ndarray,
    rng: random.Random,
    prob: float = 0.25,
    mode: str = "pixel",
    count: int = 1,
    scale=(0.02, 1 / 3),
    ratio=(0.3, 3.3),
) -> np.ndarray:
    """timm RandomErasing on the normalized float array (h, w, c)."""
    if rng.random() > prob:
        return arr
    h, w, c = arr.shape
    for _ in range(count):
        for _ in range(10):
            area = rng.uniform(*scale) * h * w
            aspect = math.exp(rng.uniform(math.log(ratio[0]),
                                          math.log(ratio[1])))
            eh = int(round(math.sqrt(area * aspect)))
            ew = int(round(math.sqrt(area / aspect)))
            if eh < h and ew < w:
                y = rng.randint(0, h - eh)
                x = rng.randint(0, w - ew)
                if mode == "pixel":
                    patch = np.random.default_rng(
                        rng.getrandbits(32)).standard_normal((eh, ew, c))
                else:
                    patch = 0.0
                arr[y: y + eh, x: x + ew] = patch
                break
    return arr


def normalize(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def _normalize_uint8(arr: np.ndarray) -> np.ndarray:
    return (arr.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


class TrainTransform:
    def __init__(self, config):
        self.size = config.DATA.IMG_SIZE
        self.interpolation = config.DATA.INTERPOLATION
        self.rand_augment = parse_rand_augment(config.AUG.AUTO_AUGMENT)
        self.color_jitter = (
            config.AUG.COLOR_JITTER if not self.rand_augment else 0.0
        )
        self.reprob = config.AUG.REPROB
        self.remode = config.AUG.REMODE
        self.recount = config.AUG.RECOUNT

    def native_geometry(self, w: int, h: int, rng: random.Random):
        """(box, interp, flip, fast_scale) for the native decode path;
        draws from ``rng`` in the same order as the Pillow ``__call__``."""
        box, interp = sample_rrc_geometry(
            w, h, rng, interpolation=self.interpolation
        )
        flip = rng.random() < 0.5
        return box, interp, flip, True

    def finish_uint8(self, arr: np.ndarray, rng: random.Random) -> np.ndarray:
        """Augment + normalize an already-cropped (size, size, 3) uint8
        image (tail of the pipeline after a native decode). RandAugment runs
        natively when the library is there, else through Pillow on the same
        plan, so the rng stream is the same either way."""
        if self.rand_augment is not None:
            plan = self.rand_augment.plan(rng, (arr.shape[1], arr.shape[0]))
            from . import native_jpeg

            arr = np.ascontiguousarray(arr)
            if native_jpeg.randaugment_inplace(
                arr, [RA_OP_IDS[n] for n, _ in plan], [p for _, p in plan]
            ):
                out = _normalize_uint8(arr)
            else:
                from PIL import Image

                out = normalize(RandAugment.apply_plan_pil(
                    Image.fromarray(arr), plan))
        elif self.color_jitter > 0:
            from PIL import Image

            out = normalize(color_jitter(Image.fromarray(arr),
                                         self.color_jitter, rng))
        else:
            out = _normalize_uint8(arr)
        if self.reprob > 0:
            out = random_erasing(
                out, rng, prob=self.reprob, mode=self.remode,
                count=self.recount
            )
        return out

    def __call__(self, img, rng: random.Random) -> np.ndarray:
        from PIL import Image

        img = img.convert("RGB")
        w, h = img.size
        (x, y, cw, ch), interp, flip, _ = self.native_geometry(w, h, rng)
        img = img.resize((self.size, self.size), _pil_filter(interp),
                         box=(x, y, x + cw, y + ch))
        if flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.rand_augment is not None:
            img = self.rand_augment(img, rng)
        elif self.color_jitter > 0:
            img = color_jitter(img, self.color_jitter, rng)
        arr = normalize(img)
        if self.reprob > 0:
            arr = random_erasing(
                arr, rng, prob=self.reprob, mode=self.remode,
                count=self.recount
            )
        return arr


class EvalTransform:
    def __init__(self, config):
        self.size = config.DATA.IMG_SIZE
        self.crop = config.TEST.CROP
        self.interpolation = config.DATA.INTERPOLATION

    def native_geometry(self, w: int, h: int, rng=None):
        """Deterministic source-coordinate box equal to resize+center-crop.

        Resizing the whole image to (nw, nh) and center-cropping equals
        resampling the source box mapped back through the uniform scale
        (identical tap centers), so the native path needs no intermediate
        image. fast_scale=False: eval decodes at full resolution.
        """
        size = self.size
        if not self.crop:
            return ((0.0, 0.0, float(w), float(h)), self.interpolation,
                    False, False)
        scale_size = int(math.floor(size / 0.875))
        if w <= h:
            nw, nh = scale_size, int(round(scale_size * h / w))
        else:
            nw, nh = int(round(scale_size * w / h)), scale_size
        x = (nw - size) // 2
        y = (nh - size) // 2
        box = (x * w / nw, y * h / nh, size * w / nw, size * h / nh)
        return box, self.interpolation, False, False

    def __call__(self, img, rng=None) -> np.ndarray:
        img = center_crop_resize(
            img.convert("RGB"), self.size, self.crop, self.interpolation
        )
        return normalize(img)

    def finish_uint8(self, arr: np.ndarray, rng=None) -> np.ndarray:
        return _normalize_uint8(arr)
