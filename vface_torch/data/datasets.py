"""Host-side data loading: numpy batches from image directories (no DataLoader).

Port of ``vface_tpu/data/datasets.py`` (the reference's ``ldm/data/``), with
the same draws from the same ``np.random.default_rng(seed)`` in the same
order, so a seed gives the JAX package's batches:

* :class:`VideoFramesDataset`: precomputed cropped frames ``0.png .. N.png``
  (and parse maps) in windows, inpaint = image x (1 - face region);
* :class:`CelebATrainDataset`: self-supervised inpainting pairs from
  CelebAMask-HQ (``CelebA-HQ-img/{i}.jpg``, ``Overall_mask/{i}.png``): the GT,
  the preserve-list mask deformed by the TPS "decow"
  (:func:`vface_torch.preprocess.tps.tps_warp`, run on the CPU), the
  reference (the masked GT through flip / rotate / blur / elastic augs);
  ids [0, 28000) train, [28000, 30000) val;
* :class:`FFHQTrainDataset` (``images512/``, ``BiSeNet_mask/``, the 12-class
  preserve list), :func:`test_bench_pairs` and :func:`ff_test_pairs`.

Loaders are numpy + PIL; the face-region tables are
:func:`vface_torch.preprocess.masks.region_mask`'s.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch


def _load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """An RGB image -> float32 (H, W, 3) in [0, 1], resized bilinearly (PIL's) to (size, size)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        if size is not None:
            img = img.resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.float32) / 255.0


def _load_mask(path: str, size: Optional[int] = None) -> np.ndarray:
    """A parse-map PNG (class ids as pixel values) -> int32 (H, W), resized to
    (size, size) by nearest neighbour (PIL's, as the JAX package's loader)."""
    from PIL import Image

    with Image.open(path) as img:
        if size is not None:
            img = img.resize((size, size), Image.NEAREST)
        return np.asarray(img).astype(np.int32)


def _face_region(masks: np.ndarray, classes: Sequence[int], num_classes: int = 19) -> np.ndarray:
    """(B, H, W) class maps -> float32 (B, H, W), 1 on ``classes``."""
    from vface_torch.preprocess.masks import region_mask

    return region_mask(torch.from_numpy(masks), classes, num_classes=num_classes).numpy()


def normalize_img(x01: np.ndarray) -> np.ndarray:
    """[0, 1] -> [-1, 1] (the reference's Normalize(0.5, 0.5))."""
    return x01 * 2.0 - 1.0


def _box_blur(img01: np.ndarray, k: int) -> np.ndarray:
    """albumentations' Blur: a k x k box filter, edge-replicated, as separable
    cumulative sums, clipped to the input's range."""
    if k <= 1:
        return img01
    pad = k // 2
    x = np.pad(img01, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    c = np.cumsum(x, axis=0)
    x = (c[k:] - c[:-k]) / k
    x = np.concatenate([c[k - 1 : k] / k, x], axis=0)
    c = np.cumsum(x, axis=1)
    x = (c[:, k:] - c[:, :-k]) / k
    x = np.concatenate([c[:, k - 1 : k] / k, x], axis=1)
    return np.clip(x, img01.min(), img01.max()).astype(np.float32)


def _elastic_transform(img01: np.ndarray, rng: np.random.Generator, alpha: float = 1.0, sigma: float = 50.0,
                       alpha_affine: float = 50.0) -> np.ndarray:
    """albumentations' ElasticTransform at its defaults: an affine through three
    jittered control points (jitter ~ U(-alpha_affine, alpha_affine)) plus a
    smooth displacement field (coarse U(-1, 1) noise, cells of ~sigma pixels,
    upsampled bilinearly) scaled by alpha; a backward bilinear warp, edge-clamped."""
    h, w = img01.shape[:2]
    sq = min(h, w) // 3
    c = np.asarray([w // 2, h // 2], np.float32)
    pts1 = np.float32([c + (-sq, -sq), c + (sq, -sq), c + (-sq, sq)])
    pts2 = pts1 + rng.uniform(-alpha_affine, alpha_affine, pts1.shape).astype(np.float32)
    m = np.linalg.solve(np.concatenate([pts2, np.ones((3, 1), np.float32)], axis=1), pts1)  # output -> input
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    src_x = xs * m[0, 0] + ys * m[1, 0] + m[2, 0]
    src_y = xs * m[0, 1] + ys * m[1, 1] + m[2, 1]
    if alpha > 0:
        cell = max(2, int(sigma))
        gh, gw = h // cell + 2, w // cell + 2
        coarse = rng.uniform(-1, 1, (gh, gw, 2)).astype(np.float32)
        fy = np.linspace(0, gh - 1.001, h)
        fx = np.linspace(0, gw - 1.001, w)
        iy, ix = fy.astype(int), fx.astype(int)
        ry, rx = (fy - iy)[:, None, None], (fx - ix)[None, :, None]
        d = (coarse[iy][:, ix] * (1 - ry) * (1 - rx) + coarse[iy][:, ix + 1] * (1 - ry) * rx
             + coarse[iy + 1][:, ix] * ry * (1 - rx) + coarse[iy + 1][:, ix + 1] * ry * rx) * alpha
        src_x = src_x + d[..., 0]
        src_y = src_y + d[..., 1]
    src_x = np.clip(src_x, 0, w - 1)
    src_y = np.clip(src_y, 0, h - 1)
    x0 = np.floor(src_x).astype(int)
    y0 = np.floor(src_y).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = (src_x - x0)[..., None]
    wy = (src_y - y0)[..., None]
    out = (img01[y0, x0] * (1 - wy) * (1 - wx) + img01[y0, x1] * (1 - wy) * wx
           + img01[y1, x0] * wy * (1 - wx) + img01[y1, x1] * wy * wx)
    return out.astype(np.float32)


@dataclasses.dataclass
class VideoFramesDataset:
    """Sequential frames ``0.png .. N.png`` (+ parse maps) in batches of ``window`` frames."""

    frames_dir: str
    masks_dir: Optional[str] = None
    image_size: int = 512
    window: int = 6
    remove_classes: Sequence[int] = (1, 2, 4, 5, 8, 9, 6, 7, 10, 11, 12, 17)

    def __len__(self) -> int:
        return len([f for f in os.listdir(self.frames_dir) if f.endswith(".png")])

    def frame_path(self, i: int) -> str:
        return os.path.join(self.frames_dir, f"{i}.png")

    def __iter__(self) -> Iterator[dict]:
        n = len(self)
        for s0 in range(0, n, self.window):
            idx = list(range(s0, min(s0 + self.window, n)))
            imgs = np.stack([_load_image(self.frame_path(i), self.image_size) for i in idx])
            batch = {"image": normalize_img(imgs), "prior": normalize_img(imgs),
                     "frame_ids": np.asarray(idx, np.int32)}
            if self.masks_dir is not None:
                masks = np.stack([_load_mask(os.path.join(self.masks_dir, f"{i}.png"), self.image_size)
                                  for i in idx])
                keep = (1.0 - _face_region(masks, self.remove_classes))[..., None].astype(np.float32)
                batch["inpaint_mask"] = keep
                batch["inpaint_image"] = batch["image"] * keep
            yield batch


@dataclasses.dataclass
class CelebATrainDataset:
    """Self-supervised inpainting pairs from CelebAMask-HQ.

    ``dataset_dir`` holds ``CelebA-HQ-img/{i}.jpg`` and ``Overall_mask/{i}.png``.
    Items: ``gt_image`` and ``inpaint`` (B, S, S, 3) in [-1, 1], ``mask`` (S, S, 1)
    with 1 = keep, ``ref_image01`` (224, 224, 3) in [0, 1].
    """

    dataset_dir: str
    image_size: int = 512
    split: str = "train"  # train: ids [0, 28000); val: [28000, 30000)
    remove_classes: Sequence[int] = (1, 2, 4, 5, 8, 9, 6, 7, 10, 11, 12, 17)
    arbitrary_mask_percent: float = 0.5
    seed: int = 0

    num_classes = 19
    img_dir, img_name = "CelebA-HQ-img", "{}.jpg"
    mask_dir, mask_name = "Overall_mask", "{}.png"

    def _id_range(self):
        return (0, 28000) if self.split == "train" else (28000, 30000)

    def __post_init__(self):
        lo, hi = self._id_range()
        img_dir = os.path.join(self.dataset_dir, self.img_dir)
        self.ids: List[int] = []
        if os.path.isdir(img_dir):
            self.ids = [i for i in range(lo, hi) if os.path.exists(os.path.join(img_dir, self.img_name.format(i)))]
        self._rng = np.random.default_rng(self.seed)

    def __len__(self) -> int:
        return len(self.ids)

    def _augment_reference(self, ref01: np.ndarray) -> np.ndarray:
        """The reference's albumentations pipeline, same order, probabilities and
        ranges: Resize(224), HFlip(p .5), Rotate(limit 20, p .5), Blur(p .3,
        kernel 3..7), ElasticTransform(p .3, alpha 1, sigma 50, alpha_affine 50)."""
        from PIL import Image

        img = Image.fromarray((ref01 * 255).astype(np.uint8)).resize((224, 224), Image.BILINEAR)
        if self._rng.uniform() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self._rng.uniform() < 0.5:
            img = img.rotate(float(self._rng.uniform(-20, 20)), resample=Image.BILINEAR)
        out = np.asarray(img, dtype=np.float32) / 255.0
        if self._rng.uniform() < 0.3:
            out = _box_blur(out, int(self._rng.integers(3, 8) | 1))
        if self._rng.uniform() < 0.3:
            out = _elastic_transform(out, self._rng, alpha=1.0, sigma=50.0, alpha_affine=50.0)
        return out

    def __getitem__(self, k: int) -> dict:
        i = self.ids[k]
        img01 = _load_image(os.path.join(self.dataset_dir, self.img_dir, self.img_name.format(i)), self.image_size)
        mask = _load_mask(os.path.join(self.dataset_dir, self.mask_dir, self.mask_name.format(i)), self.image_size)
        face = _face_region(mask[None], self.remove_classes, self.num_classes)[0]
        # decow deforms every sample's mask; arbitrary_mask_percent governs the
        # reference's bbox masks, which this dataset does not make
        keep = self._decow((1.0 - face)[..., None].astype(np.float32))
        gt = normalize_img(img01)
        ref = self._augment_reference(img01 * (1.0 - keep[..., 0])[..., None])
        return {"gt_image": gt.astype(np.float32), "inpaint": (gt * keep).astype(np.float32), "mask": keep,
                "ref_image01": ref}

    def _decow_noise(self) -> np.ndarray:
        """The interior control point's displacement: (U - 0.5) * scale per
        coordinate, scale ~ U(0.5, 1.0) drawn per sample."""
        a = 3
        scale = self._rng.uniform(0.5, 1.0)
        return ((self._rng.uniform(size=(a - 2, a - 2, 2)) - 0.5) * scale).astype(np.float32)

    def _decow(self, keep: np.ndarray) -> np.ndarray:
        """The reference's "decow": a 3 x 3 TPS control grid over [-1, 1] whose
        interior point moves by :meth:`_decow_noise`; the mask is warped
        bilinearly and stays continuous."""
        from vface_torch.preprocess.tps import tps_warp

        a = 3
        xs = np.linspace(-1.0, 1.0, a, dtype=np.float32)
        gx, gy = np.meshgrid(xs, xs, indexing="ij")
        grid = np.stack([gx, gy], axis=-1)
        noise = np.zeros_like(grid)
        noise[1:-1, 1:-1] = self._decow_noise()
        src = torch.from_numpy(grid.reshape(1, -1, 2))
        dst = torch.from_numpy((grid + noise).reshape(1, -1, 2))
        # the sampling grid is the TPS fitted regular -> noisy at each output pixel
        return tps_warp(torch.from_numpy(keep[None]), dst, src)[0].numpy().astype(np.float32)

    def batches(self, batch_size: int, shuffle: bool = True) -> Iterator[dict]:
        order = np.arange(len(self))
        if shuffle:
            self._rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(k)] for k in order[s : s + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


@dataclasses.dataclass
class FFHQTrainDataset(CelebATrainDataset):
    """The FFHQ training pairs: ``images512/{i:05d}.png`` and
    ``BiSeNet_mask/{i:05d}.png`` (12-class maps, the FFHQ preserve list);
    ids [0, 68000) train, [68000, 70000) val."""

    remove_classes: Sequence[int] = tuple(c for c in range(12) if c not in (1, 2, 3, 5, 6, 7, 9) and c != 0)

    num_classes = 12
    img_dir, img_name = "images512", "{:05d}.png"
    mask_dir, mask_name = "BiSeNet_mask", "{:05d}.png"

    def _id_range(self):
        return (0, 68000) if self.split == "train" else (68000, 70000)


def test_bench_pairs(src_dir: str, tar_dir: str, mask_dir: Optional[str] = None,
                     image_size: int = 512) -> Iterator[dict]:
    """The image benchmark's fixed source / target pairs, by sorted file order."""
    for s, t in zip(sorted(os.listdir(src_dir)), sorted(os.listdir(tar_dir))):
        item = {"source": normalize_img(_load_image(os.path.join(src_dir, s), image_size)),
                "target": normalize_img(_load_image(os.path.join(tar_dir, t), image_size)),
                "name": os.path.splitext(t)[0]}
        if mask_dir is not None:
            item["mask"] = _load_mask(os.path.join(mask_dir, os.path.splitext(t)[0] + ".png"), image_size)
        yield item


def ff_test_pairs(dataset_dir: str, image_size: int = 512) -> Iterator[dict]:
    """The FaceForensics++ image test pairs: target ``Val_target/{i:04d}.png``
    (``target_mask/`` where present) with source ``Val/{500 + i:04d}.png``."""
    for i in range(500):
        tar = os.path.join(dataset_dir, "Val_target", f"{i:04d}.png")
        src = os.path.join(dataset_dir, "Val", f"{500 + i:04d}.png")
        if not (os.path.exists(tar) and os.path.exists(src)):
            continue
        item = {"source": normalize_img(_load_image(src, image_size)),
                "target": normalize_img(_load_image(tar, image_size)), "name": f"{i:04d}"}
        tm = os.path.join(dataset_dir, "target_mask", f"{i:04d}.png")
        if os.path.exists(tm):
            item["mask"] = _load_mask(tm, image_size)
        yield item


def write_synthetic_celeba(root: str, n: int, size: int = 512, seed: int = 0) -> List[int]:
    """Write a CelebAMask-HQ-layout directory of ``n`` seeded renders
    (:func:`vface_torch.preprocess.synthetic_faces.render_face`) under ``root``:
    ``CelebA-HQ-img/{i}.jpg`` (quality 95) and ``Overall_mask/{i}.png``, class
    maps drawn from each face's landmarks: ellipses of skin (1) over the
    brow-to-chin box, the eyes (4, 5), the nose (10) and the mouth (11), on
    background (0). For tests and smoke runs of the training path; returns the ids."""
    from PIL import Image

    from vface_torch.preprocess.synthetic_faces import landmark_face_box, render_face

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "CelebA-HQ-img"), exist_ok=True)
    os.makedirs(os.path.join(root, "Overall_mask"), exist_ok=True)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    for i in range(n):
        img01, lm = render_face(rng, size)
        cls = np.zeros((size, size), np.uint8)

        def ellipse(pts, label, grow=1.0):
            cx, cy = pts.mean(axis=0)
            rx = max(grow * (pts[:, 0].max() - pts[:, 0].min()) / 2, 1.0)
            ry = max(grow * (pts[:, 1].max() - pts[:, 1].min()) / 2, 1.0)
            cls[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0] = label

        cx, cy, w, h = landmark_face_box(lm)
        box = np.asarray([[cx - w / 2, cy - h / 2], [cx + w / 2, cy + h / 2]], np.float32)
        ellipse(box, 1)
        for label, sl, grow in ((4, slice(36, 42), 1.4), (5, slice(42, 48), 1.4), (10, slice(27, 36), 1.2),
                                (11, slice(48, 60), 1.2)):
            ellipse(lm[sl], label, grow)
        Image.fromarray((np.clip(img01, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, "CelebA-HQ-img", f"{i}.jpg"), quality=95)
        Image.fromarray(cls).save(os.path.join(root, "Overall_mask", f"{i}.png"))
    return list(range(n))
