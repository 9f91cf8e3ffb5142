"""The port's data layer against the JAX package's, on the CPU: every video
transform, each dataset of ``get_dataset`` item by item, ``read_video``,
``quantize_video_u8`` and the loader's uint8 transport, all equal to the
bit. Both sides resize with the same OpenCV and draw from ``random.Random``
in the same order, so no tolerance is needed; one would hide a wrong
interpolation flag or rounding. Inputs come from numpy seeds; files go to
tmp_path.
"""

import os
import random

import cv2
import numpy as np
import pytest

from latte_tpu.config import Config
from latte_tpu.data import datasets as jds
from latte_tpu.data import loader as jloader
from latte_tpu.data import video_transforms as jvt
from latte_tpu.utils import read_video as jax_read_video
from latte_tpu.utils import save_video
from latte_tpu_torch.data import datasets as tds
from latte_tpu_torch.data import loader as tloader
from latte_tpu_torch.data import video_transforms as tvt
from latte_tpu_torch.utils import read_video


def _video(shape=(6, 20, 28, 3), seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# (name, function of (module, video)): each transform on a uint8 clip, or on
# the float32 [0, 255] clip a resize leaves
TRANSFORMS = {
    "to_tensor_video": lambda m, v: m.to_tensor_video(v),
    "to_tensor_video_float": lambda m, v: m.to_tensor_video(v.astype(np.float32) * 0.7),
    "normalize_video": lambda m, v: m.normalize_video(m.to_tensor_video(v)),
    "normalize_video_mean_std": lambda m, v: m.normalize_video(m.to_tensor_video(v), 0.45, 0.225),
    "resize_up": lambda m, v: m.resize(v, (37, 41)),
    "resize_down": lambda m, v: m.resize(v, (9, 13)),
    "resize_scale_wide": lambda m, v: m.resize_scale(v, 16),
    "resize_scale_tall": lambda m, v: m.resize_scale(v.transpose(0, 2, 1, 3), 16),
    "center_crop": lambda m, v: m.center_crop(v, (11, 14)),
    "center_crop_odd": lambda m, v: m.center_crop(v, (7, 9)),
    "ucf_center_crop": lambda m, v: m.ucf_center_crop(v, 16),
    "center_crop_resize": lambda m, v: m.center_crop_resize(v, 12),
    "compose": lambda m, v: m.Compose([lambda x: m.center_crop(x, (16, 16)), m.to_tensor_video,
                                       m.normalize_video])(v),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    v = _video()
    _equal(TRANSFORMS[name](tvt, v), TRANSFORMS[name](jvt, v))


@pytest.mark.parametrize("short", [100, 347, 389, 394, 255])
def test_resize_scale_floor_cases_match_jax(short):
    """The longer side floored, the shorter one pinned to the target (the
    sizes where a plain floor lands on target - 1), as in JAX."""
    v = np.zeros((1, short, short + 57 if short != 100 else 301, 3), np.uint8)
    target = 64 if short == 100 else 256
    got, want = tvt.resize_scale(v, target), jvt.resize_scale(v, target)
    assert got.shape == want.shape and got.shape[1] == target
    _equal(tvt.ucf_center_crop(v, target), jvt.ucf_center_crop(v, target))


@pytest.mark.parametrize("dataset", ["ffs", "ucf101_img", "taichi", "sky"])
def test_reference_transform_matches_jax_with_a_seeded_rng(dataset):
    """Each dataset's stack on eight clips from one seeded rng a side: the
    same flips, scales and crops, to the bit."""
    t_fn = tvt.make_reference_transform(dataset, 16)
    j_fn = jvt.make_reference_transform(dataset, 16)
    t_rng, j_rng = random.Random(5), random.Random(5)
    for i in range(8):
        v = _video(seed=i)
        _equal(t_fn(v, t_rng), j_fn(v, j_rng))
    assert t_rng.random() == j_rng.random()  # as many draws on both sides


def test_random_flip_and_temporal_crop_draw_as_jax():
    v = _video()
    t_rng, j_rng = random.Random(1), random.Random(1)
    outcomes = []
    for _ in range(10):
        got, want = tvt.random_horizontal_flip(v, rng=t_rng), jvt.random_horizontal_flip(v, rng=j_rng)
        _equal(got, want)
        outcomes.append(got is v)
    assert len(set(outcomes)) == 2  # both outcomes were drawn
    _equal(tvt.random_horizontal_flip(v, p=1.0), jvt.random_horizontal_flip(v, p=1.0))
    for total, size in ((64, 48), (48, 48), (20, 48), (100, 16)):
        t_crop, j_crop = tvt.TemporalRandomCrop(size), jvt.TemporalRandomCrop(size)
        for _ in range(5):
            assert t_crop(total, t_rng) == j_crop(total, j_rng)


def test_unknown_transform_stack_raises():
    with pytest.raises(NotImplementedError):
        tvt.make_reference_transform("kinetics", 16)


def test_read_video_matches_jax(tmp_path):
    path = str(tmp_path / "v.mp4")
    save_video(path, _video((5, 24, 32, 3), seed=3))
    got = read_video(path)
    assert got.shape == (5, 24, 32, 3)
    _equal(got, jax_read_video(path))
    _equal(read_video(path, max_frames=2), jax_read_video(path, max_frames=2))
    (tmp_path / "bad.mp4").write_bytes(b"not a video")
    with pytest.raises(IOError, match="no frames decoded"):
        read_video(str(tmp_path / "bad.mp4"))


def _smooth_video(frames, h, w, seed):
    """Frames that mp4 compression keeps apart: low-resolution noise blown up."""
    small = np.random.default_rng(seed).integers(0, 256, size=(frames, h // 4, w // 4, 3), dtype=np.uint8)
    return np.ascontiguousarray(small.repeat(4, axis=1).repeat(4, axis=2))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """An ffs folder of mp4s, a ucf101 tree (class from the directory), a
    frame-folder tree (sky/taichi) and a frame list for the ``_img`` sets."""
    root = tmp_path_factory.mktemp("data")
    for i in range(3):
        save_video(str(root / "ffs" / f"{i:03d}.mp4"), _smooth_video(14, 24, 40, i))
    for c, name in enumerate(("jump", "run")):
        for i in range(2):
            save_video(str(root / "ucf" / name / f"{name}_{i}.mp4"), _smooth_video(12, 32, 28, 10 + 2 * c + i))
    for c in range(3):
        clip = _smooth_video(9 + 2 * c, 28, 36, 20 + c)
        os.makedirs(root / "frames" / f"clip{c}")
        for f in range(len(clip)):
            cv2.imwrite(str(root / "frames" / f"clip{c}" / f"img_{f}.png"), clip[f][:, :, ::-1])
    os.makedirs(root / "stills")
    lines = []
    for i in range(4):
        cv2.imwrite(str(root / "stills" / f"s{i}.png"), _smooth_video(1, 24, 32, 30 + i)[0])
        lines.append(f"stills/s{i}.png {i % 2}")
    (root / "train_list.txt").write_text("\n".join(lines) + "\n")
    return root


DATASETS = {
    # name: (folder, extra config)
    "ffs": ("ffs", {}),
    "ucf101": ("ucf", {}),
    "sky": ("frames", {}),
    "taichi": ("frames", {}),
    "ucf101_img": ("ucf", {"use_image_num": 2}),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_get_dataset_matches_jax_item_by_item(data_root, name):
    """``__getitem__`` over every index, twice (the second pass draws new
    crops and flips), against the JAX dataset from the same config."""
    folder, extra = DATASETS[name]
    cfg = Config({"dataset": name, "data_path": str(data_root / folder), "num_frames": 4,
                  "frame_interval": 2, "image_size": 16,
                  "frame_data_txt": str(data_root / "train_list.txt"), **extra})
    got_ds, want_ds = tds.get_dataset(cfg), jds.get_dataset(cfg)
    assert type(got_ds).__name__ == type(want_ds).__name__ and len(got_ds) == len(want_ds) > 1
    for _ in range(2):
        for i in range(len(want_ds)):
            got, want = got_ds[i], want_ds[i]
            frames = 4 + int(extra.get("use_image_num", 0))
            size = (28, 36) if name == "taichi" else (16, 16)  # taichi: a flip, no crop
            assert want["video"].shape == (frames, 3, *size)
            _equal(got, want)
    if name == "ucf101":
        assert got_ds.classes == ["jump", "run"] and got["y"].dtype == np.int32


def test_unknown_dataset_and_empty_folders_raise_as_jax(tmp_path):
    cfg = Config({"dataset": "kinetics", "data_path": str(tmp_path)})
    for mod in (tds, jds):
        with pytest.raises(NotImplementedError, match="kinetics"):
            mod.get_dataset(cfg)
    (tmp_path / "empty").mkdir()
    for name, match in (("ffs", "no videos under"), ("sky", "no frame folders under")):
        cfg = Config({"dataset": name, "data_path": str(tmp_path / "empty")})
        for mod in (tds, jds):
            with pytest.raises(FileNotFoundError, match=match):
                mod.get_dataset(cfg)


def test_apply_transform_arity_matches_jax():
    """One-argument transforms get the clip alone; a TypeError raised inside
    a two-argument one propagates."""
    v = _video()
    one = lambda x: x[:, :2]  # noqa: E731
    _equal(tds._apply_transform(one, v, random.Random(0)), jds._apply_transform(one, v, random.Random(0)))

    def bad(x, rng):
        raise TypeError("inside")

    for mod in (tds, jds):
        with pytest.raises(TypeError, match="inside"):
            mod._apply_transform(bad, v, random.Random(0))


def test_quantize_video_u8_matches_jax():
    rng = np.random.default_rng(7)
    x = np.concatenate([
        rng.uniform(-1.2, 1.2, 10_000).astype(np.float32),
        (np.arange(256, dtype=np.float32) / 127.5 - 1.0),
        np.array([-1, 1, 0, -0.5 / 127.5, 0.5 / 127.5], np.float32),
    ])
    got = tloader.quantize_video_u8(x)
    assert got.dtype == np.uint8
    _equal(got, jloader.quantize_video_u8(x))
    # the pixel of a crop-only stack comes back as it was
    v = _video()
    _equal(tloader.quantize_video_u8(tvt.normalize_video(tvt.to_tensor_video(v))), v.transpose(0, 3, 1, 2))


def test_loader_ships_lossless_uint8_on_a_crop_only_stack(data_root):
    """A window of all the frames (begin is always 0) and a center crop: each
    clip the loader's workers ship as uint8 is the source pixels of one of
    the videos."""
    crop = lambda v: tvt.normalize_video(tvt.to_tensor_video(tvt.center_crop(v, (16, 16))))  # noqa: E731
    ds = tds.VideoFolderDataset(str(data_root / "ffs"), num_frames=14, frame_interval=1, transform=crop)
    want = [read_video(p)[:, 4:20, 12:28].transpose(0, 3, 1, 2) for p in ds.videos]
    batches = iter(tloader.DataLoader(ds, batch_size=3, num_workers=2, seed=0, pixel_uint8=True))
    for _ in range(2):
        batch = next(batches)
        assert set(batch) == {"video"} and batch["video"].dtype == np.uint8
        assert batch["video"].shape == (3, 14, 3, 16, 16)
        for clip in batch["video"]:
            assert any(np.array_equal(clip, w) for w in want)
    batches.close()


def test_loader_with_uint8_transport_matches_jax(data_root):
    """One worker, one seed: the port's loader ships the JAX loader's uint8
    batches (the same shuffle, the same items in the same order)."""
    cfg = Config({"dataset": "ffs", "data_path": str(data_root / "ffs"), "num_frames": 4,
                  "frame_interval": 2, "image_size": 16})
    got = iter(tloader.DataLoader(tds.get_dataset(cfg), 2, num_workers=1, seed=4, pixel_uint8=True))
    want = iter(jloader.DataLoader(jds.get_dataset(cfg), 2, num_workers=1, seed=4, pixel_uint8=True))
    for _ in range(3):  # crosses an epoch (3 videos, batches of 2)
        _equal(next(got), next(want))
    got.close()
    want.close()
